"""Nonbonded pair forces over the cluster-pair list: the hand-written CUDA
kernel K1 (csrc/pair_nonbonded.cu), its plain PyTorch twin, and the torch
glue around them (counterpart of mollytpu/ops/pallas_pairwise.py:
FusedSpec, build_fused_spec, _pair_terms, pallas_block_nonbonded and
_far_pair_corrections).

``pair_nonbonded`` dispatches on the device of its inputs: CPU tensors go to
``pair_nonbonded_plain``, CUDA tensors to the kernel, which counts its
launches in ``LAUNCHES`` and, per compiled instance family, in
``INSTANCE_LAUNCHES``. There is no fallback between the two.

Every mode of the TPU kernel without alchemical lambda is ported: LJ with
no / distance / shifted-potential / shifted-force cutoff (lj_mode 4 / 1 /
2 / 3, or 0 for none) plus plain, reaction-field or Ewald real-space
Coulomb (coul_mode 1 / 2 / 3, or 0 for none), 1-4 weights, orthorhombic and
triclinic boxes. The soft-core path (K1c) raises.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import math

import torch

from . import native
from ..boundary import mic
from .blockpairs import CLUSTER
from .cutoffs import (DistanceCutoff, NoCutoff, ShiftedForceCutoff,
                      ShiftedPotentialCutoff)
from .mixing import GeometricMixing, LorentzMixing
from .pairwise import (Coulomb, CoulombEwald, CoulombReactionField,
                       LennardJones, rf_constants)

#: kernel launches since the count was last reset (main-path accounting)
LAUNCHES = 0
#: the same launches per compiled instance family (``instance_family``)
INSTANCE_LAUNCHES = collections.Counter()


def reset_launch_counts():
    global LAUNCHES
    LAUNCHES = 0
    INSTANCE_LAUNCHES.clear()


class _Launch(ctypes.Structure):
    """The launcher's spec, field for field csrc/pair_nonbonded.cu's
    LaunchSpec (4-byte fields only, so no padding on either side)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "n_pairs", "n_atoms", "lj_mode", "coul_mode", "triclinic",
        "compute_energy")] + [("mic", ctypes.c_float * 9)] + [
        (name, ctypes.c_float) for name in (
            "cut2", "lj_rc2", "coul_rc2", "lj_rc", "inv_lj_rc",
            "inv_lj_rc2", "lj_w", "coul_w", "ke", "alpha", "krf", "crf")]


_SIG = {"pair_nonbonded_launch": [ctypes.c_void_p] * 9}


@dataclasses.dataclass(frozen=True)
class FusedSpec:
    """Static description of the fused pair interaction (the non-alchemical
    fields of mollytpu/ops/pallas_pairwise.py:50-70)."""

    lj_mode: int = 0      # 0 none, 1 distance, 2 shifted potential,
                          # 3 shifted force, 4 no cutoff
    lj_rc: float = 0.0
    lj_w: float = 1.0     # LJ weight of 1-4 pairs
    coul_mode: int = 0    # 0 none, 1 plain, 2 reaction field, 3 Ewald real
    coul_rc: float = 0.0  # 0 for plain Coulomb without a cutoff
    ke: float = 0.0
    krf: float = 0.0
    crf: float = 0.0
    alpha: float = 0.0
    coul_w: float = 1.0   # Coulomb weight of 1-4 pairs
    cut_max: float = 1.0  # every pair beyond it is skipped

    @property
    def lj_masked(self):
        """LJ needs its own r < lj_rc test inside cut_max."""
        return self.lj_mode in (1, 2, 3) and self.lj_rc < self.cut_max

    @property
    def coul_masked(self):
        """Coulomb needs its own r < coul_rc test inside cut_max."""
        return bool(self.coul_mode) and 0.0 < self.coul_rc < self.cut_max


_LJ_MODES = {NoCutoff: 4, DistanceCutoff: 1, ShiftedPotentialCutoff: 2,
             ShiftedForceCutoff: 3}


def build_fused_spec(inters):
    """Map pairwise interactions onto a FusedSpec, as build_fused_spec of
    the JAX package does for them. What the port's kernel does not cover
    raises NotImplementedError naming it."""
    spec = dict(lj_mode=0, lj_rc=0.0, lj_w=1.0, coul_mode=0, coul_rc=0.0,
                ke=0.0, krf=0.0, crf=0.0, alpha=0.0, coul_w=1.0)
    cut_max = 0.0
    for inter in inters:
        name = type(inter).__name__
        if isinstance(inter, LennardJones):
            if spec["lj_mode"]:
                raise NotImplementedError("two Lennard-Jones interactions")
            if not (isinstance(inter.sigma_mixing, LorentzMixing)
                    and isinstance(inter.epsilon_mixing, GeometricMixing)):
                raise NotImplementedError(
                    "only Lorentz-Berthelot mixing is ported (NBFix is not)")
            mode = _LJ_MODES.get(type(inter.cutoff))
            if mode is None:
                raise NotImplementedError(
                    f"LJ cutoff {type(inter.cutoff).__name__} is not a mode "
                    "of the pair kernel")
            rc = 0.0 if mode == 4 else float(inter.cutoff.dist_cutoff)
            spec.update(lj_mode=mode, lj_rc=rc,
                        lj_w=float(inter.weight_special))
            cut_max = max(cut_max, rc)
            continue
        if spec["coul_mode"] and isinstance(
                inter, (Coulomb, CoulombReactionField, CoulombEwald)):
            raise NotImplementedError("two Coulomb interactions")
        if isinstance(inter, Coulomb):
            if not isinstance(inter.cutoff, (NoCutoff, DistanceCutoff)):
                raise NotImplementedError(
                    f"Coulomb with {type(inter.cutoff).__name__}")
            rc = (float(inter.cutoff.dist_cutoff)
                  if isinstance(inter.cutoff, DistanceCutoff) else 0.0)
            spec.update(coul_mode=1, coul_rc=rc,
                        ke=float(inter.coulomb_const),
                        coul_w=float(inter.weight_special))
        elif isinstance(inter, CoulombReactionField):
            rc = float(inter.dist_cutoff)
            krf, crf = rf_constants(rc, float(inter.solvent_dielectric))
            spec.update(coul_mode=2, coul_rc=rc,
                        ke=float(inter.coulomb_const), krf=krf, crf=crf,
                        coul_w=float(inter.weight_special))
        elif isinstance(inter, CoulombEwald):
            rc = float(inter.dist_cutoff)
            spec.update(coul_mode=3, coul_rc=rc,
                        ke=float(inter.coulomb_const),
                        alpha=float(inter.alpha),
                        coul_w=float(inter.weight_special))
        else:
            what = ("the soft-core / scaled-charge path is kernel mode K1c, "
                    "not ported" if "SoftCore" in name or "Scaled" in name
                    else "not a mode of the pair kernel")
            raise NotImplementedError(f"pairwise interaction {name}: {what}")
        cut_max = max(cut_max, spec["coul_rc"])
    if not spec["lj_mode"] and not spec["coul_mode"]:
        raise NotImplementedError("no interaction for the pair kernel")
    if cut_max == 0.0:
        raise NotImplementedError(
            "no finite cutoff: the dense all-pairs path "
            "(nonbonded_method='none') is not ported")
    return FusedSpec(cut_max=cut_max, **spec)


def instance_family(spec, boundary):
    """The kernel instance family a launch runs: its Coulomb template and
    box template (the energy template is the caller's choice)."""
    box = "triclinic" if getattr(boundary, "basis", None) is not None \
        else "ortho"
    return f"coul{spec.coul_mode}-{box}"


def _pair_terms(spec, r2, sig, eps, qq, special):
    """(energy, coef = (dU/dr)/r) for r2 > 0 inside cut_max, following
    mollytpu/ops/pallas_pairwise.py:462-555 term by term (Ewald with the
    exact erfc): per-term lj_rc / coul_rc masks inside cut_max, LJ times
    lj_w for 1-4 pairs, and plain Coulomb times coul_w for 1-4 pairs under
    the reaction field and Ewald."""
    inv_r = 1.0 / torch.sqrt(r2)
    inv_r2 = inv_r * inv_r
    r = r2 * inv_r
    zero = torch.zeros_like(r2)
    e, coef = zero, zero
    if spec.lj_mode:
        s2 = sig * sig * inv_r2
        six = s2 * s2 * s2
        twelve = six * six
        e_lj = 4.0 * eps * (twelve - six)
        c_lj = -24.0 * eps * (2.0 * twelve - six) * inv_r2
        if spec.lj_mode in (2, 3):
            rc = spec.lj_rc
            s2c = sig * sig / (rc * rc)
            sixc = s2c * s2c * s2c
            twelvec = sixc * sixc
            e_lj = e_lj - 4.0 * eps * (twelvec - sixc)
            if spec.lj_mode == 3:
                dudr_rc = -24.0 * eps * (2.0 * twelvec - sixc) / rc
                e_lj = e_lj - (r - rc) * dudr_rc
                c_lj = c_lj - dudr_rc * inv_r
        # hydrogens carry eps = 0: select (not multiply) so 0 * inf never
        # reaches the sum
        on = eps != 0
        if spec.lj_masked:
            on = on & (r2 < spec.lj_rc * spec.lj_rc)
        wl = torch.where(special, torch.full_like(r2, spec.lj_w),
                         torch.ones_like(r2))
        e = torch.where(on, e_lj * wl, zero)
        coef = torch.where(on, c_lj * wl, zero)
    if spec.coul_mode:
        keqq = spec.ke * qq
        e_plain = keqq * inv_r
        c_plain = -keqq * inv_r2 * inv_r
        if spec.coul_mode == 1:
            wc = torch.where(special, torch.full_like(r2, spec.coul_w),
                             torch.ones_like(r2))
            e_c, c_c = e_plain * wc, c_plain * wc
        else:
            if spec.coul_mode == 2:
                e_f = keqq * (inv_r + spec.krf * r2 - spec.crf)
                c_f = keqq * (-inv_r2 * inv_r + 2.0 * spec.krf)
            else:
                ar = spec.alpha * r
                erfc_ar = torch.special.erfc(ar)
                e_f = keqq * erfc_ar * inv_r
                c_f = -keqq * inv_r2 * (erfc_ar * inv_r + 2.0 * spec.alpha
                                        / math.sqrt(math.pi)
                                        * torch.exp(-ar * ar))
            e_c = torch.where(special, e_plain * spec.coul_w, e_f)
            c_c = torch.where(special, c_plain * spec.coul_w, c_f)
        if spec.coul_masked:
            inside = r2 < spec.coul_rc * spec.coul_rc
            e_c = torch.where(inside, e_c, zero)
            c_c = torch.where(inside, c_c, zero)
        e, coef = e + e_c, coef + c_c
    return e, coef


def _tile_geometry(spec, row, xi, xj, idi, idj, bi, n_atoms):
    """Per-slot geometry of a batch of 32 x 32 tiles: xi (T, 32, 3), idi
    (T, 32), bi (T, 32, 4); returns dx = xj - xi under the kernel's
    back-substitution minimum image (T, 32, 32, 3), r2, and the live and
    1-4 masks (T, 32, 32)."""
    d = xj[:, None, :, :] - xi[:, :, None, :]
    dx = torch.stack(mic(row, d[..., 0], d[..., 1], d[..., 2]), dim=-1)
    r2 = (dx * dx).sum(dim=-1)
    id_i = idi[:, :, None]
    id_j = idj[:, None, :]
    # exclusion bits live in atom-id space: offset d = id_j - id_i + 32
    off = id_j - id_i + 32
    in_win = (off >= 0) & (off < 64)
    sh = off & 31
    lo = off < 32
    ew = torch.where(lo, bi[:, :, 0:1], bi[:, :, 1:2])
    sw = torch.where(lo, bi[:, :, 2:3], bi[:, :, 3:4])
    excl = in_win & (((ew >> sh) & 1) != 0)
    special = in_win & (((sw >> sh) & 1) != 0)
    live = ((id_i != id_j) & (id_i < n_atoms) & (id_j < n_atoms)
            & (r2 < spec.cut_max ** 2) & ~excl)
    return dx, r2, live, special


def _tiles(blockpairs, boundary, chunk):
    """Per-cluster views of the packed rows, the box row as a tensor and
    the cluster pairs in chunks of ``chunk``."""
    pos4 = blockpairs.pos4
    dtype, dev = pos4.dtype, pos4.device
    row = torch.tensor(boundary.mic_row(), dtype=dtype, device=dev)
    x = pos4[:, :3].view(-1, CLUSTER, 3)
    par = torch.cat([blockpairs.lj2, pos4[:, 3:4]], dim=1).view(
        -1, CLUSTER, 3)
    idc = blockpairs.ids.to(torch.int64).view(-1, CLUSTER)
    bitc = blockpairs.bits.view(-1, CLUSTER, 4)
    pairs = blockpairs.pairs.to(torch.int64)
    chunks = [pairs[s:s + chunk].unbind(dim=1)
              for s in range(0, pairs.shape[0], chunk)]
    return row, x, par, idc, bitc, chunks


def pair_nonbonded_plain(spec, blockpairs, boundary, n_atoms,
                         compute_energy=False, chunk=1024):
    """Plain PyTorch twin of the kernel: every listed 32 x 32 tile at once
    (in chunks of ``chunk`` tiles to bound memory). Same inputs and outputs
    as the kernel: (forces (N, 3) in atom order, energy, virial (3, 3))."""
    row, x, par, idc, bitc, chunks = _tiles(blockpairs, boundary, chunk)
    dtype, dev = x.dtype, x.device
    forces = torch.zeros((n_atoms + 1, 3), dtype=dtype, device=dev)
    energy = torch.zeros((), dtype=dtype, device=dev)
    virial = torch.zeros((3, 3), dtype=dtype, device=dev)
    for I, J in chunks:
        dx, r2, live, special = _tile_geometry(
            spec, row, x[I], x[J], idc[I], idc[J], bitc[I], n_atoms)
        pi, pj = par[I], par[J]
        e, coef = _pair_terms(
            spec, torch.where(live, r2, torch.ones_like(r2)),
            0.5 * (pi[:, :, None, 0] + pj[:, None, :, 0]),
            pi[:, :, None, 1] * pj[:, None, :, 1],
            pi[:, :, None, 2] * pj[:, None, :, 2], special)
        zero = torch.zeros_like(r2)
        coef, e = torch.where(live, coef, zero), torch.where(live, e, zero)
        cross = (I != J).to(dtype)[:, None, None]
        f_i = (coef[..., None] * dx).sum(dim=2)               # (T, 32, 3)
        f_j = -(coef[..., None] * dx * cross[..., None]).sum(dim=1)
        # in place: one (N + 1, 3) accumulator, row N takes the padding
        forces.index_add_(0, idc[I].reshape(-1), f_i.reshape(-1, 3))
        forces.index_add_(0, idc[J].reshape(-1), f_j.reshape(-1, 3))
        if compute_energy:
            # self tiles carry both orderings of each pair: weight 0.5
            w = torch.where(I == J, 0.5, 1.0).to(dtype)[:, None, None]
            energy = energy + (e * w).sum()
            cw = coef * w
            virial = virial - torch.einsum("tij,tija,tijb->ab", cw, dx, dx)
    return forces[:n_atoms], energy, virial


def live_pair_count(spec, blockpairs, boundary, n_atoms, chunk=1024):
    """Atom pairs the listed tiles evaluate inside cut_max, each unordered
    pair once: the work the kernel's inputs need (for its bound)."""
    row, x, _, idc, bitc, chunks = _tiles(blockpairs, boundary, chunk)
    total = 0.0
    for I, J in chunks:
        live = _tile_geometry(spec, row, x[I], x[J], idc[I], idc[J],
                              bitc[I], n_atoms)[2]
        w = torch.where(I == J, 0.5, 1.0).to(torch.float64)
        total += float((live.sum(dim=(1, 2)).to(torch.float64) * w).sum())
    return total


def _check_cuda_input(name, t, dtype, width):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous() or t.shape[-1] != width:
        raise ValueError(f"{name} must be contiguous with last dim {width}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def _launch_spec(spec, blockpairs, boundary, n_atoms, compute_energy):
    inf = float("inf")
    lj_rc = spec.lj_rc if spec.lj_mode in (2, 3) else 1.0
    return _Launch(
        n_pairs=int(blockpairs.pairs.shape[0]), n_atoms=int(n_atoms),
        lj_mode=spec.lj_mode, coul_mode=spec.coul_mode,
        triclinic=int(getattr(boundary, "basis", None) is not None),
        compute_energy=int(bool(compute_energy)),
        mic=(ctypes.c_float * 9)(*blockpairs.box_host),
        cut2=spec.cut_max ** 2,
        lj_rc2=spec.lj_rc ** 2 if spec.lj_masked else inf,
        coul_rc2=spec.coul_rc ** 2 if spec.coul_masked else inf,
        lj_rc=lj_rc, inv_lj_rc=1.0 / lj_rc, inv_lj_rc2=1.0 / lj_rc ** 2,
        lj_w=spec.lj_w, coul_w=spec.coul_w, ke=spec.ke, alpha=spec.alpha,
        krf=spec.krf, crf=spec.crf)


def _pair_nonbonded_cuda(spec, blockpairs, boundary, n_atoms,
                         compute_energy=False):
    """Launch csrc/pair_nonbonded.cu on the current stream (f32 only)."""
    global LAUNCHES
    pos4, lj2, ids, bits, pairs = (blockpairs.pos4, blockpairs.lj2,
                                   blockpairs.ids, blockpairs.bits,
                                   blockpairs.pairs)
    _check_cuda_input("pos4", pos4, torch.float32, 4)
    _check_cuda_input("lj2", lj2, torch.float32, 2)
    _check_cuda_input("ids", ids.view(-1, 1), torch.int32, 1)
    _check_cuda_input("bits", bits, torch.int32, 4)
    if pairs.numel():
        _check_cuda_input("pairs", pairs, torch.int32, 2)
    dev = pos4.device
    launch = _launch_spec(spec, blockpairs, boundary, n_atoms, compute_energy)
    forces = torch.zeros((n_atoms, 3), dtype=torch.float32, device=dev)
    ev = torch.zeros((7,), dtype=torch.float64, device=dev)
    lib = native.load("pair_nonbonded", _SIG)
    err = lib.pair_nonbonded_launch(
        pos4.data_ptr(), lj2.data_ptr(), ids.data_ptr(), bits.data_ptr(),
        pairs.data_ptr(), ctypes.addressof(launch), forces.data_ptr(),
        ev.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pair_nonbonded kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    INSTANCE_LAUNCHES[instance_family(spec, boundary)] += 1
    energy = ev[0].to(torch.float32)
    v = ev[1:].to(torch.float32)
    virial = torch.stack([v[0], v[1], v[2], v[1], v[3], v[4], v[2], v[4],
                          v[5]]).view(3, 3)
    return forces, energy, virial


def pair_nonbonded(spec, blockpairs, boundary, n_atoms, compute_energy=False):
    """(forces (N, 3), energy, virial (3, 3)) of every listed pair inside
    cut_max. CPU tensors run the plain twin; CUDA tensors launch the kernel
    (f32 only) or raise."""
    if blockpairs.pos4.is_cuda:
        return _pair_nonbonded_cuda(spec, blockpairs, boundary, n_atoms,
                                    compute_energy)
    if blockpairs.pos4.device.type != "cpu":
        raise ValueError(f"unsupported device {blockpairs.pos4.device}")
    return pair_nonbonded_plain(spec, blockpairs, boundary, n_atoms,
                                compute_energy)


def far_pair_corrections(spec, coords, boundary, atoms, exclusions, forces,
                         energy, virial):
    """Fix the kernel's treatment of exclusion / 1-4 pairs whose id span
    exceeds the bitmap window (|j - i| > 31): the kernel computed them at
    full strength, so excluded pairs are subtracted and 1-4 pairs get
    (scaled - full) added."""
    far_e, far_s = exclusions.far_excl, exclusions.far_spec
    if far_e.shape[0] == 0 and far_s.shape[0] == 0:
        return forces, energy, virial
    dtype = coords.dtype
    par = torch.stack([atoms.sigma, torch.sqrt(atoms.epsilon), atoms.charge],
                      dim=1).to(dtype)

    def apply(pairs, special, forces, energy, virial):
        if pairs.shape[0] == 0:
            return forces, energy, virial
        i, j = pairs[:, 0].long(), pairs[:, 1].long()
        dx = boundary.displacement(coords[i], coords[j])        # x_j - x_i
        r2 = (dx * dx).sum(dim=1)
        inside = r2 < spec.cut_max ** 2
        r2s = torch.where(inside, r2, torch.ones_like(r2))
        args = (r2s, 0.5 * (par[i, 0] + par[j, 0]), par[i, 1] * par[j, 1],
                par[i, 2] * par[j, 2])
        e_full, c_full = _pair_terms(spec, *args, torch.zeros_like(inside))
        if special:
            e_sp, c_sp = _pair_terms(spec, *args, torch.ones_like(inside))
            de, dc = e_sp - e_full, c_sp - c_full
        else:
            de, dc = -e_full, -c_full
        zero = torch.zeros_like(r2s)
        de, dc = torch.where(inside, de, zero), torch.where(inside, dc, zero)
        fvec = (dc[:, None] * dx).to(forces.dtype)
        forces = forces.index_add(0, i, fvec).index_add(0, j, -fvec)
        energy = energy + de.sum().to(energy.dtype)
        virial = virial - torch.einsum("k,ka,kb->ab", dc, dx, dx).to(
            virial.dtype)
        return forces, energy, virial

    forces, energy, virial = apply(far_e, False, forces, energy, virial)
    return apply(far_s, True, forces, energy, virial)


def block_nonbonded(spec, coords, boundary, atoms, exclusions, blockpairs,
                    compute_energy=False):
    """Main-path entry (counterpart of pallas_block_nonbonded): gather this
    step's coordinates into the sorted slots, run the pair kernel (or its
    twin on CPU) and apply the far-pair corrections."""
    # in place: the rebuild-time row buffer takes this step's coordinates,
    # so the only per-step data movement is this one gather
    blockpairs.pos4[:, :3] = coords[blockpairs.src]
    forces, energy, virial = pair_nonbonded(spec, blockpairs, boundary,
                                            coords.shape[0], compute_energy)
    forces = forces.to(coords.dtype)
    energy, virial = energy.to(coords.dtype), virial.to(coords.dtype)
    return far_pair_corrections(spec, coords, boundary, atoms, exclusions,
                                forces, energy, virial)
