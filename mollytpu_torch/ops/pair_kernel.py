"""Nonbonded pair forces over the cluster-pair list: the hand-written CUDA
kernel K1a (csrc/pair_nonbonded.cu), its plain PyTorch twin, and the torch
glue around them (counterpart of mollytpu/ops/pallas_pairwise.py:
build_fused_spec, pallas_block_nonbonded and _far_pair_corrections).

``pair_nonbonded`` dispatches on the device of its inputs: CPU tensors go to
``pair_nonbonded_plain``, CUDA tensors to the kernel, which counts its
launches in ``LAUNCHES``. There is no fallback between the two.

Only the production mode of the TPU kernel is ported: Lennard-Jones with a
distance cutoff (lj_mode=1) plus Ewald real-space Coulomb (coul_mode=3),
1-4 weights, orthorhombic boxes, no alchemical lambda.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from . import native
from .blockpairs import CLUSTER
from .cutoffs import DistanceCutoff
from .mixing import GeometricMixing, LorentzMixing
from .pairwise import CoulombEwald, LennardJones

#: kernel launches since the count was last reset (main-path accounting)
LAUNCHES = 0

_SIG = {"pair_nonbonded_launch": (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_float] * 11
    + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])}


@dataclasses.dataclass(frozen=True)
class PairSpec:
    """Static description of the fused LJ + Ewald real-space interaction."""

    cutoff: float       # interaction cutoff (nm), both terms
    lj_w: float         # LJ weight of 1-4 pairs
    coul_w: float       # Coulomb weight of 1-4 pairs
    ke: float           # Coulomb constant
    alpha: float        # Ewald splitting parameter (1/nm)


def build_pair_spec(inters):
    """Map (LennardJones, CoulombEwald) onto a PairSpec. Other interaction
    sets belong to kernel modes that are not ported yet and raise."""
    lj = [i for i in inters if isinstance(i, LennardJones)]
    ew = [i for i in inters if isinstance(i, CoulombEwald)]
    if len(lj) != 1 or len(ew) != 1 or len(inters) != 2:
        raise NotImplementedError(
            "the port's pair kernel covers LennardJones + CoulombEwald only; "
            f"got {[type(i).__name__ for i in inters]}")
    lj, ew = lj[0], ew[0]
    if not isinstance(lj.cutoff, DistanceCutoff):
        raise NotImplementedError(
            "shifted / switched / no-cutoff LJ is kernel mode K1b, not ported")
    if not (isinstance(lj.sigma_mixing, LorentzMixing)
            and isinstance(lj.epsilon_mixing, GeometricMixing)):
        raise NotImplementedError("only Lorentz-Berthelot mixing is ported")
    if float(lj.cutoff.dist_cutoff) != float(ew.dist_cutoff):
        raise NotImplementedError("LJ and Ewald cutoffs must be equal")
    return PairSpec(cutoff=float(ew.dist_cutoff),
                    lj_w=float(lj.weight_special),
                    coul_w=float(ew.weight_special),
                    ke=float(ew.coulomb_const), alpha=float(ew.alpha))


def _box_terms(boundary, dtype, device):
    """(sides, inverse sides) with 0 for open axes, so x - L round(x / L)
    leaves open axes untouched."""
    box = boundary.side_lengths.to(device=device, dtype=dtype)
    periodic = torch.isfinite(box)
    sides = torch.where(periodic, box, torch.zeros_like(box))
    inv = torch.where(periodic, 1.0 / torch.where(periodic, box,
                                                  torch.ones_like(box)),
                      torch.zeros_like(box))
    return sides, inv


def _pair_terms(spec, r2, sig, eps, qq, special):
    """(energy, coef = (dU/dr)/r) of LJ + Ewald real space for r2 > 0, with
    the 1-4 rules: LJ times lj_w, plain Coulomb times coul_w."""
    inv_r = 1.0 / torch.sqrt(r2)
    inv_r2 = inv_r * inv_r
    r = r2 * inv_r
    s2 = sig * sig * inv_r2
    six = s2 * s2 * s2
    twelve = six * six
    has_lj = eps != 0
    zero = torch.zeros_like(r2)
    wl = torch.where(special, torch.full_like(r2, spec.lj_w),
                     torch.ones_like(r2))
    # hydrogens carry eps = 0: select (not multiply) so 0 * inf never
    # reaches the sum
    e = torch.where(has_lj, 4.0 * eps * (twelve - six) * wl, zero)
    coef = torch.where(has_lj,
                       -24.0 * eps * (2.0 * twelve - six) * inv_r2 * wl, zero)
    keqq = spec.ke * qq
    ar = spec.alpha * r
    erfc_ar = torch.special.erfc(ar)
    e_ew = keqq * erfc_ar * inv_r
    c_ew = -keqq * inv_r2 * (erfc_ar * inv_r + 2.0 * spec.alpha
                             / math.sqrt(math.pi) * torch.exp(-ar * ar))
    e_14 = keqq * inv_r * spec.coul_w
    c_14 = -keqq * inv_r2 * inv_r * spec.coul_w
    return (e + torch.where(special, e_14, e_ew),
            coef + torch.where(special, c_14, c_ew))


def _tile_terms(spec, xi, xj, pi, pj, idi, idj, bi, sides, inv, n_atoms):
    """Per-slot (coef, energy, dx) of a batch of 32 x 32 tiles: xi (T, 32,
    3), pi (T, 32, 3) [sigma, sqrt(eps), q], idi (T, 32), bi (T, 32, 4);
    returns (T, 32, 32) coef and energy and (T, 32, 32, 3) dx = xj - xi."""
    dx = xj[:, None, :, :] - xi[:, :, None, :]
    dx = dx - sides * torch.round(dx * inv)
    r2 = (dx * dx).sum(dim=-1)
    id_i = idi[:, :, None]
    id_j = idj[:, None, :]
    # exclusion bits live in atom-id space: offset d = id_j - id_i + 32
    d = id_j - id_i + 32
    in_win = (d >= 0) & (d < 64)
    sh = d & 31
    lo = d < 32
    ew = torch.where(lo, bi[:, :, 0:1], bi[:, :, 1:2])
    sw = torch.where(lo, bi[:, :, 2:3], bi[:, :, 3:4])
    excl = in_win & (((ew >> sh) & 1) != 0)
    special = in_win & (((sw >> sh) & 1) != 0)
    live = ((id_i != id_j) & (id_i < n_atoms) & (id_j < n_atoms)
            & (r2 < spec.cutoff ** 2) & ~excl)
    r2s = torch.where(live, r2, torch.ones_like(r2))
    e, coef = _pair_terms(spec, r2s, 0.5 * (pi[:, :, None, 0]
                                            + pj[:, None, :, 0]),
                          pi[:, :, None, 1] * pj[:, None, :, 1],
                          pi[:, :, None, 2] * pj[:, None, :, 2], special)
    zero = torch.zeros_like(r2s)
    return torch.where(live, coef, zero), torch.where(live, e, zero), dx


def pair_nonbonded_plain(spec, blockpairs, boundary, n_atoms,
                         compute_energy=False, chunk=1024):
    """Plain PyTorch twin of the kernel: every listed 32 x 32 tile at once
    (in chunks of ``chunk`` tiles to bound memory). Same inputs and outputs
    as the kernel: (forces (N, 3) in atom order, energy, virial (3, 3))."""
    pos4, lj2, ids, bits = (blockpairs.pos4, blockpairs.lj2, blockpairs.ids,
                            blockpairs.bits)
    dtype, dev = pos4.dtype, pos4.device
    sides, inv = _box_terms(boundary, dtype, dev)
    x = pos4[:, :3].view(-1, CLUSTER, 3)
    par = torch.cat([lj2, pos4[:, 3:4]], dim=1).view(-1, CLUSTER, 3)
    idc = ids.to(torch.int64).view(-1, CLUSTER)
    bitc = bits.view(-1, CLUSTER, 4)
    forces = torch.zeros((n_atoms + 1, 3), dtype=dtype, device=dev)
    energy = torch.zeros((), dtype=dtype, device=dev)
    virial = torch.zeros((3, 3), dtype=dtype, device=dev)
    pairs = blockpairs.pairs.to(torch.int64)
    for start in range(0, pairs.shape[0], chunk):
        I, J = pairs[start:start + chunk].unbind(dim=1)
        coef, e, dx = _tile_terms(spec, x[I], x[J], par[I], par[J], idc[I],
                                  idc[J], bitc[I], sides, inv, n_atoms)
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


def _check_cuda_input(name, t, dtype, width):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous() or t.shape[-1] != width:
        raise ValueError(f"{name} must be contiguous with last dim {width}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


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
    # open axes: side and inverse 0, so the minimum image leaves them alone
    sides = [L if math.isfinite(L) else 0.0 for L in blockpairs.box_host]
    inv = [1.0 / L if L else 0.0 for L in sides]
    forces = torch.zeros((n_atoms, 3), dtype=torch.float32, device=dev)
    ev = torch.zeros((7,), dtype=torch.float64, device=dev)
    lib = native.load("pair_nonbonded", _SIG)
    err = lib.pair_nonbonded_launch(
        pos4.data_ptr(), lj2.data_ptr(), ids.data_ptr(), bits.data_ptr(),
        pairs.data_ptr(), int(pairs.shape[0]), int(n_atoms),
        *sides, *inv,
        spec.cutoff ** 2, spec.ke, spec.alpha, spec.lj_w, spec.coul_w,
        forces.data_ptr(), ev.data_ptr(), int(bool(compute_energy)),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pair_nonbonded kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    energy = ev[0].to(torch.float32)
    v = ev[1:].to(torch.float32)
    virial = torch.stack([v[0], v[1], v[2], v[1], v[3], v[4], v[2], v[4],
                          v[5]]).view(3, 3)
    return forces, energy, virial


def pair_nonbonded(spec, blockpairs, boundary, n_atoms, compute_energy=False):
    """(forces (N, 3), energy, virial (3, 3)) of every listed pair inside the
    cutoff. CPU tensors run the plain twin; CUDA tensors launch the kernel
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
        inside = r2 < spec.cutoff ** 2
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
