"""The general pair engines (counterpart of mollytpu/ops/nonbonded.py):
dense all-pairs over (N, N) and the neighbor table over (N, K), for every
pairwise interaction, where the pair kernel (ops/pair_kernel.py) takes
only its modes on the cluster-pair list.

The pair energy is the sum of the interactions' ``energy`` on broadcast
tensors. dU/dr comes from ``torch.autograd.grad`` of the summed energy
with respect to the distance tensor, as JAX's ``jax.grad`` gives it, so
force = -dU/dr by construction; the force on i is sum_j (dU/dr / r) dr_ij
with dr_ij = x_j - x_i (minimum image), and the virial is
-sum (dU/dr / r) dr (x) dr over pairs. Velocity-dependent interactions
(DPD) give their pair force through ``force_vec``. Plain PyTorch: the JAX
engines are XLA, not Pallas.

``neighbor_forces`` dispatches on what it is given: on a CUDA card, a
LennardJones alone with a DistanceCutoff, Lorentz and geometric mixing,
in an Orthorhombic or Triclinic box, on float32 or float64 inputs that
track no gradient (``lj_table_admits``), runs the hand-written kernel
csrc/lj_table.cu in one launch, counted in ``native.LAUNCHES``; every
other call runs the autograd engine, ``neighbor_forces_plain``, which is
also the kernel's twin. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from ..boundary import Orthorhombic, Triclinic, pair_geometry
from ..config import atom_tensors, tracks_grad
from . import native
from .cutoffs import DistanceCutoff
from .mixing import GeometricMixing, LorentzMixing
from .pairwise import LennardJones


class _PairView:
    """Per-pair atom parameters, gathered on first use: ``fn`` of the
    Atoms field (a broadcast view or a gather by the table's columns).
    An interaction reads only the fields it needs (LJ: sigma, epsilon and
    lambda), so the others are never gathered."""

    def __init__(self, atoms, fn):
        self._atoms, self._fn = atoms, fn

    def __getattr__(self, name):
        value = getattr(self._atoms, name)
        if value is not None:
            value = self._fn(value)
        setattr(self, name, value)
        return value


def _split_inters(inters):
    conservative = tuple(i for i in inters
                         if not getattr(i, "uses_velocity", False))
    velocity_dep = tuple(i for i in inters
                         if getattr(i, "uses_velocity", False))
    return conservative, velocity_dep


def _pair_energy(inters, r, ai, aj, special):
    total = 0.0
    for inter in inters:
        total = total + inter.energy(r, ai, aj, special)
    return total


def _pair_grad(inters, r, ai, aj, special):
    """dU/dr per pair: each pair's energy depends on its own r only, so the
    gradient of the sum is the per-pair derivative. When r or an atom
    parameter tracks grad, dU/dr keeps its graph (create_graph), so that
    a gradient runs through the forces."""
    graph = tracks_grad(r, *atom_tensors(ai._atoms))
    with torch.enable_grad():
        rr = r if graph and r.requires_grad else r.detach().requires_grad_(
            True)
        (g,) = torch.autograd.grad(
            _pair_energy(inters, rr, ai, aj, special).sum(), rr,
            create_graph=graph)
    return g


def dense_pair_mask(n_atoms, exclusions, device=None):
    """(N, N) int8 pair codes: 0 normal, 1 excluded (the diagonal too),
    2 special (1-4)."""
    device = device if device is not None else exclusions.excl_i.device
    mask = torch.zeros((n_atoms, n_atoms), dtype=torch.int8, device=device)
    ar = torch.arange(n_atoms, device=device)
    mask[ar, ar] = 1
    if exclusions is not None:
        for (a, b), code in (((exclusions.excl_i, exclusions.excl_j), 1),
                             ((exclusions.spec_i, exclusions.spec_j), 2)):
            a, b = a.to(device, torch.int64), b.to(device, torch.int64)
            mask[a, b] = code
            mask[b, a] = code
    return mask


def _virial(coef, drs, scale):
    """-(scale) sum coef dr_a dr_b: the pair virial in JAX's convention."""
    return (-scale) * torch.stack([torch.stack([(coef * a * b).sum()
                                                for b in drs])
                                   for a in drs])


def dense_energy(inters, atoms, coords, boundary, pair_mask):
    """All-pairs energy: half the sum over ordered pairs."""
    if not inters:
        return torch.zeros((), dtype=coords.dtype, device=coords.device)
    _, d2 = pair_geometry(coords, boundary)
    live = pair_mask != 1
    special = pair_mask == 2
    r = torch.sqrt(torch.where(live, d2, 1.0))
    e = _pair_energy(inters, torch.where(live, r, 1.0),
                     _PairView(atoms, lambda t: t[:, None]),
                     _PairView(atoms, lambda t: t[None, :]), special)
    return 0.5 * torch.where(live, e, 0.0).sum()


def dense_forces(inters, atoms, coords, boundary, pair_mask, velocities=None,
                 step_n=0, needs_virial=False):
    """All-pairs forces (N, 3) and virial (3, 3)."""
    n = coords.shape[0]
    forces = torch.zeros_like(coords)
    vir = torch.zeros((3, 3), dtype=coords.dtype, device=coords.device)
    if not inters:
        return forces, vir
    cons, veldep = _split_inters(inters)
    drs, d2 = pair_geometry(coords, boundary)
    live = pair_mask != 1
    special = pair_mask == 2
    r = torch.sqrt(torch.where(live, d2, 1.0))
    ai = _PairView(atoms, lambda t: t[:, None])
    aj = _PairView(atoms, lambda t: t[None, :])
    if cons:
        g = torch.where(live, _pair_grad(cons, torch.where(live, r, 1.0),
                                         ai, aj, special), 0.0)
        coef = g / r
        # both orderings of every pair are present: no scatter
        forces = forces + torch.stack([(coef * d).sum(dim=1) for d in drs],
                                      dim=-1)
        if needs_virial:
            vir = vir + _virial(coef, drs, 0.5)
    if veldep:
        ii = torch.arange(n, device=coords.device)
        drv = torch.stack(drs, dim=-1)
        r_safe = torch.where(live, r, 1.0)
        for inter in veldep:
            fv = inter.force_vec(drv, r_safe, ii[:, None], ii[None, :], ai,
                                 aj, velocities[:, None, :],
                                 velocities[None, :, :], special, step_n)
            fv = live[..., None] * fv             # the force on j
            forces = forces - fv.sum(dim=1)
            if needs_virial:
                vir = vir + 0.5 * torch.einsum("ijd,ije->de", drv, fv)
    return forces, vir


def _table(coords, neighbors):
    """(live slots, the column atoms with padding clamped to N - 1)."""
    n = coords.shape[0]
    idx = neighbors.idx
    live = idx < n
    return live, torch.clamp(idx, max=n - 1).to(torch.int64)


def _scatter_index(live, safe_j):
    """The atoms the pair forces are scattered to: the column atom, and on
    a padding slot (whose force is 0) the row's own atom, so that padding
    does not pile every atomic add of the table onto atom N - 1."""
    rows = torch.arange(safe_j.shape[0], device=safe_j.device)[:, None]
    return torch.where(live, safe_j, rows).reshape(-1)


def neighbor_energy(inters, atoms, coords, boundary, neighbors):
    """Energy over the neighbor table (each pair once)."""
    if not inters or neighbors is None:
        return torch.zeros((), dtype=coords.dtype, device=coords.device)
    live, safe_j = _table(coords, neighbors)
    _, d2 = pair_geometry(coords, boundary, safe_j)
    r = torch.sqrt(torch.where(live, d2, 1.0))
    e = _pair_energy(inters, torch.where(live, r, 1.0),
                     _PairView(atoms, lambda t: t[:, None]),
                     _PairView(atoms, lambda t: t[safe_j]), neighbors.special)
    return torch.where(live, e, 0.0).sum()


class _TableSpec(ctypes.Structure):
    """The launcher's spec, field for field csrc/lj_table.cu's
    TableSpec."""

    _fields_ = [("cutoff", ctypes.c_double),
                ("weight_special", ctypes.c_double)] + [
        (name, ctypes.c_int) for name in ("n_atoms", "k_max", "f64",
                                          "virial", "triclinic")]


_TABLE_SIG = {"lj_table_launch": [ctypes.c_void_p] * 12}


def lj_table_admits(inters, atoms, coords, boundary, neighbors):
    """Whether csrc/lj_table.cu computes neighbor_forces on these inputs
    when they are on a CUDA card: the interactions are one LennardJones
    (exactly that class) with a DistanceCutoff, LorentzMixing sigma and
    GeometricMixing epsilon, the box is Orthorhombic (open axes included)
    or Triclinic with its tensors on the coordinates' device, the table
    has a column, the coordinates are float32 or float64 and sigma,
    epsilon and lambda of their type and device, and neither the
    coordinates, the box nor an atom parameter tracks a gradient."""
    if neighbors is None or len(inters) != 1 or neighbors.idx.shape[1] == 0:
        return False
    (lj,) = inters
    if (type(lj) is not LennardJones
            or type(lj.cutoff) is not DistanceCutoff
            or type(lj.sigma_mixing) is not LorentzMixing
            or type(lj.epsilon_mixing) is not GeometricMixing
            or type(boundary) not in (Orthorhombic, Triclinic)
            or coords.dtype not in (torch.float32, torch.float64)):
        return False
    if any(t is not None and (t.dtype != coords.dtype
                              or t.device != coords.device)
           for t in (atoms.sigma, atoms.epsilon, atoms.lam)):
        return False
    box = ((boundary.basis, boundary.inv) if type(boundary) is Triclinic
           else (boundary.side_lengths,))
    if any(t.device != coords.device for t in box):
        return False
    return not tracks_grad(coords, *box, *atom_tensors(atoms))


def neighbor_forces(inters, atoms, coords, boundary, neighbors,
                    velocities=None, step_n=0, needs_virial=False):
    """Forces (N, 3) and virial (3, 3) over the neighbor table: each listed
    pair's force goes to its row atom and, by its reaction, to the other.
    On the table kernel for CUDA inputs that ``lj_table_admits``, else by
    ``neighbor_forces_plain``."""
    if coords.is_cuda and lj_table_admits(inters, atoms, coords, boundary,
                                          neighbors):
        return lj_table_forces(inters[0], atoms, coords, boundary, neighbors,
                               needs_virial)
    return neighbor_forces_plain(inters, atoms, coords, boundary, neighbors,
                                 velocities, step_n, needs_virial)


def lj_table_forces(lj, atoms, coords, boundary, neighbors,
                    needs_virial=False):
    """Forces and virial of ``lj`` over the table by csrc/lj_table.cu, on
    the current stream of the coordinates' card, with no host read:
    (forces (N, 3), virial (3, 3)), views of one zeroed buffer the kernel
    adds to (the virial stays 0 without ``needs_virial``). In float32 the
    buffer's force rows are padded to 4 (one vector atomic add a pair), so
    the forces are a strided view."""
    n = coords.shape[0]
    dev, dtype = coords.device, coords.dtype
    if n >= 2 ** 31 - 1:
        raise ValueError(f"the table kernel takes fewer than 2^31 - 1 atoms, "
                         f"got {n}")
    if neighbors.idx.shape[0] != n:
        raise ValueError(f"the table has {neighbors.idx.shape[0]} rows for "
                         f"{n} atoms")
    idx = neighbors.idx.to(torch.int32).contiguous()
    weighted = float(lj.weight_special) != 1.0
    special = neighbors.special.contiguous() if weighted else None
    box_a, box_b = boundary.mic_tensors(dtype)
    coords = coords.detach().contiguous()
    sigma, epsilon, lam = (None if t is None else t.detach().contiguous()
                           for t in (atoms.sigma, atoms.epsilon, atoms.lam))
    width = 3 if dtype == torch.float64 else 4
    out = torch.zeros((width * n + 9,), dtype=dtype, device=dev)
    spec = _TableSpec(cutoff=float(lj.cutoff.dist_cutoff),
                      weight_special=float(lj.weight_special), n_atoms=n,
                      k_max=int(idx.shape[1]),
                      f64=int(dtype == torch.float64),
                      virial=int(bool(needs_virial)),
                      triclinic=int(type(boundary) is Triclinic))
    native.launch("lj_table", "lj_table_launch", _TABLE_SIG, spec, coords,
                  box_a, box_b, sigma, epsilon, lam, idx, special, out,
                  out[width * n:], device=dev)
    return out[:width * n].view(n, width)[:, :3], out[width * n:].view(3, 3)


def neighbor_forces_plain(inters, atoms, coords, boundary, neighbors,
                          velocities=None, step_n=0, needs_virial=False):
    """neighbor_forces by the autograd engine, for every interaction on any
    device: each listed pair's force goes to its row atom and, scattered,
    to the other."""
    n = coords.shape[0]
    forces = torch.zeros_like(coords)
    vir = torch.zeros((3, 3), dtype=coords.dtype, device=coords.device)
    if not inters or neighbors is None:
        return forces, vir
    cons, veldep = _split_inters(inters)
    live, safe_j = _table(coords, neighbors)
    drs, d2 = pair_geometry(coords, boundary, safe_j)
    r = torch.sqrt(torch.where(live, d2, 1.0))
    ai = _PairView(atoms, lambda t: t[:, None])
    aj = _PairView(atoms, lambda t: t[safe_j])
    flat_j = _scatter_index(live, safe_j)
    drv = torch.stack(drs, dim=-1)
    if cons:
        g = torch.where(live, _pair_grad(cons, torch.where(live, r, 1.0),
                                         ai, aj, neighbors.special), 0.0)
        coef = g / r
        fk = coef[..., None] * drv           # the pair force on the row atom
        forces = (forces + fk.sum(dim=1)).index_add(0, flat_j,
                                                   -fk.reshape(-1, 3))
        if needs_virial:
            vir = vir + _virial(coef, drs, 1.0)
    if veldep:
        ii = torch.arange(n, device=coords.device)[:, None]
        r_safe = torch.where(live, r, 1.0)
        for inter in veldep:
            fv = inter.force_vec(drv, r_safe, ii, safe_j, ai, aj,
                                 velocities[:, None, :], velocities[safe_j],
                                 neighbors.special, step_n)
            fv = live[..., None] * fv             # the force on j
            forces = (forces - fv.sum(dim=1)).index_add(0, flat_j,
                                                       fv.reshape(-1, 3))
            if needs_virial:
                vir = vir + torch.einsum("ikd,ike->de", drv, fv)
    return forces, vir
