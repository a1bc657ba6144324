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
"""

from __future__ import annotations

import torch

from ..config import atom_tensors, tracks_grad


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


def _geometry(coords, boundary, js=None):
    """Per-component minimum-image dr[d][i, c] = x_j - x_i and r^2, over
    all j (js None: (N, N)) or the table columns js (N, K)."""
    comps = [coords[:, k] for k in range(coords.shape[1])]
    if js is None:
        diffs = tuple(c[None, :] - c[:, None] for c in comps)
    else:
        diffs = tuple(c[js] - c[:, None] for c in comps)
    drs = boundary.mic_parts(diffs)
    return drs, drs[0] * drs[0] + drs[1] * drs[1] + drs[2] * drs[2]


def _virial(coef, drs, scale):
    """-(scale) sum coef dr_a dr_b: the pair virial in JAX's convention."""
    return (-scale) * torch.stack([torch.stack([(coef * a * b).sum()
                                                for b in drs])
                                   for a in drs])


def dense_energy(inters, atoms, coords, boundary, pair_mask):
    """All-pairs energy: half the sum over ordered pairs."""
    if not inters:
        return torch.zeros((), dtype=coords.dtype, device=coords.device)
    _, d2 = _geometry(coords, boundary)
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
    drs, d2 = _geometry(coords, boundary)
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
    _, d2 = _geometry(coords, boundary, safe_j)
    r = torch.sqrt(torch.where(live, d2, 1.0))
    e = _pair_energy(inters, torch.where(live, r, 1.0),
                     _PairView(atoms, lambda t: t[:, None]),
                     _PairView(atoms, lambda t: t[safe_j]), neighbors.special)
    return torch.where(live, e, 0.0).sum()


def neighbor_forces(inters, atoms, coords, boundary, neighbors,
                    velocities=None, step_n=0, needs_virial=False):
    """Forces (N, 3) and virial (3, 3) over the neighbor table: each listed
    pair's force goes to its row atom and, scattered, to the other."""
    n = coords.shape[0]
    forces = torch.zeros_like(coords)
    vir = torch.zeros((3, 3), dtype=coords.dtype, device=coords.device)
    if not inters or neighbors is None:
        return forces, vir
    cons, veldep = _split_inters(inters)
    live, safe_j = _table(coords, neighbors)
    drs, d2 = _geometry(coords, boundary, safe_j)
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
