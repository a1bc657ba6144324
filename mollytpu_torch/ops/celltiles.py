"""The cell-tile neighbor engine (counterpart of mollytpu/ops/celltiles.py).

The cell table itself is the neighbor structure. Atoms bin into a fixed
grid of cells at least ``dist_cutoff`` wide, sized from the setup box; the
(n_cells, capacity) table, padded with the sentinel N, is rebuilt by a
stable sort of the atoms by cell and a rank within each cell's run. A force
evaluation takes, for every cell, the dense tile of its atoms (rows)
against the atoms of the cells of its stencil (columns), with validity,
radius and exclusion masks; both orderings of each pair are evaluated, so
the force on a row atom is the sum over its row, scattered once through
the table, and the energy is half the sum over all tiles.

JAX materialises every tile at once; here the cells go in blocks of about
``BLOCK_SLOTS`` pair slots, so that a block's intermediates stay within a
few GB at 16,000-32,000 atoms. Each row atom lives in one cell, so the
blocks change no per-atom sum; only the order of the energy's and the
virial's sums changes. Plain PyTorch: the JAX engine is XLA, not Pallas.
dU/dr comes from the neighbor engine's autograd helper
(ops.nonbonded._pair_grad).

Exclusions and 1-4 pairs are looked up in the System's windowed bitmaps
and far-pair lists (system.Exclusions), the same sets as JAX's per-atom
membership tables.

Like JAX, ``setup`` sizes the grid from the box's side lengths (the basis
diagonal of a triclinic box). In a skewed box a cell's perpendicular width
is less than its edge, and a pair inside the radius may then lie outside
the 27-cell stencil: JAX's tiles miss it silently (ROADMAP Queue 3). The
port raises ValueError at setup instead, for every axis with more than
three cells (with three or fewer, the stencil holds every cell of the
axis).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..system import EXCL_WINDOW
from .nonbonded import (_pair_energy, _pair_grad, _PairView, _split_inters,
                        _virial)

#: pair slots evaluated at once: one f32 field of a block is 64 MB
BLOCK_SLOTS = 1 << 24


@dataclasses.dataclass(frozen=True)
class CellTiles:
    """The cell occupancy table: table[c, k] < N is the k-th atom of cell
    c, N is padding; overflow (a 0-d int32 tensor) counts the atoms that
    found their cell full; step_built is the step of the build."""

    table: torch.Tensor     # (n_cells, cap) int64
    overflow: torch.Tensor  # () int32
    step_built: int = 0


def _stencil(dims):
    """(n_cells, S) neighbour cell ids: the offsets (-1, 0, 1)^3, z
    fastest, with those a grid of fewer than 3 cells on an axis would
    visit twice removed (the first visit kept)."""
    offs, seen = [], set()
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                key = (ox % dims[0], oy % dims[1], oz % dims[2])
                if key not in seen:
                    seen.add(key)
                    offs.append((ox, oy, oz))
    cells = np.arange(int(np.prod(dims)))
    cx, rem = np.divmod(cells, dims[1] * dims[2])
    cy, cz = np.divmod(rem, dims[2])
    sten = np.zeros((cells.size, len(offs)), dtype=np.int64)
    for s, (ox, oy, oz) in enumerate(offs):
        sten[:, s] = (((cx + ox) % dims[0]) * dims[1]
                      + (cy + oy) % dims[1]) * dims[2] + (cz + oz) % dims[2]
    return sten


def _sides(boundary):
    return boundary.side_lengths.detach().to("cpu", torch.float64).numpy()


@dataclasses.dataclass(frozen=True)
class CellTileFinder:
    """Static grid and stencil. dist_cutoff is the list radius (the
    interaction cutoff plus a skin); cells are at least that wide, so the
    stencil covers the interaction sphere. Under a barostat a box that
    drifts more than ``resetup_drift`` (relative, any side) from
    ``ref_sides`` is set up anew between chunks (sim.simulate.npt_resetup;
    mollytpu/ops/celltiles.py:74-90)."""

    dist_cutoff: float
    stencil: torch.Tensor = None   # (n_cells, S) int64 neighbour cell ids
    grid_dims: tuple = None
    cell_capacity: int = 32
    n_steps: int = 1
    ref_sides: tuple = None
    resetup_drift: float = 0.05

    @classmethod
    def setup(cls, boundary, dist_cutoff, n_atoms, n_steps=1,
              cell_capacity=None):
        """The grid from the box's side lengths, floor(side / dist_cutoff)
        cells per axis; the capacity the Poisson mean + 6 sigma + 4 (at
        least 8) unless given, padded to a multiple of 8; the stencil built
        on the host and moved once to the box's device."""
        sides = _sides(boundary)
        dims = tuple(int(max(1, math.floor(s / dist_cutoff))) for s in sides)
        if getattr(boundary, "basis", None) is not None:
            for k, (w, d) in enumerate(zip(boundary.perp_widths(), dims)):
                if d > 3 and w / d < dist_cutoff:
                    raise ValueError(
                        f"cell tiles: the box's perpendicular width {w:.4f} "
                        f"nm along axis {k} makes {d} cells {w / d:.4f} nm "
                        f"wide, less than the {dist_cutoff} nm list radius: "
                        "the 27-cell stencil would miss pairs in this "
                        "skewed box")
        n_cells = int(np.prod(dims))
        per_cell = n_atoms / max(n_cells, 1)
        if cell_capacity is None:
            cell_capacity = int(max(8, math.ceil(
                per_cell + 6.0 * math.sqrt(per_cell) + 4)))
        cell_capacity = ((cell_capacity + 7) // 8) * 8
        stencil = torch.as_tensor(_stencil(dims),
                                  device=boundary.box_matrix().device)
        return cls(dist_cutoff=float(dist_cutoff), stencil=stencil,
                   grid_dims=dims, cell_capacity=cell_capacity,
                   n_steps=int(n_steps),
                   ref_sides=tuple(float(s) for s in sides))

    def box_drift_exceeded(self, boundary):
        """Host-side check between chunks: has a finite side moved more
        than ``resetup_drift`` from the setup box's?"""
        if self.ref_sides is None:
            return False
        return any(abs(cur / ref - 1.0) > self.resetup_drift
                   for cur, ref in zip(_sides(boundary), self.ref_sides)
                   if math.isfinite(cur) and math.isfinite(ref))

    def resetup(self, boundary, n_atoms, atoms=None):
        """A finder set up for the current box, same radius, cadence and
        capacity."""
        return type(self).setup(boundary, self.dist_cutoff, n_atoms,
                                n_steps=self.n_steps,
                                cell_capacity=self.cell_capacity)

    def find(self, coords, boundary, exclusions=None, step_n=0):
        """The table at these coordinates (mollytpu/ops/celltiles.py:
        127-152): atoms ranked within their cell in the order of a stable
        sort by cell, those beyond the capacity dropped and counted."""
        n = coords.shape[0]
        dev = coords.device
        dims = self.grid_dims
        n_cells = int(np.prod(dims))
        cap = self.cell_capacity
        frac = torch.clamp(boundary.fractional(boundary.wrap(coords)),
                           0.0, 1.0 - 1e-7)
        cell3 = [torch.clamp(torch.floor(frac[:, k] * float(dims[k])).to(
            torch.int64), 0, dims[k] - 1) for k in range(3)]
        cid = (cell3[0] * dims[1] + cell3[1]) * dims[2] + cell3[2]
        order = torch.argsort(cid, stable=True)
        sorted_cid = cid[order]
        arange = torch.arange(n, device=dev)
        is_start = torch.ones(n, dtype=torch.bool, device=dev)
        is_start[1:] = sorted_cid[1:] != sorted_cid[:-1]
        start_idx = torch.cummax(torch.where(is_start, arange, 0), dim=0)[0]
        rank = arange - start_idx
        keep = rank < cap
        overflow = (~keep).sum().to(torch.int32)
        # one slot past the table takes the dropped atoms
        table = torch.full((n_cells * cap + 1,), n, dtype=torch.int64,
                           device=dev)
        table[torch.where(keep, sorted_cid * cap + rank, n_cells * cap)] = \
            order
        return CellTiles(table[:-1].view(n_cells, cap), overflow,
                         int(step_n))


def _blocks(finder, tiles):
    """Per block of cells: (row atoms (B, cap), column atoms (B, S cap))."""
    table = tiles.table
    n_cells, cap = table.shape
    step = max(1, BLOCK_SLOTS // (cap * cap * finder.stencil.shape[1]))
    for c0 in range(0, n_cells, step):
        a = table[c0:c0 + step]
        yield a, table[finder.stencil[c0:c0 + step]].reshape(a.shape[0], -1)


def _geometry(coords, boundary, a, b):
    """Minimum-image dr (B - A) by component and r^2 over the (B, cap,
    S cap) tile slots; padding reads atom N - 1, as JAX's clamped gather."""
    n = coords.shape[0]
    a, b = torch.clamp(a, max=n - 1), torch.clamp(b, max=n - 1)
    drs = boundary.mic_parts(tuple(coords[:, k][b][:, None, :]
                                   - coords[:, k][a][:, :, None]
                                   for k in range(3)))
    return drs, drs[0] * drs[0] + drs[1] * drs[1] + drs[2] * drs[2]


def _live(a, b, n, r2, cutoff2):
    """Both atoms real, not the same atom, inside the radius."""
    return ((a < n)[:, :, None] & (b < n)[:, None, :]
            & (a[:, :, None] != b[:, None, :]) & (r2 < cutoff2))


def _member(bits, far, a, b, n):
    """Is (a, b) a pair of the set whose windowed bitmaps are ``bits``
    (N + 1, 2) and whose pairs beyond the window are ``far`` (F, 2), over
    the tile slots: bit (b - a + EXCL_WINDOW) of a's row, else a lookup of
    the key min * (N + 1) + max among the far pairs' sorted keys."""
    a32, b32 = a.to(torch.int32), b.to(torch.int32)
    d = b32[:, None, :] - a32[:, :, None] + EXCL_WINDOW
    rows = bits.to(a.device)[a]                          # (B, cap, 2)
    word = torch.where(d < 32, rows[..., :1], rows[..., 1:])
    hit = ((torch.bitwise_right_shift(word, d & 31) & 1) == 1) \
        & (d >= 0) & (d < 2 * EXCL_WINDOW)
    if far.shape[0]:
        lo = torch.minimum(a[:, :, None], b[:, None, :])
        hi = torch.maximum(a[:, :, None], b[:, None, :])
        key = lo * (n + 1) + hi
        far = far.to(a.device, torch.int64)
        fk = torch.sort(far[:, 0] * (n + 1) + far[:, 1])[0]
        pos = torch.clamp(torch.searchsorted(fk, key), max=fk.numel() - 1)
        hit = hit | (fk[pos] == key)
    return hit


def _masks(a, b, n, exclusions, cutoff2, r2):
    """(live, special) of the tile slots (mollytpu/ops/celltiles.py:
    179-192): excluded pairs are not live."""
    live = _live(a, b, n, r2, cutoff2)
    spec = torch.zeros_like(live)
    # a set without pairs (its shape, read on the host) is not looked up
    if exclusions is not None and exclusions.excl_i.numel():
        live = live & ~_member(exclusions.excl_bits, exclusions.far_excl, a,
                               b, n)
    if exclusions is not None and exclusions.spec_i.numel():
        spec = _member(exclusions.spec_bits, exclusions.far_spec, a, b, n)
    return live, spec


def _views(atoms, a, b, n):
    return (_PairView(atoms, lambda t: t[torch.clamp(a, max=n - 1)][
                :, :, None]),
            _PairView(atoms, lambda t: t[torch.clamp(b, max=n - 1)][
                :, None, :]))


def tile_energy(inters, atoms, coords, boundary, tiles, finder, exclusions):
    """Pair energy over the cell tiles: each unordered pair is counted
    twice, the sum halved at the end."""
    total = torch.zeros((), dtype=coords.dtype, device=coords.device)
    if not inters:
        return total
    n = coords.shape[0]
    for a, b in _blocks(finder, tiles):
        _, r2 = _geometry(coords, boundary, a, b)
        live, spec = _masks(a, b, n, exclusions, finder.dist_cutoff ** 2, r2)
        r = torch.sqrt(torch.where(live, r2, 1.0))
        ai, aj = _views(atoms, a, b, n)
        e = _pair_energy(inters, torch.where(live, r, 1.0), ai, aj, spec)
        total = total + torch.where(live, e, 0.0).sum()
    return 0.5 * total


def tile_forces(inters, atoms, coords, boundary, tiles, finder, exclusions,
                velocities=None, step_n=0, needs_virial=False):
    """Forces (N, 3) and virial (3, 3) over the cell tiles: coef = (dU/dr)
    / r per slot, the force on a row atom the sum over its row of coef dr,
    added into N once through the table; the virial -0.5 sum coef dr dr."""
    n = coords.shape[0]
    vir = torch.zeros((3, 3), dtype=coords.dtype, device=coords.device)
    if not inters:
        return torch.zeros_like(coords), vir
    cons, veldep = _split_inters(inters)
    if veldep:
        raise NotImplementedError(
            "velocity-dependent interactions use the compact-list path")
    # one row past the atoms takes the padding slots
    forces = torch.zeros((n + 1, 3), dtype=coords.dtype,
                         device=coords.device)
    for a, b in _blocks(finder, tiles):
        drs, r2 = _geometry(coords, boundary, a, b)
        live, spec = _masks(a, b, n, exclusions, finder.dist_cutoff ** 2, r2)
        r = torch.sqrt(torch.where(live, r2, 1.0))
        ai, aj = _views(atoms, a, b, n)
        g = torch.where(live, _pair_grad(cons, torch.where(live, r, 1.0),
                                         ai, aj, spec), 0.0)
        coef = g / r
        fa = torch.stack([(coef * d).sum(dim=2) for d in drs], dim=-1)
        forces = forces.index_add(0, a.reshape(-1), fa.reshape(-1, 3))
        if needs_virial:
            vir = vir + _virial(coef, drs, 0.5)
    return forces[:n], vir


def uncovered_min_distance(old, new, finder, coords, boundary, cutoff):
    """The closest atom pair inside ``cutoff`` at ``coords`` that the tiles
    ``old`` do not cover, as a device scalar (inf when there is none). A
    pair is covered when both atoms are in old's table and old's cell of
    one is in the stencil of the other's: along every axis the cells are
    at most one apart (modulo the grid). The candidates are the pairs of
    the tiles ``new``, built at ``coords`` on the same grid: every pair
    inside the radius while the cells are at least the cutoff wide."""
    n = coords.shape[0]
    dev = coords.device
    dims = finder.grid_dims
    n_cells, cap = old.table.shape
    cell = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    cell[old.table.reshape(-1)] = torch.arange(
        n_cells, device=dev).repeat_interleave(cap)
    cell[n] = -1
    cz = cell % dims[2]
    cy = (cell // dims[2]) % dims[1]
    cx = cell // (dims[1] * dims[2])
    closest = torch.full((), float("inf"), dtype=coords.dtype, device=dev)
    for a, b in _blocks(finder, new):
        _, r2 = _geometry(coords, boundary, a, b)
        near = _live(a, b, n, r2, cutoff * cutoff)
        covered = (cell[a] >= 0)[:, :, None] & (cell[b] >= 0)[:, None, :]
        for c, d in zip((cx, cy, cz), dims):
            off = (c[b][:, None, :] - c[a][:, :, None]) % d
            covered = covered & ((off <= 1) | (off == d - 1))
        closest = torch.minimum(closest, torch.where(
            near & ~covered, torch.sqrt(r2), float("inf")).amin())
    return closest
