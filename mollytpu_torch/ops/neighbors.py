"""Neighbor tables for the general pair engine (counterpart of
mollytpu/ops/neighbors.py:43-334).

A ``Neighbors`` table holds, per atom i, the atoms j it interacts with:
idx (N, K), padded with the sentinel N, and the parallel 1-4 flags. Each
unordered pair sits in one row only, by JAX's balanced ownership: the pair
{i, j} belongs to min(i, j) when i + j is even and to max(i, j) otherwise,
so every row holds about half of its sphere whatever its index. Rows are
compacted in candidate order, so both finders give JAX's tables element
for element:

  NoNeighborFinder        no table: the interactions run the dense engine
  DistanceNeighborFinder  the (N, N) distance test, compacted to (N, K)
  CellListNeighborFinder  a fixed-capacity cell grid, candidates from the
                          27-cell stencil, compacted to (N, K)

A table that could not hold every pair (more than K in a row, or more than
the capacity in a cell) reports the excess in ``overflow``, a device
scalar; the simulation loop reads it at the end of a chunk and raises.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Neighbors:
    """Padded per-atom neighbor table: idx[i, k] < N is a neighbor of i,
    N is padding; special marks 1-4 pairs; overflow > 0 (a 0-d int32
    tensor) means capacity was exceeded; step_built is the step of the
    build."""

    idx: torch.Tensor       # (N, K) int32
    special: torch.Tensor   # (N, K) bool
    overflow: torch.Tensor  # () int32
    step_built: int = 0


def _membership(table, js):
    """Is js[i, c] among the partners table[i, :]? (N, W) x (N, C) ->
    (N, C). A table without pairs holds only sentinels, which match no
    atom: the caller skips the test then."""
    return (js[:, :, None] == table[:, None, :]).any(dim=2)


def _pair_flags(exclusions, js):
    """(excluded, special) flags of the candidates js (N, C), each atom
    against its row's partner tables."""
    def member(pairs, table):
        if pairs.numel() == 0:
            return torch.zeros(js.shape, dtype=torch.bool, device=js.device)
        return _membership(table.to(js.device), js)

    return (member(exclusions.excl_i, exclusions.excl_table),
            member(exclusions.spec_i, exclusions.spec_table))


def _owned(ii, js):
    """JAX's balanced ownership of the pair (i, j) by row i."""
    return torch.where((ii + js) % 2 == 0, js > ii, js < ii)


def _compact_rows(cand_j, valid, special, k_max, n_atoms):
    """Per row, the valid candidates moved to the front in candidate
    order, cut at k_max: (idx, special, overflow). A cumulative-sum rank
    and one scatter, as in JAX (no sort)."""
    n = cand_j.shape[0]
    dev = cand_j.device
    rank = torch.cumsum(valid.to(torch.int32), dim=1) - 1
    rank = torch.where(valid, rank, k_max)
    rank_c = torch.clamp(rank, max=k_max)
    rows = torch.arange(n, device=dev, dtype=torch.int64)[:, None]
    flat = (rows * (k_max + 1) + rank_c).reshape(-1)
    idx = torch.full((n * (k_max + 1),), n_atoms, dtype=torch.int32,
                     device=dev)
    idx[flat] = torch.where(valid, cand_j, n_atoms).to(torch.int32).reshape(-1)
    spec = torch.zeros((n * (k_max + 1),), dtype=torch.bool, device=dev)
    spec[flat] = (special & valid).reshape(-1)
    counts = valid.sum(dim=1)
    overflow = torch.clamp(counts.max() - k_max, min=0).to(torch.int32)
    return (idx.view(n, k_max + 1)[:, :k_max].contiguous(),
            spec.view(n, k_max + 1)[:, :k_max].contiguous(), overflow)


def _sq_distances(coords, boundary, js):
    """Minimum-image r^2 from each row atom to js, component by component
    in JAX's order (mic_parts, then x^2 + y^2 + z^2)."""
    dx, dy, dz = boundary.mic_parts(tuple(coords[:, k][js]
                                          - coords[:, k][:, None]
                                          for k in range(3)))
    return dx * dx + dy * dy + dz * dz


@dataclasses.dataclass(frozen=True)
class NoNeighborFinder:
    """All pairs interact at every step: no table, the dense engine."""

    n_steps: int = 0

    def find(self, coords, boundary, exclusions, step_n=0):
        return None


@dataclasses.dataclass(frozen=True)
class DistanceNeighborFinder:
    """The (N, N) masked distance test compacted to (N, K). dist_cutoff is
    the list radius: the interaction cutoff plus a skin for the motion
    between rebuilds."""

    dist_cutoff: float
    n_steps: int = 10
    max_neighbors: int = 64

    def find(self, coords, boundary, exclusions, step_n=0):
        n = coords.shape[0]
        js = torch.arange(n, device=coords.device)
        jj = js[None, :].expand(n, n)
        d2 = _sq_distances(coords, boundary, jj)
        valid = _owned(js[:, None], jj) & (d2 < self.dist_cutoff ** 2)
        excl, spec = _pair_flags(exclusions, jj)
        idx, special, overflow = _compact_rows(
            jj, valid & ~excl, spec, self.max_neighbors, n)
        return Neighbors(idx, special, overflow, int(step_n))


#: the 27-cell stencil (dx, dy, dz), dz fastest, as the JAX package
#: orders it
_STENCIL = np.array(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1],
                                indexing="ij")).reshape(3, -1).T


def _stencil(grid_dims):
    """The stencil's offsets with the cells a grid of fewer than 3 cells
    on an axis would visit twice removed (the first visit kept)."""
    seen, uniq = set(), []
    for off in _STENCIL:
        key = tuple(int(o) % d for o, d in zip(off, grid_dims))
        if key not in seen:
            seen.add(key)
            uniq.append(off)
    return np.array(uniq)


@dataclasses.dataclass(frozen=True)
class CellListNeighborFinder:
    """A fixed-shape cell list: atoms bin into a grid of cells at least
    dist_cutoff wide sized from the setup box; candidates come from the 27
    cells around each atom's; rows compact to (N, K). grid_dims,
    max_neighbors and cell_capacity are fixed at setup."""

    dist_cutoff: float
    grid_dims: tuple = None
    n_steps: int = 10
    max_neighbors: int = 96
    cell_capacity: int = 32

    @classmethod
    def setup(cls, boundary, dist_cutoff, n_atoms, n_steps=10,
              max_neighbors=None, cell_capacity=None, coords=None,
              exclusions=None):
        """Size the grid and the capacities from the box and the atom
        count (mollytpu/ops/neighbors.py:157-232): the cell capacity and
        the row width default to the Poisson mean + 6 sigma at the mean
        density. Given ``coords``, both come from the configuration
        instead (the fullest cell + 8; the largest neighbor count within
        the radius, halved, + 3 sigma + 8), trial builds grow them until
        the table fits, and the width gets 15% + 8 more."""
        sides = boundary.side_lengths.detach().to("cpu", torch.float64)
        sides = sides.numpy()
        dims = tuple(int(max(1, math.floor(s / dist_cutoff))) for s in sides)
        n_cells = int(np.prod(dims))
        per_cell = n_atoms / max(n_cells, 1)
        if cell_capacity is None:
            cell_capacity = int(max(16, math.ceil(
                per_cell + 6.0 * math.sqrt(per_cell) + 4)))
        if max_neighbors is None:
            dens = n_atoms / float(np.prod(sides))
            half_sphere = 0.5 * 4.0 / 3.0 * math.pi * dist_cutoff ** 3 * dens
            max_neighbors = int(max(16, math.ceil(
                half_sphere + 6.0 * math.sqrt(half_sphere) + 8)))
        if coords is not None:
            cell_capacity, max_neighbors = _size_from_coords(
                coords, boundary, sides, dims, dist_cutoff, max_neighbors)
        finder = cls(dist_cutoff=dist_cutoff, grid_dims=dims,
                     n_steps=n_steps, max_neighbors=int(max_neighbors),
                     cell_capacity=int(cell_capacity))
        if coords is not None:
            if exclusions is None:
                from ..system import Exclusions
                exclusions = Exclusions.build(n_atoms, device=coords.device)
            for _ in range(4):   # grow until the trial build fits
                over = int(finder.find(coords, boundary, exclusions).overflow)
                if over == 0:
                    break
                finder = dataclasses.replace(
                    finder,
                    max_neighbors=int((finder.max_neighbors + over) * 1.25),
                    cell_capacity=int(finder.cell_capacity * 1.5))
            # margin for density fluctuations during the run
            finder = dataclasses.replace(
                finder, max_neighbors=int(finder.max_neighbors * 1.15) + 8)
        return finder

    def find(self, coords, boundary, exclusions, step_n=0):
        n = coords.shape[0]
        dev = coords.device
        dims = self.grid_dims
        n_cells = int(np.prod(dims))
        cap = self.cell_capacity
        dims_i = torch.tensor(dims, dtype=torch.int64, device=dev)

        frac = torch.clamp(boundary.fractional(boundary.wrap(coords)),
                           0.0, 1.0 - 1e-7)
        cell3 = torch.floor(frac * dims_i.to(coords.dtype)).to(torch.int64)
        cell3 = torch.minimum(torch.clamp(cell3, min=0), dims_i - 1)
        cid = (cell3[:, 0] * dims[1] + cell3[:, 1]) * dims[2] + cell3[:, 2]

        # cell -> atoms table: a stable sort by cell, each atom's rank in
        # its cell's run
        order = torch.argsort(cid, stable=True)
        sorted_cid = cid[order]
        arange = torch.arange(n, device=dev)
        is_start = torch.ones(n, dtype=torch.bool, device=dev)
        is_start[1:] = sorted_cid[1:] != sorted_cid[:-1]
        start_idx = torch.cummax(torch.where(is_start, arange, 0), dim=0)[0]
        rank = arange - start_idx
        keep = rank < cap
        cell_overflow = (~keep).sum().to(torch.int32)
        table = torch.full((n_cells * cap,), n, dtype=torch.int64,
                           device=dev)
        slot = sorted_cid * cap + torch.clamp(rank, max=cap - 1)
        table[torch.where(keep, slot, n_cells * cap - 1)] = torch.where(
            keep, order, n)
        table = table.view(n_cells, cap)

        offsets = torch.as_tensor(_stencil(dims), dtype=torch.int64,
                                  device=dev)
        m = offsets.shape[0]
        ncell3 = (cell3[:, None, :] + offsets[None, :, :]) % dims_i
        ncid = (ncell3[..., 0] * dims[1] + ncell3[..., 1]) * dims[2] \
            + ncell3[..., 2]
        js = table[ncid.reshape(-1)].view(n, m * cap)

        safe_j = torch.clamp(js, max=n - 1)
        d2 = _sq_distances(coords, boundary, safe_j)
        ii = arange[:, None]
        in_range = (js < n) & _owned(ii, js) & (d2 < self.dist_cutoff ** 2)
        excl, spec = _pair_flags(exclusions, safe_j)
        idx, special, overflow = _compact_rows(
            js, in_range & ~excl, spec, self.max_neighbors, n)
        return Neighbors(idx, special, overflow + cell_overflow, int(step_n))


def _size_from_coords(coords, boundary, sides, dims, dist_cutoff,
                      max_neighbors):
    """(cell capacity, row width) from the configuration, on the host in
    float64 (mollytpu/ops/neighbors.py:181-212): the fullest cell + 8, and
    the largest count of atoms within dist_cutoff, halved for the balanced
    ownership, + 3 sigma + 8 (the given width where the count fails)."""
    cnp = coords.detach().to("cpu", torch.float64).numpy()
    frac = boundary.fractional(boundary.wrap(coords)).detach()
    frac = np.clip(frac.to("cpu", torch.float64).numpy() % 1.0, 0.0,
                   1.0 - 1e-9)
    cell3 = np.minimum((frac * dims).astype(np.int64), np.asarray(dims) - 1)
    cid = (cell3[:, 0] * dims[1] + cell3[:, 1]) * dims[2] + cell3[:, 2]
    occ = np.bincount(cid, minlength=int(np.prod(dims)))
    capacity = int(max(16, occ.max() + 8))
    from scipy.spatial import cKDTree
    periodic = bool(np.all(np.isfinite(sides)))
    pts = np.mod(cnp, sides) if periodic else cnp
    try:
        tree = cKDTree(pts, boxsize=sides) if periodic else cKDTree(pts)
        counts = np.asarray(tree.query_ball_point(
            pts, dist_cutoff, return_length=True)) - 1
    except ValueError:
        # a coordinate at the box edge after np.mod: keep the estimate
        return capacity, max_neighbors
    half_max = int(np.max(counts)) // 2 + int(
        3.0 * math.sqrt(max(float(np.max(counts)) / 2.0, 1.0)))
    return capacity, max(16, half_max + 8)


def find_neighbors(finder, coords, boundary, exclusions, step_n=0):
    """The finder's table (a BlockPairs list for the pair kernel) at these
    coordinates, or None without a finder."""
    if finder is None:
        return None
    return finder.find(coords, boundary, exclusions, step_n)


def maybe_rebuild(finder, neighbors, coords, boundary, exclusions, step_n):
    """A new table on the finder's cadence (step_n a multiple of n_steps),
    else the given one."""
    if (finder is None or isinstance(finder, NoNeighborFinder)
            or neighbors is None):
        return neighbors
    if finder.n_steps <= 1 or step_n % finder.n_steps == 0:
        return finder.find(coords, boundary, exclusions, step_n)
    return neighbors
