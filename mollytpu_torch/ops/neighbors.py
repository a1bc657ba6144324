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

``CellListNeighborFinder.find`` dispatches on the device of the
coordinates: CPU tensors go to ``find_plain``, the plain PyTorch twin;
CUDA tensors to the hand-written kernel csrc/cell_neighbors.cu, which
gives the twin's table element for element without the (N, 27 x capacity)
candidate tensors and counts its launches in ``native.LAUNCHES``. There
is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from ..boundary import pair_geometry
from . import native


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
        _, d2 = pair_geometry(coords, boundary, jj)
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

    def engine(self, coords):
        """What computes find on ``coords``: "cuda", the kernel, on a CUDA
        card; "torch", the twin (find_plain), elsewhere."""
        return "cuda" if coords.is_cuda else "torch"

    def find(self, coords, boundary, exclusions, step_n=0):
        """The table at ``coords``, computed by ``engine(coords)``."""
        if self.engine(coords) == "cuda":
            return _find_cuda(self, coords, boundary, exclusions, step_n)
        return self.find_plain(coords, boundary, exclusions, step_n)

    def find_plain(self, coords, boundary, exclusions, step_n=0):
        """The plain PyTorch twin of the kernel (JAX's find, tensor for
        tensor), on any device."""
        n = coords.shape[0]
        dev = coords.device
        dims = self.grid_dims
        n_cells = int(np.prod(dims))
        cap = self.cell_capacity
        dims_i = torch.tensor(dims, dtype=torch.int64, device=dev)
        cells, cid = _cells(coords, boundary, dims)
        cell3 = torch.stack(cells, dim=1)

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
        _, d2 = pair_geometry(coords, boundary, safe_j)
        ii = arange[:, None]
        in_range = (js < n) & _owned(ii, js) & (d2 < self.dist_cutoff ** 2)
        excl, spec = _pair_flags(exclusions, safe_j)
        idx, special, overflow = _compact_rows(
            js, in_range & ~excl, spec, self.max_neighbors, n)
        return Neighbors(idx, special, overflow + cell_overflow, int(step_n))


class _FindSpec(ctypes.Structure):
    """The launchers' spec, field for field csrc/cell_neighbors.cu's
    FindSpec."""

    _fields_ = [("cut2", ctypes.c_double)] + [
        (name, ctypes.c_int) for name in ("n_atoms", "n_cells", "cap",
                                          "k_max")] + [
        ("dims", ctypes.c_int * 3), ("m", ctypes.c_int),
        ("off", (ctypes.c_int * 3) * 27)] + [
        (name, ctypes.c_int) for name in ("f64", "triclinic", "excl_w",
                                          "spec_w")]


_SIG = {"cell_neighbors_launch": [ctypes.c_void_p] * 12}

#: dynamic shared memory a block may hold on an H100 (227 KB), less the
#: kernel's static arrays
_STAGE_BYTES = 232448 - 1024


def _cells(coords, boundary, dims):
    """(each atom's cell along each axis, three (N,) int64 tensors; its
    cell id (N,) int64) from the wrapped fractional coordinates clamped
    below 1. ``dims`` are Python ints, so nothing is copied from the host
    and the caller is not blocked."""
    frac = torch.clamp(boundary.fractional(boundary.wrap(coords)),
                       0.0, 1.0 - 1e-7)
    cells = tuple(torch.clamp(torch.floor(frac[:, k] * d).to(torch.int64),
                              0, d - 1) for k, d in enumerate(dims))
    return cells, (cells[0] * dims[1] + cells[1]) * dims[2] + cells[2]


def _partner_table(pairs, table, dev):
    """(the (N, W) int32 partner table, W) for the kernel; W = 0 without
    pairs, as the twin then skips the test."""
    if pairs.numel() == 0:
        return None, 0
    table = table.to(device=dev, dtype=torch.int32).contiguous()
    return table, int(table.shape[1])


def _find_cuda(finder, coords, boundary, exclusions, step_n):
    """find on a CUDA card: the atoms binned as the twin bins them
    (_cells) and sorted stably by cell in PyTorch, and the table written
    whole by csrc/cell_neighbors.cu's cell_neighbors_kernel, on the
    current stream, with no host read."""
    n = coords.shape[0]
    dev = coords.device
    dtype = coords.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the cell-list kernel takes float32 or float64 "
                        f"coordinates, got {dtype}")
    if n >= 2 ** 31 - 1:
        raise ValueError(f"the cell-list kernel takes fewer than 2^31 - 1 "
                         f"atoms, got {n}")
    dims = tuple(int(d) for d in finder.grid_dims)
    n_cells = int(np.prod(dims))
    cap, k_max = int(finder.cell_capacity), int(finder.max_neighbors)
    offsets = _stencil(dims)
    stage = len(offsets) * cap * (3 * coords.element_size() + 4)
    if stage > _STAGE_BYTES:
        raise ValueError(
            f"cell capacity {cap} stages {stage} bytes of candidates per "
            f"cell ({len(offsets)} stencil cells x {cap} x "
            f"{3 * coords.element_size() + 4} bytes), over the "
            f"{_STAGE_BYTES} bytes of shared memory a block can hold")
    triclinic = getattr(boundary, "basis", None) is not None
    box_a, box_b = boundary.mic_tensors(dtype)
    excl, excl_w = _partner_table(exclusions.excl_i, exclusions.excl_table,
                                  dev)
    spec_t, spec_w = _partner_table(exclusions.spec_i, exclusions.spec_table,
                                    dev)
    spec = _FindSpec(cut2=finder.dist_cutoff ** 2, n_atoms=n,
                     n_cells=n_cells, cap=cap, k_max=k_max, dims=dims,
                     m=len(offsets), f64=int(dtype == torch.float64),
                     triclinic=int(triclinic), excl_w=excl_w, spec_w=spec_w)
    for s, off in enumerate(offsets):
        spec.off[s][:] = [int(o) for o in off]

    coords = coords.detach().contiguous()
    _, cid = _cells(coords, boundary, dims)
    sorted_cid, order = torch.sort(cid.to(torch.int32), stable=True)
    start = torch.searchsorted(
        sorted_cid, torch.arange(n_cells + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    idx = torch.empty((n, k_max), dtype=torch.int32, device=dev)
    special = torch.empty((n, k_max), dtype=torch.bool, device=dev)
    over = torch.zeros((2,), dtype=torch.int32, device=dev)
    native.launch("cell_neighbors", "cell_neighbors_launch", _SIG, spec,
                  coords, box_a, box_b, order, start, excl, spec_t, idx,
                  special, over, device=dev)
    return Neighbors(idx, special, over.sum(dtype=torch.int32), int(step_n))


def find_engine(finder, coords):
    """What computes finder.find on ``coords`` (the ``neighbors.find``
    span's args): the finder's own ``engine(coords)`` where it has one,
    else "torch"."""
    engine = getattr(finder, "engine", None)
    return engine(coords) if engine is not None else "torch"


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
