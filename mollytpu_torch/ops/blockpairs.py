"""Cluster-pair list feeding the pair kernel
(counterpart of mollytpu/ops/blockpairs.py::BlockPairFinder, laid out for
a GPU warp instead of the TPU's 128-lane tiles).

At each rebuild, atoms are sorted along a grid-binned serpentine curve (in
fractional coordinates) and cut into clusters of 32 consecutive sorted
atoms (one warp), the last one padded with sentinel ids (= N). Cluster
pairs (I, J >= I) whose minimum-image AABB gap is below the list radius
(cutoff + skin) are listed once each (half orientation). The per-atom rows
the kernel reads are packed once per rebuild; between rebuilds only the
coordinates are gathered.

The gap is a lower bound on the distance of any atom of one cluster to any
of the other. Only cluster pairs whose centers lie in one cell or two
neighbouring ones of a grid of cluster centers are measured, the grid's
cells wide enough that every pair with a gap below the radius is among
them (one cell holding every cluster in a small box), so that the work and
memory grow with the clusters and not with their square. In an orthorhombic box it is the Cartesian AABB gap under
per-axis minimum image. In a triclinic box the axes of the minimum image
are coupled, so a Cartesian gap is no bound; there the AABBs are taken in
fractional coordinates, and |f_k| w_k <= |dr| along each fractional axis k
(w_k the perpendicular width) makes max_k gap_k w_k the bound
(mollytpu/ops/blockpairs.py:511-540).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ..boundary import mic_displacement

#: atoms per cluster: one warp of the pair kernel
CLUSTER = 32


@dataclasses.dataclass(frozen=True)
class BlockPairs:
    """One rebuild's list and packed rows, all on the coordinates' device."""

    ids: torch.Tensor       # (n_pad,) int32 atom id per sorted slot, N = pad
    src: torch.Tensor       # (n_pad,) int64 atom whose coordinates fill the
                            # slot (padding repeats the last sorted atom)
    pos4: torch.Tensor      # (n_pad, 4) x, y, z, charge; x, y, z refilled
                            # every step, charge packed at rebuild (0 = pad)
    lj2: torch.Tensor       # (n_pad, 2) sigma, sqrt(epsilon); 0 for padding
    bits: torch.Tensor      # (n_pad, 4) int32 excl w0, w1, spec w0, w1 of
                            # the slot's atom (system.Exclusions bitmaps)
    pairs: torch.Tensor     # (P, 2) int32 cluster pairs (I, J), I <= J,
                            # sorted by I then J: those whose AABB gap at
                            # this rebuild is below the list radius
    coords_built: torch.Tensor  # (N, 3) wrapped coordinates at this rebuild
    list_radius: float = 0.0
    step_built: int = 0

    @property
    def n_pairs(self) -> int:
        return int(self.pairs.shape[0])

    @property
    def n_clusters(self) -> int:
        return int(self.ids.shape[0]) // CLUSTER


@dataclasses.dataclass(frozen=True)
class BlockPairFinder:
    """Static configuration of the cluster-pair build.

    dist_cutoff is the list radius (interaction cutoff + skin). atom_static
    is the (N, 3) [sigma, sqrt(epsilon), charge] snapshot packed into the
    kernel rows at every rebuild. The sort grid and the half-width check
    are sized for the setup box, whose perpendicular widths are
    ``ref_sides``; under a barostat, a box that drifts more than
    ``resetup_drift`` (relative, any axis) from them is set up anew between
    chunks (sim.simulate.npt_resetup; mollytpu/ops/blockpairs.py:232-247)."""

    dist_cutoff: float
    atom_static: torch.Tensor
    sort_dims: tuple = (1, 1, 1)
    n_steps: int = 1
    ref_sides: tuple = None
    resetup_drift: float = 0.05

    @classmethod
    def setup(cls, boundary, dist_cutoff, n_atoms, atoms, n_steps=1,
              block=CLUSTER, lanes=None):
        """Size the sort grid for ~CLUSTER/2 atoms per cell and check that
        the per-pair minimum image of the kernel is valid: every periodic
        perpendicular width (the side of an orthorhombic box) must exceed
        twice the list radius. ``block`` and ``lanes`` are the JAX
        package's Pallas tile shape (ops/autotune.py), taken so that its
        calls replay: the pair kernel's cluster is one warp, so ``block``
        must be CLUSTER; ``lanes`` has no meaning on the card and is not
        kept."""
        if block != CLUSTER:
            raise ValueError(
                f"block={block}: the pair kernel evaluates {CLUSTER} x "
                f"{CLUSTER} cluster pairs, one warp per pair, so its block "
                f"is {CLUSTER} atoms")
        sides = boundary.perp_widths()
        for s in sides:
            if math.isfinite(s) and s / 2.0 <= dist_cutoff:
                raise ValueError(
                    f"box width {s} nm is too small for a {dist_cutoff} nm "
                    "list radius: the pair kernel's minimum image needs "
                    "side/2 > cutoff + skin (perpendicular widths in a "
                    "triclinic box)")
        vol = float(boundary.volume())
        if math.isfinite(vol) and vol > 0:
            a_sort = (0.5 * CLUSTER * vol / n_atoms) ** (1.0 / 3.0)
            sort_dims = tuple(int(min(1024, max(1, round(s / a_sort))))
                              if math.isfinite(s) else 1 for s in sides)
        else:
            sort_dims = (1, 1, 1)
        atom_static = torch.stack([atoms.sigma, torch.sqrt(atoms.epsilon),
                                   atoms.charge], dim=1)
        return cls(dist_cutoff=float(dist_cutoff), atom_static=atom_static,
                   sort_dims=sort_dims, n_steps=int(n_steps),
                   ref_sides=tuple(sides))

    def box_drift_exceeded(self, boundary):
        """Host-side check between chunks: has a periodic perpendicular
        width moved more than ``resetup_drift`` from the setup box's
        (mollytpu/ops/blockpairs.py:266-277)?"""
        if self.ref_sides is None:
            return False
        return any(abs(cur / ref - 1.0) > self.resetup_drift
                   for cur, ref in zip(boundary.perp_widths(), self.ref_sides)
                   if math.isfinite(cur) and math.isfinite(ref))

    def resetup(self, boundary, n_atoms, atoms):
        """A finder set up for the current box, same list radius and
        cadence (mollytpu/ops/blockpairs.py:279-287). ``setup`` checks the
        half-width condition again and raises if a compressed box breaks
        it."""
        return type(self).setup(boundary, self.dist_cutoff, n_atoms, atoms,
                                n_steps=self.n_steps)

    def _sort_order(self, wrapped, boundary):
        """Serpentine cell order, then position along the last axis within
        the cell in the direction the cell column is traversed."""
        frac = torch.clamp(boundary.fractional(wrapped), 0.0, 1.0 - 1e-7)
        dims = self.sort_dims
        # the grid as Python ints: no host-to-device copy
        q = [torch.clamp((frac[:, k] * float(dims[k])).to(torch.int64),
                         max=dims[k] - 1) for k in range(3)]
        rank = q[0]
        last_flip = torch.zeros_like(rank, dtype=torch.bool)
        for k in (1, 2):
            flip = (rank & 1) == 1
            qk = torch.where(flip, dims[k] - 1 - q[k], q[k])
            last_flip = flip
            rank = rank * dims[k] + qk
        zq = torch.clamp((frac[:, 2] * 1024.0).to(torch.int64), max=1023)
        zq = torch.where(last_flip, 1023 - zq, zq)
        return torch.argsort(rank * 1024 + zq, stable=True)

    def find(self, coords, boundary, exclusions, step_n=0):
        n = coords.shape[0]
        dev = coords.device
        n_pad = -(-n // CLUSTER) * CLUSTER
        wrapped = boundary.wrap(coords)
        order = self._sort_order(wrapped, boundary)
        pad = n_pad - n
        ids = torch.cat([order, torch.full((pad,), n, dtype=order.dtype,
                                           device=dev)])
        src = torch.cat([order, order[-1:].expand(pad)])
        real = ids < n

        # per-cluster AABBs; padding rows repeat a real atom of the cluster
        # so they never stretch a box
        centers, exts = _cluster_boxes(wrapped[src].view(-1, CLUSTER, 3),
                                       boundary)
        n_cl = centers.shape[0]
        blocks, near = [], []
        for rows, cand, gap in _candidate_gaps(centers, exts, boundary,
                                               self.dist_cutoff):
            blocks.append(cand)
            near.append(gap < self.dist_cutoff)
        ci, cj = _pairs_of(blocks, near)
        keys = torch.sort(ci * n_cl + cj)[0]
        pairs = torch.stack([keys // n_cl, keys % n_cl], dim=1).to(
            torch.int32).contiguous()

        stat = self.atom_static[src].to(coords.dtype)
        stat = torch.where(real[:, None], stat, torch.zeros_like(stat))
        pos4 = torch.empty((n_pad, 4), dtype=coords.dtype, device=dev)
        pos4[:, :3] = coords[src]
        pos4[:, 3] = stat[:, 2]
        lj2 = stat[:, :2].contiguous()
        bits4 = torch.cat([exclusions.excl_bits, exclusions.spec_bits],
                          dim=1).to(dev)                     # (N + 1, 4)
        bits = bits4[ids].contiguous()
        return BlockPairs(ids=ids.to(torch.int32).contiguous(), src=src,
                          pos4=pos4, lj2=lj2, bits=bits, pairs=pairs,
                          coords_built=wrapped,
                          list_radius=self.dist_cutoff,
                          step_built=int(step_n))


#: candidate cluster pairs whose gaps are worked out at a time (each block
#: costs ~40 launches; at 512,000 waters about 2 blocks, a few GB)
BLOCK_CANDIDATES = 1 << 26


def _triclinic(boundary):
    return getattr(boundary, "basis", None) is not None


def _cluster_boxes(x, boundary):
    """(centers, half extents), each (C, 3), of the AABBs of clusters x
    (C, 32, 3): Cartesian in an orthorhombic box, fractional in a
    triclinic one."""
    if _triclinic(boundary):
        x = boundary.fractional(x)
    lo, hi = x.amin(dim=1), x.amax(dim=1)
    return 0.5 * (lo + hi), 0.5 * (hi - lo)


def _pair_gaps(centers, exts, boundary, ci, cj):
    """Minimum-image gaps between the AABBs of clusters ci and cj: a lower
    bound on the distance of any atom of one to any of the other."""
    if _triclinic(boundary):
        dc = centers[cj] - centers[ci]
        dc = dc - torch.round(dc)
        widths = torch.tensor(boundary.perp_widths(), dtype=centers.dtype,
                              device=centers.device)
        return (torch.clamp(dc.abs() - (exts[cj] + exts[ci]), min=0.0)
                * widths).amax(dim=-1)
    dc = boundary.displacement(centers[ci], centers[cj])
    return torch.linalg.vector_norm(torch.clamp(
        dc.abs() - (exts[cj] + exts[ci]), min=0.0), dim=-1)


def _cluster_grid(centers, exts, boundary, radius):
    """The cells along each axis of a grid of cluster centers in which
    every cluster pair with a gap below ``radius`` lies in one cell or two
    neighbouring ones (1 along an axis with fewer than 3 such cells), and
    each center's fractional coordinates. Along fractional axis k of
    perpendicular width w_k, centers two cells apart are more than 1 / n_k
    apart, so their gap is above (1 / n_k - 2 e_k) w_k, e_k the largest
    fractional half extent: n_k = floor(1 / (radius / w_k + 2 e_k))."""
    widths = boundary.perp_widths()
    if _triclinic(boundary):
        frac, efrac = centers, exts
    else:
        sides = torch.tensor(widths, dtype=centers.dtype,
                             device=centers.device)
        frac, efrac = centers / sides, exts / sides
    e_max = efrac.amax(dim=0).tolist()
    dims = []
    for w, e in zip(widths, e_max):
        n = (int(1.0 / (radius / w + 2.0 * e))
             if math.isfinite(w) and radius / w + 2.0 * e > 0 else 1)
        dims.append(n if n >= 3 else 1)
    return dims, frac - torch.floor(frac)


@functools.lru_cache(maxsize=16)
def _stencil_cells(dims, device):
    """(cells, 27) ids of each cell of a ``dims`` grid and of its
    neighbours (27 in every direction; one along an axis of one cell),
    built once per grid and device: a rebuild's grid is mostly the last
    one's, and building it is ~270 small launches."""
    offs = [range(-1, 2) if n > 1 else range(1) for n in dims]
    cells = torch.arange(dims[0] * dims[1] * dims[2], device=device)
    cx, cy, cz = (cells // (dims[1] * dims[2]), (cells // dims[2]) % dims[1],
                  cells % dims[2])
    return torch.stack([
        (((cx + a) % dims[0]) * dims[1] + (cy + b) % dims[1]) * dims[2]
        + (cz + c) % dims[2]
        for a in offs[0] for b in offs[1] for c in offs[2]], dim=1)


def _candidate_gaps(centers, exts, boundary, radius, grid=None):
    """Yields (rows, cand, gaps) over blocks of row clusters, in order:
    ``cand`` (rows, width) the clusters of each row's own cell and of the
    neighbouring cells of ``_cluster_grid`` (``grid``, or worked out here;
    every cluster where the grid is one cell), the number of clusters in
    empty slots; ``gaps`` their AABB gaps, inf in empty slots and for a
    candidate below its row (each pair once, ci <= cj). Every pair whose
    gap is below ``radius`` is among them. Nothing is read on the host
    past the grid's shape and the count of its fullest cell."""
    n_cl, dev = centers.shape[0], centers.device
    dims, frac = grid or _cluster_grid(centers, exts, boundary, radius)
    c3 = [torch.clamp((frac[:, k] * float(dims[k])).to(torch.int64),
                      max=dims[k] - 1) for k in range(3)]
    cid = (c3[0] * dims[1] + c3[1]) * dims[2] + c3[2]
    n_cells = dims[0] * dims[1] * dims[2]
    counts = torch.bincount(cid, minlength=n_cells)
    cap = int(counts.max())
    order = torch.argsort(cid, stable=True)
    slot = torch.arange(n_cl, device=dev) - (torch.cumsum(counts, 0)
                                             - counts)[cid[order]]
    table = torch.full((n_cells, cap), n_cl, dtype=torch.int64, device=dev)
    table[cid[order], slot] = order
    around = _stencil_cells(tuple(dims), dev)
    width = around.shape[1] * cap
    step = max(1, BLOCK_CANDIDATES // width)
    for s in range(0, n_cl, step):
        rows = torch.arange(s, min(n_cl, s + step), device=dev)
        cand = table[around[cid[rows]]].reshape(rows.shape[0], width)
        ci = rows[:, None]
        gap = _pair_gaps(centers, exts, boundary, ci,
                         torch.clamp(cand, max=n_cl - 1))
        yield rows, cand, torch.where((cand < n_cl) & (cand >= ci), gap,
                                      torch.full_like(gap, float("inf")))


def _pairs_of(cands, near):
    """(ci, cj) of the slots ``near`` marks in the blocks' ``cand``, which
    hold every row cluster in order: one host read."""
    ci, slot = torch.nonzero(torch.cat(near), as_tuple=True)
    return ci, torch.cat(cands)[ci, slot]


def unlisted_min_distance(blockpairs, coords, boundary, cutoff):
    """Smallest distance (nm) between two atoms of an unlisted cluster pair
    at ``coords``, as a device scalar: exact when it is below ``cutoff``,
    otherwise a lower bound that is at least ``cutoff``. Below the cutoff,
    a force evaluation on this list at these coordinates missed a pair.

    The clusters of the build are boxed at their current positions; only
    unlisted pairs whose boxes now come within the cutoff are checked atom
    by atom."""
    n = coords.shape[0]
    # positions continuous with the build frame (no periodic jumps)
    cont = blockpairs.coords_built + boundary.displacement(
        blockpairs.coords_built, coords)
    x = cont[blockpairs.src].view(-1, CLUSTER, 3)
    centers, exts = _cluster_boxes(x, boundary)
    n_cl = centers.shape[0]
    pairs = blockpairs.pairs.to(torch.int64)
    listed = pairs[:, 0] * n_cl + pairs[:, 1]          # sorted ascending
    inf = torch.full((), float("inf"), dtype=coords.dtype,
                     device=coords.device)
    grid = _cluster_grid(centers, exts, boundary, cutoff)
    # pairs outside the grid's neighbouring cells lie beyond the cutoff
    bound = inf if grid[0] == [1, 1, 1] else inf.new_full((), cutoff)
    blocks, near = [], []
    for rows, cand, gap in _candidate_gaps(centers, exts, boundary, cutoff,
                                           grid):
        key = rows[:, None] * n_cl + cand
        pos = torch.clamp(torch.searchsorted(listed, key),
                          max=listed.numel() - 1)
        gap = torch.where(listed[pos] == key, inf, gap)
        close = gap < cutoff
        bound = torch.minimum(bound, torch.where(close, inf, gap).amin())
        blocks.append(cand)
        near.append(close)
    ci, cj = _pairs_of(blocks, near)
    if ci.shape[0] == 0:
        return bound
    # the kernel's own minimum image: the distance the kernel would see
    d = torch.linalg.vector_norm(mic_displacement(
        boundary, x[ci][:, :, None, :], x[cj][:, None, :, :]), dim=-1)
    ids = blockpairs.ids.view(-1, CLUSTER)
    real = (ids[ci] < n)[:, :, None] & (ids[cj] < n)[:, None, :]
    return torch.minimum(bound, torch.where(real, d, torch.full_like(
        d, float("inf"))).amin())
