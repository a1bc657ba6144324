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
of the other. In an orthorhombic box it is the Cartesian AABB gap under
per-axis minimum image. In a triclinic box the axes of the minimum image
are coupled, so a Cartesian gap is no bound; there the AABBs are taken in
fractional coordinates, and |f_k| w_k <= |dr| along each fractional axis k
(w_k the perpendicular width) makes max_k gap_k w_k the bound
(mollytpu/ops/blockpairs.py:511-540).
"""

from __future__ import annotations

import dataclasses
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
                            # sorted by I then J
    gap: torch.Tensor       # (C, C) AABB gaps at this rebuild; pairs with
                            # gap >= the list radius are the unlisted ones
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
        dims = torch.tensor(self.sort_dims, dtype=torch.int64,
                            device=wrapped.device)
        q = torch.minimum((frac * dims.to(frac.dtype)).to(torch.int64),
                          dims - 1)
        rank = q[:, 0]
        last_flip = torch.zeros_like(rank, dtype=torch.bool)
        for k in (1, 2):
            flip = (rank & 1) == 1
            qk = torch.where(flip, dims[k] - 1 - q[:, k], q[:, k])
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
        gap = _aabb_gaps(wrapped[src].view(-1, CLUSTER, 3), boundary)
        near = gap < self.dist_cutoff
        pairs = torch.nonzero(torch.triu(near)).to(torch.int32).contiguous()

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
                          gap=gap, coords_built=wrapped,
                          list_radius=self.dist_cutoff,
                          step_built=int(step_n))


def _aabb_gaps(x, boundary):
    """(C, C) minimum-image gaps between the AABBs of clusters x (C, 32, 3):
    a lower bound on the distance of any atom of one to any of the other."""
    if getattr(boundary, "basis", None) is not None:
        f = boundary.fractional(x)
        lo, hi = f.amin(dim=1), f.amax(dim=1)
        centers, exts = 0.5 * (lo + hi), 0.5 * (hi - lo)
        dc = centers[None, :, :] - centers[:, None, :]
        dc = dc - torch.round(dc)
        widths = torch.tensor(boundary.perp_widths(), dtype=x.dtype,
                              device=x.device)
        return (torch.clamp(dc.abs() - (exts[None, :, :] + exts[:, None, :]),
                            min=0.0) * widths).amax(dim=2)
    lo, hi = x.amin(dim=1), x.amax(dim=1)
    centers, exts = 0.5 * (lo + hi), 0.5 * (hi - lo)
    dc = boundary.displacement(centers[:, None, :], centers[None, :, :])
    return torch.linalg.vector_norm(torch.clamp(
        dc.abs() - (exts[None, :, :] + exts[:, None, :]), min=0.0), dim=2)


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
    gap = _aabb_gaps(x, boundary)
    unlisted = blockpairs.gap >= blockpairs.list_radius
    inf = torch.full_like(gap, float("inf"))
    gap = torch.where(unlisted, gap, inf)
    near = gap < cutoff
    bound = torch.where(near, inf, gap).amin()
    cand = torch.nonzero(torch.triu(near))
    if cand.shape[0] == 0:
        return bound
    ci, cj = cand.unbind(dim=1)
    # the kernel's own minimum image: the distance the kernel would see
    d = torch.linalg.vector_norm(mic_displacement(
        boundary, x[ci][:, :, None, :], x[cj][:, None, :, :]), dim=-1)
    ids = blockpairs.ids.view(-1, CLUSTER)
    real = (ids[ci] < n)[:, :, None] & (ids[cj] < n)[:, None, :]
    return torch.minimum(bound, torch.where(real, d, torch.full_like(
        d, float("inf"))).amin())
