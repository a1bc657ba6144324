"""Atom pairs by cell bins, for the plain reference and the physics
count: the orthorhombic box cut into cells at least the cutoff wide, so
that every pair closer than the cutoff lies in one cell or two
neighbouring ones. Each atom's row sees the atoms of its own cell and of
the 26 around it, every other atom pair is left out unseen; with fewer
than three cells across a side, one cell holds every atom. The bins are
worked out from the coordinates alone, in float64, at every call."""

from __future__ import annotations

import itertools

import torch

#: pair slots (cells x capacity x capacity) at a time
BLOCK_PAIRS = 1 << 24


class CellBins:
    """``table``: (cells, capacity) atom indices, ``n`` in empty slots."""

    def __init__(self, x, edges, cutoff):
        x = x.detach().to(torch.float64)
        n, dev = x.shape[0], x.device
        edges = torch.as_tensor(edges, dtype=torch.float64, device=dev)
        dims = [int(float(e) // cutoff) for e in edges]
        if min(dims) < 3:
            dims, self.offsets = [1, 1, 1], [(0, 0, 0)]
        else:
            self.offsets = list(itertools.product((-1, 0, 1), repeat=3))
        self.n, self.dims = n, dims
        d = torch.tensor(dims, dtype=torch.int64, device=dev)
        frac = x / edges
        frac = frac - torch.floor(frac)
        c3 = torch.minimum(torch.floor(frac * d).to(torch.int64), d - 1)
        cid = (c3[:, 0] * dims[1] + c3[:, 1]) * dims[2] + c3[:, 2]
        n_cells = dims[0] * dims[1] * dims[2]
        counts = torch.bincount(cid, minlength=n_cells)
        cap = int(counts.max())
        order = torch.argsort(cid, stable=True)
        first = torch.cumsum(counts, 0) - counts
        slot = torch.arange(n, device=dev) - first[cid[order]]
        table = torch.full((n_cells, cap), n, dtype=torch.int64, device=dev)
        table[cid[order], slot] = order
        self.table = table

    def _shifted(self, cells, off):
        d0, d1, d2 = self.dims
        cx, cy, cz = cells // (d1 * d2), (cells // d2) % d1, cells % d2
        return (((cx + off[0]) % d0) * d1 + (cy + off[1]) % d1) * d2 \
            + (cz + off[2]) % d2

    def blocks(self, block_pairs=BLOCK_PAIRS):
        """Yields (rows, neighbour tables) over blocks of cells: rows the
        block's (cells, capacity) atom indices, and for each neighbouring
        cell's offset the (cells, capacity) indices of that cell's atoms.
        An index of ``n`` is an empty slot."""
        n_cells, cap = self.table.shape
        per = max(1, block_pairs // max(1, cap * cap))
        for s in range(0, n_cells, per):
            cells = torch.arange(s, min(n_cells, s + per),
                                 device=self.table.device)
            yield self.table[cells], (self.table[self._shifted(cells, o)]
                                      for o in self.offsets)


def pair_mask(rows, cols, n):
    """(cells, capacity, capacity): both slots hold atoms, and not the
    same atom."""
    i, j = rows[:, :, None], cols[:, None, :]
    return (i < n) & (j < n) & (i != j)


def padded(x):
    """x with one row of zeros for the empty slots' index ``n``."""
    return torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
