"""The physics count of the nonbonded pair work: the atom pairs that the
inputs put inside the cutoff, counted from the coordinates in an
orthorhombic box (over cell bins at least the cutoff wide,
reference/cells.py), whatever list or kernel the program uses."""

from __future__ import annotations

import torch

from reference.cells import CellBins, padded, pair_mask


def count_pairs(x, edges, cutoff, group, lj):
    """(unordered pairs closer than ``cutoff`` whose atoms lie in different
    ``group``s, those of them whose atoms both have ``lj`` set). ``group``
    holds each atom's molecule (pairs inside one are excluded); an atom's
    own index excludes only the pair with itself."""
    n = x.shape[0]
    edges = torch.as_tensor(edges, dtype=x.dtype, device=x.device)
    rc2 = cutoff * cutoff
    xp, gp, lp = padded(x), padded(group), padded(lj)
    pairs = lj_pairs = 0
    for rows, tables in CellBins(x, edges, cutoff).blocks():
        for cols in tables:
            d = xp[cols][:, None, :, :] - xp[rows][:, :, None, :]
            d = d - edges * torch.round(d / edges)
            inside = (((d * d).sum(-1) < rc2) & pair_mask(rows, cols, n)
                      & (gp[cols][:, None, :] != gp[rows][:, :, None]))
            pairs += int(inside.sum())
            lj_pairs += int((inside & lp[cols][:, None, :]
                             & lp[rows][:, :, None]).sum())
    # every unordered pair was seen from both of its atoms
    return pairs // 2, lj_pairs // 2
