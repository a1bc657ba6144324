"""Neighbor-list rebuild helpers (counterpart of
mollytpu/ops/neighbors.py:310-334)."""

from __future__ import annotations


def find_neighbors(finder, coords, boundary, exclusions, step_n=0):
    """Build the finder's neighbor structure now (None without a finder)."""
    if finder is None:
        return None
    return finder.find(coords, boundary, exclusions, step_n)
