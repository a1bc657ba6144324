"""Cutoff descriptions for pairwise interactions
(counterpart of mollytpu/ops/cutoffs.py). The port's pair kernel reads
them; shifted and switched cutoffs come with the kernel's other modes."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class NoCutoff:
    pass


@dataclasses.dataclass(frozen=True)
class DistanceCutoff:
    """Plain truncation: the interaction is zero beyond dist_cutoff (nm)."""

    dist_cutoff: float
