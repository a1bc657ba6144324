"""Cutoff descriptions for pairwise interactions
(counterpart of mollytpu/ops/cutoffs.py). They are tags with a radius: the
pair kernel's spec (ops/pair_kernel.build_fused_spec) maps each onto an
lj_mode, and the kernel and its plain twin evaluate the shifted forms."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class NoCutoff:
    pass


@dataclasses.dataclass(frozen=True)
class DistanceCutoff:
    """Plain truncation: the interaction is zero beyond dist_cutoff (nm)."""

    dist_cutoff: float


@dataclasses.dataclass(frozen=True)
class ShiftedPotentialCutoff:
    """u(r) - u(rc) inside dist_cutoff, zero beyond."""

    dist_cutoff: float


@dataclasses.dataclass(frozen=True)
class ShiftedForceCutoff:
    """u(r) - u(rc) - (r - rc) u'(rc) inside dist_cutoff, zero beyond: both
    energy and force go to zero at the cutoff."""

    dist_cutoff: float
