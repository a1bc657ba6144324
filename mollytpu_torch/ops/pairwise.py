"""Pairwise interaction parameters (counterpart of mollytpu/ops/pairwise.py
for Lennard-Jones and the Coulomb family without alchemical lambda).

These are descriptions, not evaluators: ops/pair_kernel.py turns them into
the pair kernel's spec. Other potentials arrive with later kernel modes.
"""

from __future__ import annotations

import dataclasses
import math

from ..units import COULOMB_CONST
from .cutoffs import NoCutoff
from .mixing import GeometricMixing, LorentzMixing

#: solvent dielectric of the reaction field (mollytpu/ops/pairwise.py:43)
CRF_SOLVENT_DIELECTRIC = 78.3


@dataclasses.dataclass(frozen=True)
class LennardJones:
    """4 eps ((s/r)^12 - (s/r)^6), 1-4 pairs scaled by weight_special."""

    cutoff: object = NoCutoff()
    use_neighbors: bool = False
    sigma_mixing: object = LorentzMixing()
    epsilon_mixing: object = GeometricMixing()
    weight_special: float = 1.0


@dataclasses.dataclass(frozen=True)
class Coulomb:
    """ke q_i q_j / r, 1-4 pairs scaled by weight_special; ``cutoff`` is a
    NoCutoff or a DistanceCutoff."""

    cutoff: object = NoCutoff()
    use_neighbors: bool = False
    weight_special: float = 1.0
    coulomb_const: float = COULOMB_CONST


def rf_constants(dist_cutoff, solvent_dielectric):
    """(krf, crf) of the reaction field (mollytpu/ops/pairwise.py:454)."""
    rc3 = dist_cutoff ** 3
    if math.isinf(solvent_dielectric):
        return 1.0 / (2.0 * rc3), 3.0 / (2.0 * dist_cutoff)
    krf = (1.0 / rc3) * (solvent_dielectric - 1.0) / (
        2.0 * solvent_dielectric + 1.0)
    crf = (1.0 / dist_cutoff) * 3.0 * solvent_dielectric / (
        2.0 * solvent_dielectric + 1.0)
    return krf, crf


@dataclasses.dataclass(frozen=True)
class CoulombReactionField:
    """ke q_i q_j (1/r + krf r^2 - crf) inside dist_cutoff; 1-4 pairs get
    plain Coulomb times weight_special, without the reaction field."""

    dist_cutoff: float = 1.0
    solvent_dielectric: float = CRF_SOLVENT_DIELECTRIC
    use_neighbors: bool = False
    weight_special: float = 1.0
    coulomb_const: float = COULOMB_CONST

    @property
    def krf(self):
        return rf_constants(self.dist_cutoff, self.solvent_dielectric)[0]

    @property
    def crf(self):
        return rf_constants(self.dist_cutoff, self.solvent_dielectric)[1]


def ewald_alpha(dist_cutoff, error_tol=0.0005):
    """alpha = sqrt(-log(2 tol)) / r_c (OpenMM convention)."""
    return math.sqrt(-math.log(2.0 * error_tol)) / dist_cutoff


@dataclasses.dataclass(frozen=True)
class CoulombEwald:
    """Real-space Ewald ke q_i q_j erfc(alpha r) / r; 1-4 pairs get plain
    Coulomb times weight_special (their reciprocal part is removed by
    EwaldExclusionCorrection)."""

    dist_cutoff: float = 1.0
    error_tol: float = 0.0005
    use_neighbors: bool = False
    weight_special: float = 1.0
    coulomb_const: float = COULOMB_CONST
    alpha: float = None

    def __post_init__(self):
        if self.alpha is None:
            object.__setattr__(self, "alpha",
                               ewald_alpha(self.dist_cutoff, self.error_tol))
