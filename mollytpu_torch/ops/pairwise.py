"""Pairwise interaction parameters (counterpart of mollytpu/ops/pairwise.py
for Lennard-Jones, the Coulomb family and their alchemical soft-core and
scaled-charge forms), with the JAX package's fields and defaults.

These are descriptions, not evaluators: ops/pair_kernel.py turns them into
the pair kernel's spec. Other potentials arrive with later kernel modes.
"""

from __future__ import annotations

import dataclasses
import math

from ..free_energy.alchemy import DefaultLambdaScheduler
from ..units import COULOMB_CONST
from .cutoffs import NoCutoff
from .mixing import GeometricMixing, LorentzMixing, MinimumMixing

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


# -- alchemical forms: lambda and role come from Atoms.lam / Atoms.alch_role,
# resolved per pair by the scheduler (free_energy/alchemy.py)

@dataclasses.dataclass(frozen=True)
class LennardJonesSoftCoreBeutler:
    """Beutler soft-core LJ: U = l (C12 / R6^2 - C6 / R6),
    R6 = alpha (1 - l) sigma^6 + r^6; LennardJones at l = 1."""

    cutoff: object = NoCutoff()
    alpha: float = 1.0
    use_neighbors: bool = False
    sigma_mixing: object = LorentzMixing()
    epsilon_mixing: object = GeometricMixing()
    lambda_mixing: object = MinimumMixing()
    scheduler: object = DefaultLambdaScheduler()
    weight_special: float = 1.0


@dataclasses.dataclass(frozen=True)
class LennardJonesSoftCoreGapsys:
    """Gapsys linear-quadratic soft-core LJ: the plain potential beyond
    r_LJ = alpha (26 C12 (1 - l) / (7 C6))^(1/6), its quadratic expansion
    about r_LJ inside."""

    cutoff: object = NoCutoff()
    alpha: float = 0.85
    use_neighbors: bool = False
    sigma_mixing: object = LorentzMixing()
    epsilon_mixing: object = GeometricMixing()
    lambda_mixing: object = MinimumMixing()
    scheduler: object = DefaultLambdaScheduler()
    weight_special: float = 1.0


@dataclasses.dataclass(frozen=True)
class CoulombScaled:
    """Coulomb on charges scaled by the scheduler's scale_elec."""

    cutoff: object = NoCutoff()
    use_neighbors: bool = False
    scheduler: object = DefaultLambdaScheduler()
    weight_special: float = 1.0
    coulomb_const: float = COULOMB_CONST


@dataclasses.dataclass(frozen=True)
class CoulombReactionFieldScaled:
    """Reaction field on charges scaled by the scheduler's scale_elec."""

    dist_cutoff: float = 1.0
    solvent_dielectric: float = CRF_SOLVENT_DIELECTRIC
    use_neighbors: bool = False
    scheduler: object = DefaultLambdaScheduler()
    weight_special: float = 1.0
    coulomb_const: float = COULOMB_CONST


@dataclasses.dataclass(frozen=True)
class CoulombSoftCoreBeutler:
    """Beutler soft-core Coulomb: U = l ke q_i q_j / rQ^(1/6),
    rQ = alpha (1 - l) sigma^6 + r^6."""

    cutoff: object = NoCutoff()
    alpha: float = 1.0
    use_neighbors: bool = False
    sigma_mixing: object = LorentzMixing()
    epsilon_mixing: object = GeometricMixing()
    lambda_mixing: object = MinimumMixing()
    scheduler: object = DefaultLambdaScheduler()
    weight_special: float = 1.0
    coulomb_const: float = COULOMB_CONST


@dataclasses.dataclass(frozen=True)
class CoulombSoftCoreGapsys:
    """Gapsys soft-core Coulomb: quadratic inner region below
    r_Q = alpha (1 - l)^(1/6) (1 + sigma_q |q_i q_j|)."""

    cutoff: object = NoCutoff()
    alpha: float = 0.3
    sigma_q: float = 1.0
    use_neighbors: bool = False
    lambda_mixing: object = MinimumMixing()
    scheduler: object = DefaultLambdaScheduler()
    weight_special: float = 1.0
    coulomb_const: float = COULOMB_CONST


def _ewald_alpha_default(inter):
    if inter.alpha is None:
        object.__setattr__(inter, "alpha",
                           ewald_alpha(inter.dist_cutoff, inter.error_tol))


@dataclasses.dataclass(frozen=True)
class CoulombEwaldScaled:
    """Real-space Ewald on charges scaled by the scheduler's scale_elec."""

    dist_cutoff: float = 1.0
    error_tol: float = 0.0005
    use_neighbors: bool = False
    scheduler: object = DefaultLambdaScheduler()
    weight_special: float = 1.0
    coulomb_const: float = COULOMB_CONST
    alpha: float = None
    approximate_erfc: bool = True

    __post_init__ = _ewald_alpha_default


@dataclasses.dataclass(frozen=True)
class CoulombSoftCoreBeutlerEwald:
    """Beutler soft-core real-space Ewald: the 1/r part soft-cored through
    rQ, the erfc screen on the true distance."""

    dist_cutoff: float = 1.0
    error_tol: float = 0.0005
    alpha_sc: float = 1.0
    use_neighbors: bool = False
    sigma_mixing: object = LorentzMixing()
    lambda_mixing: object = MinimumMixing()
    scheduler: object = DefaultLambdaScheduler()
    weight_special: float = 1.0
    coulomb_const: float = COULOMB_CONST
    alpha: float = None
    approximate_erfc: bool = True

    __post_init__ = _ewald_alpha_default


@dataclasses.dataclass(frozen=True)
class CoulombSoftCoreGapsysEwald:
    """Gapsys soft-core real-space Ewald."""

    dist_cutoff: float = 1.0
    error_tol: float = 0.0005
    alpha_sc: float = 0.3
    sigma_q: float = 1.0
    use_neighbors: bool = False
    lambda_mixing: object = MinimumMixing()
    scheduler: object = DefaultLambdaScheduler()
    weight_special: float = 1.0
    coulomb_const: float = COULOMB_CONST
    alpha: float = None
    approximate_erfc: bool = True

    __post_init__ = _ewald_alpha_default


@dataclasses.dataclass(frozen=True)
class CoulombSoftCoreBeutlerReactionField:
    """Beutler soft-core 1/r plus the lambda-scaled reaction-field terms.
    Not a mode of the pair kernel (nor of the TPU kernel)."""

    dist_cutoff: float = 1.0
    solvent_dielectric: float = CRF_SOLVENT_DIELECTRIC
    alpha: float = 1.0
    use_neighbors: bool = False
    sigma_mixing: object = LorentzMixing()
    lambda_mixing: object = MinimumMixing()
    scheduler: object = DefaultLambdaScheduler()
    weight_special: float = 1.0
    coulomb_const: float = COULOMB_CONST


@dataclasses.dataclass(frozen=True)
class CoulombSoftCoreGapsysReactionField:
    """Gapsys soft-core 1/r plus the lambda-scaled reaction-field terms.
    Not a mode of the pair kernel (nor of the TPU kernel)."""

    dist_cutoff: float = 1.0
    solvent_dielectric: float = CRF_SOLVENT_DIELECTRIC
    alpha: float = 0.3
    sigma_q: float = 1.0
    use_neighbors: bool = False
    lambda_mixing: object = MinimumMixing()
    scheduler: object = DefaultLambdaScheduler()
    weight_special: float = 1.0
    coulomb_const: float = COULOMB_CONST
