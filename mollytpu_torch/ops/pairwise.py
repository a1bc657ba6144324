"""Pairwise interactions (counterpart of mollytpu/ops/pairwise.py), with the
JAX package's fields and defaults.

Each interaction is a frozen dataclass with one method

    energy(r, ai, aj, special) -> kJ/mol per pair

over broadcast tensors: ``r`` the minimum-image distance (the engine keeps
it > 0 on live pairs), ``ai`` / ``aj`` per-atom parameter views (Atoms
whose tensors broadcast against r) and ``special`` the 1-4 flags. The
general engines (ops/nonbonded.py) take forces from the derivative of the
summed energy; the pair kernel (ops/pair_kernel.py) reads the fields of
LJ, the Coulomb family and their soft-core and scaled-charge forms as its
spec. DPDInteraction is velocity-dependent: its ``force_vec`` gives the
pair force directly.

Every branch is ``torch.where`` with both operands kept finite (JAX's
safe-where rule), so the derivative of a masked lane is never NaN.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..free_energy.alchemy import (DefaultLambdaScheduler, elec_lambda,
                                   scaled_charge, sterics_lambda)
from ..units import COULOMB_CONST
from .cutoffs import NoCutoff, cutoff_distance
from .mixing import (GeometricMixing, LorentzMixing, MinimumMixing,
                     mix_epsilon, mix_lambda, mix_sigma)

#: solvent dielectric of the reaction field (mollytpu/ops/pairwise.py:43)
CRF_SOLVENT_DIELECTRIC = 78.3


def _lam(a):
    return 1.0 if a.lam is None else a.lam


def _role(a):
    if a.alch_role is None:
        return torch.zeros_like(a.charge, dtype=torch.int32)
    return a.alch_role


def _weighted(e, special, weight):
    """e times weight on 1-4 pairs (JAX: e * where(special, weight, 1))."""
    return torch.where(special, e * weight, e)


def _lj_shortcut(ai, aj):
    """Pairs with a zero sigma, epsilon or lambda do not interact."""
    ok = ((ai.epsilon != 0) & (aj.epsilon != 0) & (ai.sigma != 0)
          & (aj.sigma != 0))
    li, lj = _lam(ai), _lam(aj)
    return ok & (li != 0) & (lj != 0)


def _safe_fracpow(x, p):
    """x ** p (0 < p < 1, x >= 0) with a zero derivative at x = 0, where
    x ** p's is infinite."""
    pos = x > 0
    return torch.where(pos, torch.where(pos, x, 1.0) ** p, 0.0)


def _max(x, floor):
    """jnp.maximum(x, floor), tie derivative included."""
    return torch.maximum(x, x.new_full((), floor))


# -- Lennard-Jones family

@dataclasses.dataclass(frozen=True)
class LennardJones:
    """4 eps ((s/r)^12 - (s/r)^6), 1-4 pairs scaled by weight_special."""

    cutoff: object = NoCutoff()
    use_neighbors: bool = False
    sigma_mixing: object = LorentzMixing()
    epsilon_mixing: object = GeometricMixing()
    weight_special: float = 1.0

    def energy(self, r, ai, aj, special):
        sig = mix_sigma(self.sigma_mixing, ai, aj)
        eps = mix_epsilon(self.epsilon_mixing, ai, aj)

        def u(rr):
            six = (sig / rr) ** 6
            return 4.0 * eps * (six * six - six)

        e = torch.where(_lj_shortcut(ai, aj), self.cutoff.apply(u, r), 0.0)
        return _weighted(e, special, self.weight_special)


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

    def energy(self, r, ai, aj, special):
        lam = sterics_lambda(self.scheduler,
                             mix_lambda(self.lambda_mixing, ai, aj),
                             _role(ai), _role(aj))
        sig = mix_sigma(self.sigma_mixing, ai, aj)
        eps = mix_epsilon(self.epsilon_mixing, ai, aj)
        sig6 = sig ** 6
        c6 = 4.0 * eps * sig6
        c12 = c6 * sig6
        shift = self.alpha * (1.0 - lam) * sig6

        def u(rr):
            r6 = _max(shift + rr ** 6, 1e-12)
            return lam * (c12 / (r6 * r6) - c6 / r6)

        e = torch.where(_lj_shortcut(ai, aj) & (lam > 0),
                        self.cutoff.apply(u, r), 0.0)
        return _weighted(e, special, self.weight_special)


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

    def energy(self, r, ai, aj, special):
        lam = sterics_lambda(self.scheduler,
                             mix_lambda(self.lambda_mixing, ai, aj),
                             _role(ai), _role(aj))
        sig = mix_sigma(self.sigma_mixing, ai, aj)
        eps = mix_epsilon(self.epsilon_mixing, ai, aj)
        sig6 = sig ** 6
        c6 = 4.0 * eps * sig6
        c12 = c6 * sig6
        ratio = torch.where(c6 > 0, 26.0 * c12 * (1.0 - lam)
                            / (7.0 * _max(c6, 1e-30)), 0.0)
        r_lj = self.alpha * _safe_fracpow(ratio, 1.0 / 6.0)

        def u(rr):
            outer = c12 / rr ** 12 - c6 / rr ** 6
            rs = _max(r_lj, 1e-6)
            inner = ((78.0 * c12 / rs ** 14 - 21.0 * c6 / rs ** 8) * rr ** 2
                     - (168.0 * c12 / rs ** 13 - 48.0 * c6 / rs ** 7) * rr
                     + 91.0 * c12 / rs ** 12 - 28.0 * c6 / rs ** 6)
            return lam * torch.where(rr >= r_lj, outer, inner)

        e = torch.where(_lj_shortcut(ai, aj) & (lam > 0),
                        self.cutoff.apply(u, r), 0.0)
        return _weighted(e, special, self.weight_special)


@dataclasses.dataclass(frozen=True)
class AshbaughHatch:
    """Lambda-weighted LJ of coarse-grained disordered-protein models:
    V_LJ + eps (1 - l) below the minimum, l V_LJ above."""

    cutoff: object = NoCutoff()
    use_neighbors: bool = False
    sigma_mixing: object = LorentzMixing()
    epsilon_mixing: object = GeometricMixing()
    lambda_mixing: object = LorentzMixing()
    weight_special: float = 1.0

    def energy(self, r, ai, aj, special):
        sig = mix_sigma(self.sigma_mixing, ai, aj)
        eps = mix_epsilon(self.epsilon_mixing, ai, aj)
        lam = mix_lambda(self.lambda_mixing, ai, aj)
        r_min = 2.0 ** (1.0 / 6.0) * sig

        def u(rr):
            six = (sig / rr) ** 6
            vlj = 4.0 * eps * (six * six - six)
            return torch.where(rr <= r_min, vlj + eps * (1.0 - lam),
                               lam * vlj)

        e = torch.where((ai.epsilon != 0) & (aj.epsilon != 0),
                        self.cutoff.apply(u, r), 0.0)
        return _weighted(e, special, self.weight_special)


@dataclasses.dataclass(frozen=True)
class SoftSphere:
    """4 eps (s/r)^12."""

    cutoff: object = NoCutoff()
    use_neighbors: bool = False
    sigma_mixing: object = LorentzMixing()
    epsilon_mixing: object = GeometricMixing()

    def energy(self, r, ai, aj, special):
        sig = mix_sigma(self.sigma_mixing, ai, aj)
        eps = mix_epsilon(self.epsilon_mixing, ai, aj)

        def u(rr):
            return 4.0 * eps * (sig / rr) ** 12

        return torch.where(_lj_shortcut(ai, aj), self.cutoff.apply(u, r),
                           0.0)


@dataclasses.dataclass(frozen=True)
class Mie:
    """The generalized (m, n) Mie potential
    C eps ((s/r)^n - (s/r)^m), C = n/(n-m) (n/m)^(m/(n-m))."""

    m: float = 6.0
    n: float = 12.0
    cutoff: object = NoCutoff()
    use_neighbors: bool = False
    sigma_mixing: object = LorentzMixing()
    epsilon_mixing: object = GeometricMixing()
    weight_special: float = 1.0

    def energy(self, r, ai, aj, special):
        m, n = self.m, self.n
        c = (n / (n - m)) * (n / m) ** (m / (n - m))
        sig = mix_sigma(self.sigma_mixing, ai, aj)
        eps = mix_epsilon(self.epsilon_mixing, ai, aj)

        def u(rr):
            s = sig / rr
            return c * eps * (s ** n - s ** m)

        e = torch.where(_lj_shortcut(ai, aj), self.cutoff.apply(u, r), 0.0)
        return _weighted(e, special, self.weight_special)


@dataclasses.dataclass(frozen=True)
class Buckingham:
    """A exp(-B r) - C / r^6 from the per-atom Atoms.buck_A / buck_B /
    buck_C: A and C mixed geometrically, B harmonically."""

    cutoff: object = NoCutoff()
    use_neighbors: bool = False
    weight_special: float = 1.0

    def energy(self, r, ai, aj, special):
        A = torch.sqrt(ai.buck_A * aj.buck_A)
        B = 2.0 / (1.0 / torch.clamp(ai.buck_B, min=1e-30)
                   + 1.0 / torch.clamp(aj.buck_B, min=1e-30))
        C = torch.sqrt(ai.buck_C * aj.buck_C)

        def u(rr):
            return A * torch.exp(-B * rr) - C / rr ** 6

        live = (((ai.buck_A != 0) & (aj.buck_A != 0))
                | ((ai.buck_C != 0) & (aj.buck_C != 0)))
        e = torch.where(live, self.cutoff.apply(u, r), 0.0)
        return _weighted(e, special, self.weight_special)


@dataclasses.dataclass(frozen=True)
class DoubleExponential:
    """eps (b e^a / (a - b) e^(-a r / r_m) - a e^b / (a - b) e^(-b r / r_m)),
    r_m = 2^(1/6) sigma."""

    alpha: float
    beta: float
    cutoff: object = NoCutoff()
    use_neighbors: bool = False
    sigma_mixing: object = LorentzMixing()
    epsilon_mixing: object = GeometricMixing()
    weight_special: float = 1.0

    def energy(self, r, ai, aj, special):
        a, b = self.alpha, self.beta
        sig = mix_sigma(self.sigma_mixing, ai, aj)
        eps = mix_epsilon(self.epsilon_mixing, ai, aj)
        rm = 2.0 ** (1.0 / 6.0) * sig

        def u(rr):
            rm_s = _max(rm, 1e-12)
            ea = math.exp(a) * b / (a - b) * torch.exp(-a * rr / rm_s)
            eb = math.exp(b) * a / (a - b) * torch.exp(-b * rr / rm_s)
            return eps * (ea - eb)

        e = torch.where(_lj_shortcut(ai, aj), self.cutoff.apply(u, r), 0.0)
        return _weighted(e, special, self.weight_special)


@dataclasses.dataclass(frozen=True)
class DoubleExponentialSoftCore:
    """The double exponential with lambda scaling its depth and reshaping
    its exponents: alpha_s = 1.1 + l (alpha - 1.1),
    beta_s = 1 + l (beta - 1)."""

    alpha: float
    beta: float
    cutoff: object = NoCutoff()
    use_neighbors: bool = False
    sigma_mixing: object = LorentzMixing()
    epsilon_mixing: object = GeometricMixing()
    lambda_mixing: object = MinimumMixing()
    scheduler: object = DefaultLambdaScheduler()
    weight_special: float = 1.0

    def energy(self, r, ai, aj, special):
        lam = sterics_lambda(self.scheduler,
                             mix_lambda(self.lambda_mixing, ai, aj),
                             _role(ai), _role(aj))
        a_s = 1.1 + lam * (self.alpha - 1.1)
        b_s = 1.0 + lam * (self.beta - 1.0)
        sig = mix_sigma(self.sigma_mixing, ai, aj)
        eps = mix_epsilon(self.epsilon_mixing, ai, aj)
        rm = 2.0 ** (1.0 / 6.0) * sig

        def u(rr):
            rm_s = _max(rm, 1e-12)
            denom = torch.where(torch.abs(a_s - b_s) > 1e-9, a_s - b_s, 1e-9)
            ea = torch.exp(a_s) * b_s / denom * torch.exp(-a_s * rr / rm_s)
            eb = torch.exp(b_s) * a_s / denom * torch.exp(-b_s * rr / rm_s)
            return lam * eps * (ea - eb)

        e = torch.where(_lj_shortcut(ai, aj) & (lam > 0),
                        self.cutoff.apply(u, r), 0.0)
        return _weighted(e, special, self.weight_special)


@dataclasses.dataclass(frozen=True)
class Gravity:
    """-G m_i m_j / r, G in internal units."""

    G: float = 1.0
    cutoff: object = NoCutoff()
    use_neighbors: bool = False

    def energy(self, r, ai, aj, special):
        def u(rr):
            return -self.G * ai.mass * aj.mass / rr

        return self.cutoff.apply(u, r)


# -- Coulomb family

@dataclasses.dataclass(frozen=True)
class Coulomb:
    """ke q_i q_j / r, 1-4 pairs scaled by weight_special."""

    cutoff: object = NoCutoff()
    use_neighbors: bool = False
    weight_special: float = 1.0
    coulomb_const: float = COULOMB_CONST

    def energy(self, r, ai, aj, special):
        ke = self.coulomb_const
        qq = ai.charge * aj.charge

        def u(rr):
            return ke * qq / rr

        return _weighted(self.cutoff.apply(u, r), special,
                         self.weight_special)


@dataclasses.dataclass(frozen=True)
class CoulombScaled:
    """Coulomb on charges scaled by the scheduler's scale_elec."""

    cutoff: object = NoCutoff()
    use_neighbors: bool = False
    scheduler: object = DefaultLambdaScheduler()
    weight_special: float = 1.0
    coulomb_const: float = COULOMB_CONST

    def energy(self, r, ai, aj, special):
        ke = self.coulomb_const
        qq = (scaled_charge(self.scheduler, ai.charge, _lam(ai), _role(ai))
              * scaled_charge(self.scheduler, aj.charge, _lam(aj),
                              _role(aj)))

        def u(rr):
            return ke * qq / rr

        return _weighted(self.cutoff.apply(u, r), special,
                         self.weight_special)


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


def _rf_energy(r, qq, rc, krf, crf, ke, special, weight):
    """The reaction field inside rc; plain weighted Coulomb on 1-4 pairs."""
    rs = torch.minimum(r, r.new_full((), rc))
    e_rf = ke * qq * (1.0 / rs + krf * rs * rs - crf)
    e_plain = ke * qq / rs * weight
    return torch.where(r <= rc, torch.where(special, e_plain, e_rf), 0.0)


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

    def energy(self, r, ai, aj, special):
        return _rf_energy(r, ai.charge * aj.charge, self.dist_cutoff,
                          self.krf, self.crf, self.coulomb_const, special,
                          self.weight_special)


@dataclasses.dataclass(frozen=True)
class CoulombReactionFieldScaled:
    """Reaction field on charges scaled by the scheduler's scale_elec."""

    dist_cutoff: float = 1.0
    solvent_dielectric: float = CRF_SOLVENT_DIELECTRIC
    use_neighbors: bool = False
    scheduler: object = DefaultLambdaScheduler()
    weight_special: float = 1.0
    coulomb_const: float = COULOMB_CONST

    def energy(self, r, ai, aj, special):
        qq = (scaled_charge(self.scheduler, ai.charge, _lam(ai), _role(ai))
              * scaled_charge(self.scheduler, aj.charge, _lam(aj),
                              _role(aj)))
        krf, crf = rf_constants(self.dist_cutoff, self.solvent_dielectric)
        return _rf_energy(r, qq, self.dist_cutoff, krf, crf,
                          self.coulomb_const, special, self.weight_special)


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

    def energy(self, r, ai, aj, special):
        lam = elec_lambda(self.scheduler,
                          mix_lambda(self.lambda_mixing, ai, aj),
                          _role(ai), _role(aj))
        sig = mix_sigma(self.sigma_mixing, ai, aj)
        shift = self.alpha * (1.0 - lam) * sig ** 6
        ke = self.coulomb_const
        qq = ai.charge * aj.charge

        def u(rr):
            return lam * ke * qq / _max(shift + rr ** 6, 1e-18) ** (1.0 / 6.0)

        e = torch.where(lam > 0, self.cutoff.apply(u, r), 0.0)
        return _weighted(e, special, self.weight_special)


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

    def energy(self, r, ai, aj, special):
        lam = elec_lambda(self.scheduler,
                          mix_lambda(self.lambda_mixing, ai, aj),
                          _role(ai), _role(aj))
        ke = self.coulomb_const
        qq = ai.charge * aj.charge
        rq = (self.alpha * _safe_fracpow(1.0 - lam, 1.0 / 6.0)
              * (1.0 + self.sigma_q * torch.abs(qq)))

        def u(rr):
            outer = ke * qq / rr
            rqs = _max(rq, 1e-9)
            inner = ke * (qq / rqs ** 3 * rr ** 2 - 3.0 * qq / rqs ** 2 * rr
                          + 3.0 * qq / rqs)
            return lam * torch.where(rr >= rq, outer, inner)

        e = torch.where(lam > 0, self.cutoff.apply(u, r), 0.0)
        return _weighted(e, special, self.weight_special)


def _erfc(x, approximate):
    """erfc; ``approximate`` takes Abramowitz & Stegun 7.1.26, as OpenMM
    and the JAX package's engines do."""
    if approximate:
        t = 1.0 / (1.0 + 0.3275911 * x)
        poly = (0.254829592 + (-0.284496736 + (1.421413741 + (
            -1.453152027 + 1.061405429 * t) * t) * t) * t) * t
        return poly * torch.exp(-x * x)
    return torch.special.erfc(x)


def ewald_alpha(dist_cutoff, error_tol=0.0005):
    """alpha = sqrt(-log(2 tol)) / r_c (OpenMM convention)."""
    return math.sqrt(-math.log(2.0 * error_tol)) / dist_cutoff


def _ewald_alpha_default(inter):
    if inter.alpha is None:
        object.__setattr__(inter, "alpha",
                           ewald_alpha(inter.dist_cutoff, inter.error_tol))


def _ewald_energy(r, base_of_rs, inter, special):
    """Real-space Ewald: base(rs) erfc(alpha rs) inside the cutoff, the
    plain weighted base on 1-4 pairs (their reciprocal part is removed by
    EwaldExclusionCorrection)."""
    rs = torch.minimum(r, r.new_full((), inter.dist_cutoff))
    base = base_of_rs(rs)
    return torch.where(special, base * inter.weight_special,
                       base * _erfc(inter.alpha * rs, inter.approximate_erfc))


@dataclasses.dataclass(frozen=True)
class CoulombEwald:
    """Real-space Ewald ke q_i q_j erfc(alpha r) / r; 1-4 pairs get plain
    Coulomb times weight_special. ``approximate_erfc`` picks the erfc of
    the general engines (the pair kernel evaluates its own)."""

    dist_cutoff: float = 1.0
    error_tol: float = 0.0005
    use_neighbors: bool = False
    weight_special: float = 1.0
    coulomb_const: float = COULOMB_CONST
    alpha: float = None
    approximate_erfc: bool = True

    __post_init__ = _ewald_alpha_default

    def energy(self, r, ai, aj, special):
        qq = ai.charge * aj.charge
        e = _ewald_energy(r, lambda rs: self.coulomb_const * qq / rs, self,
                          special)
        return torch.where(r <= self.dist_cutoff, e, 0.0)


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

    def energy(self, r, ai, aj, special):
        qq = (scaled_charge(self.scheduler, ai.charge, _lam(ai), _role(ai))
              * scaled_charge(self.scheduler, aj.charge, _lam(aj),
                              _role(aj)))
        e = _ewald_energy(r, lambda rs: self.coulomb_const * qq / rs, self,
                          special)
        return torch.where(r <= self.dist_cutoff, e, 0.0)


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

    def energy(self, r, ai, aj, special):
        lam = elec_lambda(self.scheduler,
                          mix_lambda(self.lambda_mixing, ai, aj),
                          _role(ai), _role(aj))
        sig = mix_sigma(self.sigma_mixing, ai, aj)
        shift = self.alpha_sc * (1.0 - lam) * sig ** 6
        qq = ai.charge * aj.charge

        def base(rs):
            r_eff = _max(shift + rs ** 6, 1e-18) ** (1.0 / 6.0)
            return lam * self.coulomb_const * qq / r_eff

        e = _ewald_energy(r, base, self, special)
        e = torch.where(lam > 0, e, 0.0)
        return torch.where(r <= self.dist_cutoff, e, 0.0)


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

    def energy(self, r, ai, aj, special):
        lam = elec_lambda(self.scheduler,
                          mix_lambda(self.lambda_mixing, ai, aj),
                          _role(ai), _role(aj))
        ke = self.coulomb_const
        qq = ai.charge * aj.charge
        rq = (self.alpha_sc * _safe_fracpow(1.0 - lam, 1.0 / 6.0)
              * (1.0 + self.sigma_q * torch.abs(qq)))
        rqs = _max(rq, 1e-9)

        def base(rs):
            outer = ke * qq / rs
            inner = ke * (qq / rqs ** 3 * rs ** 2 - 3.0 * qq / rqs ** 2 * rs
                          + 3.0 * qq / rqs)
            return lam * torch.where(rs >= rq, outer, inner)

        e = _ewald_energy(r, base, self, special)
        e = torch.where(lam > 0, e, 0.0)
        return torch.where(r <= self.dist_cutoff, e, 0.0)


@dataclasses.dataclass(frozen=True)
class CoulombSoftCoreBeutlerReactionField:
    """Beutler soft-core 1/r plus the lambda-scaled reaction-field terms
    inside the cutoff (the general engines only: no pair-kernel mode)."""

    dist_cutoff: float = 1.0
    solvent_dielectric: float = CRF_SOLVENT_DIELECTRIC
    alpha: float = 1.0
    use_neighbors: bool = False
    sigma_mixing: object = LorentzMixing()
    lambda_mixing: object = MinimumMixing()
    scheduler: object = DefaultLambdaScheduler()
    weight_special: float = 1.0
    coulomb_const: float = COULOMB_CONST

    def energy(self, r, ai, aj, special):
        lam = elec_lambda(self.scheduler,
                          mix_lambda(self.lambda_mixing, ai, aj),
                          _role(ai), _role(aj))
        sig = mix_sigma(self.sigma_mixing, ai, aj)
        shift = self.alpha * (1.0 - lam) * sig ** 6
        ke = self.coulomb_const
        qq = ai.charge * aj.charge
        krf, crf = rf_constants(self.dist_cutoff, self.solvent_dielectric)
        rs = torch.minimum(r, r.new_full((), self.dist_cutoff))
        r_eff = _max(shift + rs ** 6, 1e-18) ** (1.0 / 6.0)
        e_rf = lam * ke * qq * (1.0 / r_eff + krf * rs * rs - crf)
        e_plain = lam * ke * qq / r_eff * self.weight_special
        e = torch.where(special, e_plain, e_rf)
        e = torch.where(lam > 0, e, 0.0)
        return torch.where(r <= self.dist_cutoff, e, 0.0)


@dataclasses.dataclass(frozen=True)
class CoulombSoftCoreGapsysReactionField:
    """Gapsys soft-core 1/r plus the lambda-scaled reaction-field terms
    inside the cutoff (the general engines only: no pair-kernel mode)."""

    dist_cutoff: float = 1.0
    solvent_dielectric: float = CRF_SOLVENT_DIELECTRIC
    alpha: float = 0.3
    sigma_q: float = 1.0
    use_neighbors: bool = False
    lambda_mixing: object = MinimumMixing()
    scheduler: object = DefaultLambdaScheduler()
    weight_special: float = 1.0
    coulomb_const: float = COULOMB_CONST

    def energy(self, r, ai, aj, special):
        lam = elec_lambda(self.scheduler,
                          mix_lambda(self.lambda_mixing, ai, aj),
                          _role(ai), _role(aj))
        ke = self.coulomb_const
        qq = ai.charge * aj.charge
        rq = (self.alpha * _safe_fracpow(1.0 - lam, 1.0 / 6.0)
              * (1.0 + self.sigma_q * torch.abs(qq)))
        krf, crf = rf_constants(self.dist_cutoff, self.solvent_dielectric)
        rs = torch.minimum(r, r.new_full((), self.dist_cutoff))
        rqs = _max(rq, 1e-9)
        outer = qq / rs
        inner = qq / rqs ** 3 * rs ** 2 - 3.0 * qq / rqs ** 2 * rs \
            + 3.0 * qq / rqs
        core = torch.where(rs >= rq, outer, inner)
        e_rf = lam * ke * (core + qq * (krf * rs * rs - crf))
        e_plain = lam * ke * core * self.weight_special
        e = torch.where(special, e_plain, e_rf)
        e = torch.where(lam > 0, e, 0.0)
        return torch.where(r <= self.dist_cutoff, e, 0.0)


@dataclasses.dataclass(frozen=True)
class Yukawa:
    """Screened Coulomb ke q_i q_j exp(-kappa r) / r."""

    cutoff: object = NoCutoff()
    use_neighbors: bool = False
    weight_special: float = 1.0
    coulomb_const: float = COULOMB_CONST
    kappa: float = 1.0

    def energy(self, r, ai, aj, special):
        ke = self.coulomb_const
        qq = ai.charge * aj.charge

        def u(rr):
            return ke * qq * torch.exp(-self.kappa * rr) / rr

        return _weighted(self.cutoff.apply(u, r), special,
                         self.weight_special)


# -- DPD: velocity-dependent, evaluated through force_vec

_U32 = 0xFFFFFFFF


def _mul32(h, c):
    """(h * c) mod 2^32 for h in [0, 2^32) held in int64, without an int64
    overflow: c is split into 16-bit halves."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & _U32


def _mix32(h, v):
    """One round of the DPD noise hash (uint32 arithmetic)."""
    h = _mul32(h ^ v, 0x85EBCA6B)
    h = _mul32(h ^ (h >> 13), 0xC2B2AE35)
    return h ^ (h >> 16)


def dpd_uniforms(seed, i, j, step_n):
    """The two float32 uniforms of the pair (i, j) at step_n: the JAX
    package's counter-based uint32 hash (mollytpu/ops/pairwise.py:899-911)
    emulated in int64, bit for bit. u1 lies in (0, 1], u2 in [0, 1)."""
    lo = torch.minimum(i, j).to(torch.int64)
    hi = torch.maximum(i, j).to(torch.int64)
    step = (step_n.to(torch.int64) if isinstance(step_n, torch.Tensor)
            else int(step_n)) & _U32
    h = seed & _U32
    for v in (lo, hi, step):
        h = _mix32(h, v)
    h2 = _mul32(h ^ 0x68E31DA4, 0x85EBCA6B)
    h2 = _mul32(h2 ^ (h2 >> 13), 0xC2B2AE35)
    u1 = (h.to(torch.float32) + 1.0) / 4294967296.0
    u2 = h2.to(torch.float32) / 4294967296.0
    return u1, u2


@dataclasses.dataclass(frozen=True)
class DPDInteraction:
    """Groot-Warren dissipative particle dynamics: conservative
    a w(r), dissipative -gamma w(r)^2 (dr.v) and random
    sigma w(r) xi / sqrt(dt) forces along dr, w = 1 - r / r_c. ``energy``
    is the conservative part only. The pair noise xi comes from a hash of
    (i, j, step, seed): the same for both atoms of a pair, replayable."""

    a: float = 25.0
    gamma: float = 4.5
    sigma: float = 3.0
    r_c: float = 1.0
    dt: float = 0.01
    use_neighbors: bool = True
    seed: int = 0x9E3779B9

    uses_velocity = True

    def energy(self, r, ai, aj, special):
        w = 1.0 - r / self.r_c
        return torch.where(r < self.r_c, 0.5 * self.a * self.r_c * w * w,
                           0.0)

    def _xi(self, i, j, step_n):
        """Standard-normal float32 noise of the pair (i, j) at step_n: the
        Box-Muller transform sqrt(-2 log u1) cos(2 pi u2) of
        dpd_uniforms in JAX's float32 order of operations, each of log,
        sqrt and cos evaluated in float64 and rounded to float32, so that
        the card and the CPU give the same bits. (XLA's float32 log and
        cos are its own approximations; they are not always correctly
        rounded, so JAX's xi can differ from this one in its last bits.)"""
        f32, f64 = torch.float32, torch.float64
        u1, u2 = dpd_uniforms(self.seed, i, j, step_n)
        log_u1 = torch.log(u1.to(f64)).to(f32)
        root = torch.sqrt((-2.0 * log_u1).to(f64)).to(f32)
        cos = torch.cos((2.0 * math.pi * u2).to(f64)).to(f32)
        return root * cos

    def force_vec(self, dr, r, i, j, ai, aj, vi, vj, special, step_n):
        """The pair force (..., 3) on atom j: the engines add it to j and
        subtract it from i."""
        rc = self.r_c
        rs = _max(r, 1e-10)
        w_r = 1.0 - rs / rc
        inv_r = 1.0 / rs
        f_c = self.a * w_r * inv_r
        rdotv = (dr * (vi - vj)).sum(dim=-1) * inv_r * inv_r
        f_d = self.gamma * (w_r * w_r) * rdotv
        xi = self._xi(i, j, step_n).to(r.dtype)
        f_r = self.sigma * w_r * xi / math.sqrt(self.dt) * inv_r
        live = (r < rc) & (r > 0)
        return torch.where(live, f_c + f_d + f_r, 0.0)[..., None] * dr


def interaction_cutoff(inter):
    """The outer radius an interaction needs from the neighbor list, or
    None."""
    if hasattr(inter, "dist_cutoff"):
        return float(inter.dist_cutoff)
    if hasattr(inter, "r_c"):
        return float(inter.r_c)
    if hasattr(inter, "cutoff"):
        return cutoff_distance(inter.cutoff)
    return None
