"""Mixing rules (counterpart of mollytpu/ops/mixing.py:18-162): stateless
rules applied per pair on broadcast tensors, and NBFix overrides as a
MixingException over a small ExceptionTable keyed by atom-type ids.

The pair kernel's spec reads the rule classes as tags: it takes Lorentz
sigma, geometric epsilon and minimum lambda mixing, and everything else
goes to the general pair engines (ops/nonbonded.py).
"""

from __future__ import annotations

import dataclasses

import torch


class _Rule:
    """Rules compare equal by class, so interactions holding them do."""

    def __eq__(self, other):
        return type(other) is type(self)

    def __hash__(self):
        return hash(type(self))


class LorentzMixing(_Rule):
    """Arithmetic mean (x_i + x_j) / 2."""

    @staticmethod
    def mix(x, y):
        return (x + y) * 0.5


class GeometricMixing(_Rule):
    """Geometric mean sqrt(x_i x_j)."""

    @staticmethod
    def mix(x, y):
        return torch.sqrt(x * y)


class WaldmanHaglerMixing(_Rule):
    """sigma: the sixth-power mean; epsilon: the paired Waldman-Hagler
    formula 2 sqrt(e_i e_j) s_i^3 s_j^3 / (s_i^6 + s_j^6)."""

    @staticmethod
    def mix_sigma(si, sj):
        return ((si ** 6 + sj ** 6) * 0.5) ** (1.0 / 6.0)

    @staticmethod
    def mix_epsilon(ei, ej, si, sj):
        s6 = si ** 6 + sj ** 6
        return 2.0 * torch.sqrt(ei * ej) * (si ** 3 * sj ** 3) / torch.clamp(
            s6, min=1e-30)


class FenderHalseyMixing(_Rule):
    """2 x_i x_j / (x_i + x_j)."""

    @staticmethod
    def mix(x, y):
        return 2.0 * x * y / torch.clamp(x + y, min=1e-30)


class InverseMixing(_Rule):
    """Harmonic mean 2 / (1/x_i + 1/x_j) (Buckingham's B)."""

    @staticmethod
    def mix(x, y):
        return 2.0 / (1.0 / x + 1.0 / y)


class MinimumMixing(_Rule):
    """min(1, min(x_i, x_j)): the alchemical lambda mixing the pair kernel
    takes."""

    @staticmethod
    def mix(x, y):
        m = torch.minimum(x, y)
        return torch.minimum(m.new_full((), 1.0), m)


@dataclasses.dataclass(frozen=True)
class ExceptionTable:
    """NBFix pair overrides: parallel tuples of type ids (type_i, type_j)
    and their values. Where several entries match a pair, the last wins."""

    keys_i: tuple
    keys_j: tuple
    values: tuple

    def lookup(self, ti, tj, default):
        """The table's value where (ti, tj) matches an entry in either
        order, else ``default`` (broadcast tensors)."""
        out = default
        for ki, kj, v in zip(self.keys_i, self.keys_j, self.values):
            hit = ((ti == ki) & (tj == kj)) | ((ti == kj) & (tj == ki))
            out = torch.where(hit, out.new_full((), float(v)), out)
        return out


@dataclasses.dataclass(frozen=True)
class MixingException:
    """A base mixing rule with an NBFix exception table."""

    mixing: object
    exceptions: ExceptionTable = None

    def mix_with_types(self, x, y, ti, tj):
        default = self.mixing.mix(x, y)
        if self.exceptions is None:
            return default
        return self.exceptions.lookup(ti, tj, default)


def mix_sigma(rule, ai, aj):
    if isinstance(rule, WaldmanHaglerMixing):
        return rule.mix_sigma(ai.sigma, aj.sigma)
    if isinstance(rule, MixingException):
        return rule.mix_with_types(ai.sigma, aj.sigma, ai.atom_type,
                                   aj.atom_type)
    return rule.mix(ai.sigma, aj.sigma)


def mix_epsilon(rule, ai, aj):
    if isinstance(rule, WaldmanHaglerMixing):
        return rule.mix_epsilon(ai.epsilon, aj.epsilon, ai.sigma, aj.sigma)
    if isinstance(rule, MixingException):
        return rule.mix_with_types(ai.epsilon, aj.epsilon, ai.atom_type,
                                   aj.atom_type)
    return rule.mix(ai.epsilon, aj.epsilon)


def mix_lambda(rule, ai, aj):
    if isinstance(rule, MixingException):
        return rule.mix_with_types(ai.lam, aj.lam, ai.atom_type,
                                   aj.atom_type)
    return rule.mix(ai.lam, aj.lam)
