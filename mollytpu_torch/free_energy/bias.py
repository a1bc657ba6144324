"""Bias potentials on collective variables (counterpart of
mollytpu/free_energy/bias.py).

A bias maps a CV value (a tensor, or a Python float as the PMF grids pass
it) to an energy in kJ/mol. A BiasPotential is bias(cv(coords)) as a
GeneralInteraction: its forces are -dE/dx by torch.autograd, on the device
of the coordinates, like every general interaction of the port.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops.general import GeneralInteraction


def _cv(cv):
    return cv if isinstance(cv, torch.Tensor) else torch.as_tensor(
        cv, dtype=torch.float64)


@dataclasses.dataclass(frozen=True)
class LinearBias:
    """U = k cv."""

    k: float = 1.0

    def __call__(self, cv):
        return self.k * _cv(cv)


@dataclasses.dataclass(frozen=True)
class SquareBias:
    """U = k/2 (cv - cv0)^2, the umbrella restraint."""

    k: float = 1000.0
    cv0: float = 0.0

    def __call__(self, cv):
        return 0.5 * self.k * (_cv(cv) - self.cv0) ** 2


def _flat_bottom(k, diff, width):
    d = torch.abs(diff) - 0.5 * width
    return 0.5 * k * torch.clamp(d, min=0.0) ** 2


@dataclasses.dataclass(frozen=True)
class FlatBottomSquareBias:
    """Zero inside |cv - cv0| < width/2, harmonic outside."""

    k: float = 1000.0
    cv0: float = 0.0
    width: float = 0.1

    def __call__(self, cv):
        return _flat_bottom(self.k, _cv(cv) - self.cv0, self.width)


@dataclasses.dataclass(frozen=True)
class PeriodicFlatBottomBias:
    """Flat-bottom harmonic on a periodic CV (a torsion), the difference
    wrapped into (-period/2, period/2] (round half to even, as jnp.round)."""

    k: float = 1000.0
    cv0: float = 0.0
    width: float = 0.1
    period: float = 2.0 * math.pi

    def __call__(self, cv):
        diff = _cv(cv) - self.cv0
        diff = diff - self.period * torch.round(diff / self.period)
        return _flat_bottom(self.k, diff, self.width)


@dataclasses.dataclass(frozen=True)
class BiasPotential(GeneralInteraction):
    """bias(cv(coords)) as a general interaction."""

    bias: object = None
    cv: object = None

    def energy(self, coords, boundary, atoms):
        return self.bias(self.cv.value(coords, boundary))
