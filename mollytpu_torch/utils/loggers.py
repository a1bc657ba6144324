"""Loggers (counterpart of mollytpu/utils/loggers.py).

A logger has an ``interval`` and ``observe(sys, neighbors, aux, step_n)``;
``sim.simulate`` runs in chunks that end on every logger's interval and
calls ``observe`` between them, so a logger costs nothing inside a chunk
and one host read per record. A logger that reads the virial states its
``needs_virial_interval``: the integrator then computes the virial on the
steps whose end it records.
"""

from __future__ import annotations

import dataclasses

import torch

from ..forces import kinetic_energy, potential_energy, total_energy
from ..spatial import kinetic_energy_tensor, pressure_tensor, scalar_pressure
from ..units import KB


@dataclasses.dataclass
class GeneralObservableLogger:
    """Record observable(sys, neighbors, aux, step_n) every ``interval``
    steps."""

    observable: callable
    interval: int = 1
    needs_virial_interval: int = 0

    def observe(self, sys, neighbors, aux, step_n):
        return self.observable(sys, neighbors, aux, step_n)


def _virial_logger(observable, interval):
    return GeneralObservableLogger(observable, interval,
                                   needs_virial_interval=interval)


def TemperatureLogger(interval=1):
    return GeneralObservableLogger(
        lambda s, n, a, i: 2.0 * kinetic_energy(s) / (s.n_dof * KB),
        interval)


def CoordinatesLogger(interval=1):
    return GeneralObservableLogger(lambda s, n, a, i: s.coords, interval)


def VelocitiesLogger(interval=1):
    return GeneralObservableLogger(lambda s, n, a, i: s.velocities, interval)


def ForcesLogger(interval=1):
    return GeneralObservableLogger(lambda s, n, a, i: a["forces"], interval)


def KineticEnergyLogger(interval=1):
    return GeneralObservableLogger(lambda s, n, a, i: kinetic_energy(s),
                                   interval)


def PotentialEnergyLogger(interval=1):
    return GeneralObservableLogger(
        lambda s, n, a, i: potential_energy(s, n, i), interval)


def TotalEnergyLogger(interval=1):
    return GeneralObservableLogger(lambda s, n, a, i: total_energy(s, n, i),
                                   interval)


def VolumeLogger(interval=1):
    return GeneralObservableLogger(lambda s, n, a, i: s.boundary.volume(),
                                   interval)


def BoxLogger(interval=1):
    return GeneralObservableLogger(
        lambda s, n, a, i: s.boundary.box_matrix(), interval)


def DensityLogger(interval=1):
    """Mass density in u/nm^3."""
    return GeneralObservableLogger(
        lambda s, n, a, i: torch.sum(s.masses) / s.boundary.volume(),
        interval)


def VirialLogger(interval=1):
    return _virial_logger(lambda s, n, a, i: a["virial"], interval)


def ScalarVirialLogger(interval=1):
    return _virial_logger(lambda s, n, a, i: torch.trace(a["virial"]),
                          interval)


def PressureLogger(interval=1):
    return _virial_logger(lambda s, n, a, i: pressure_tensor(
        kinetic_energy_tensor(s.masses, s.velocities), a["virial"],
        s.boundary.volume()), interval)


def ScalarPressureLogger(interval=1):
    return _virial_logger(lambda s, n, a, i: scalar_pressure(
        kinetic_energy_tensor(s.masses, s.velocities), a["virial"],
        s.boundary.volume(), s.n_dims), interval)


@dataclasses.dataclass
class AverageObservableLogger:
    """The running mean of an observable beside its records
    (mollytpu/utils/loggers.py:118-137)."""

    observable: callable
    interval: int = 1
    needs_virial_interval: int = 0
    _sum: object = None
    _count: int = 0

    def observe(self, sys, neighbors, aux, step_n):
        v = self.observable(sys, neighbors, aux, step_n)
        self._sum = v if self._sum is None else self._sum + v
        self._count += 1
        return v

    @property
    def average(self):
        return self._sum / self._count if self._count else None


@dataclasses.dataclass
class TimeCorrelationLogger:
    """Records (A(t), B(t)) for a correlation afterwards; B defaults to A
    (mollytpu/utils/loggers.py:140-154)."""

    observable_a: callable
    observable_b: callable = None
    interval: int = 1
    needs_virial_interval: int = 0

    def observe(self, sys, neighbors, aux, step_n):
        a = self.observable_a(sys, neighbors, aux, step_n)
        b = a if self.observable_b is None else self.observable_b(
            sys, neighbors, aux, step_n)
        return (a, b)


def autocorrelation(series, n_lags=None):
    """Normalised autocorrelation of a (T, ...) stacked series, lags 0 to
    n_lags - 1 (T // 2 by default)."""
    x = torch.as_tensor(series)
    x = x - x.mean(dim=0, keepdim=True)
    t = x.shape[0]
    flat = x.reshape(t, -1)
    denom = torch.sum(flat * flat)
    return torch.stack([torch.sum(flat[:t - lag] * flat[lag:]) / denom
                        for lag in range(n_lags or t // 2)])


@dataclasses.dataclass
class DisplacementsLogger:
    """Minimum-image displacement of every atom from the first frame it
    observed (mollytpu/utils/loggers.py:172-186)."""

    interval: int = 1
    needs_virial_interval: int = 0
    reference: object = None

    def observe(self, sys, neighbors, aux, step_n):
        if self.reference is None:
            self.reference = sys.coords
        return sys.boundary.displacement(self.reference, sys.coords)


@dataclasses.dataclass
class ReplicaExchangeLogger:
    """Counts replica-exchange attempts and acceptances fed to
    ``record``."""

    n_replicas: int = 0
    n_exchanges: int = 0
    n_attempts: int = 0

    def record(self, accepted, attempted):
        self.n_exchanges += int(accepted)
        self.n_attempts += int(attempted)

    @property
    def exchange_rate(self):
        return self.n_exchanges / max(self.n_attempts, 1)


@dataclasses.dataclass
class MonteCarloLogger:
    """Counts Monte Carlo trials and acceptances fed to ``record``."""

    n_trials: int = 0
    n_accepted: int = 0

    def record(self, accepted, trials=1):
        self.n_trials += int(trials)
        self.n_accepted += int(accepted)

    @property
    def acceptance_rate(self):
        return self.n_accepted / max(self.n_trials, 1)
