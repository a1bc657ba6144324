"""Thermostats and barostats (counterpart of mollytpu/sim/coupling.py).

A coupler is an immutable dataclass with

    apply(sys, aux, dt, step_n, generator=None, kinetic_tensor=None,
          virial=None, neighbors=None, draws=None) -> (sys, aux)
    acts(step_n) -> bool         does apply change anything at step_n
    invalidates_forces           it moves coordinates or the box
    needs_virial_interval        it reads the pressure every n steps (0: never)

as in the JAX package, with a ``torch.Generator`` in place of the key. The
step number is a host integer, so the host knows which steps a coupler acts
on: it does nothing on the others, and the integrator recomputes forces
only after a step on which a box-changing coupler acted (the JAX package
recomputes them after every step, mollytpu/sim/integrators.py:105-108).
Nothing in a coupler reads a device value on the host: a Monte Carlo move
is accepted or rejected by ``torch.where`` on the device.

``draws`` replaces a coupler's random numbers, as ``noise`` does for
Langevin (the tests feed the JAX package's): a dict with the keys that
``draw`` returns.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..forces import potential_energy
from ..spatial import (kinetic_energy, pressure_tensor, scale_coords,
                       scale_coords_molecular)
from ..units import KB

#: the JAX package's default compressibility, 4.6e-4 per bar in the internal
#: units nm^3 mol / kJ: ten times water's 4.6e-5 per bar (ROADMAP Queue 3)
DEFAULT_COMPRESSIBILITY = 4.6e-4 / 0.06022140760000001


def _instant_temp(sys):
    return 2.0 * kinetic_energy(sys.masses, sys.velocities) / (sys.n_dof * KB)


def _every(n_steps, step_n):
    return n_steps <= 1 or step_n % n_steps == 0


def _scalar(fn, generator, like):
    return fn((), generator=generator, dtype=like.dtype, device=like.device)


def _pressure(sys, kinetic_tensor, virial):
    vol = sys.boundary.volume()
    return vol, torch.trace(pressure_tensor(kinetic_tensor, virial,
                                            vol)) / sys.n_dims


def _scale(sys, mu, molecular, velocities=False):
    """The system with box and coordinates scaled by mu, per molecule or
    per atom (then velocities by 1/mu when asked)."""
    if molecular:
        boundary, coords = scale_coords_molecular(
            sys.boundary, sys.coords, mu, sys.masses, sys.molecule_ids,
            sys.n_molecules)
        return sys.update(coords=coords, boundary=boundary)
    if velocities:
        boundary, coords, vels = scale_coords(sys.boundary, sys.coords, mu,
                                              sys.velocities)
        return sys.update(coords=coords, boundary=boundary, velocities=vels)
    boundary, coords = scale_coords(sys.boundary, sys.coords, mu)
    return sys.update(coords=coords, boundary=boundary)


class _Thermostat:
    invalidates_forces = False
    needs_virial_interval = 0

    def acts(self, step_n):
        return True

    def draw(self, sys, generator):
        return {}


@dataclasses.dataclass(frozen=True)
class ImmediateThermostat(_Thermostat):
    """Rescale velocities to the target temperature every step."""

    temperature: float

    def apply(self, sys, aux, dt, step_n, generator=None, kinetic_tensor=None,
              virial=None, neighbors=None, draws=None):
        lam = torch.sqrt(self.temperature
                         / torch.clamp(_instant_temp(sys), min=1e-12))
        return sys.update(velocities=sys.velocities * lam), aux


@dataclasses.dataclass(frozen=True)
class VelocityRescaleThermostat(_Thermostat):
    """Bussi stochastic velocity rescaling; coupling_const is tau (ps)."""

    temperature: float
    coupling_const: float

    def draw(self, sys, generator):
        """r1 ~ N(0, 1) and g, a chi-squared draw with n_dof - 1 degrees of
        freedom (2 Gamma((n_dof - 1) / 2) in the JAX package), summed from
        n_dof - 1 squared normals: PyTorch's gamma sampler takes no
        generator, and the generator stays the only source."""
        x = sys.coords
        z = torch.randn(sys.n_dof - 1, generator=generator, dtype=x.dtype,
                        device=x.device)
        return {"r1": _scalar(torch.randn, generator, x),
                "g": torch.sum(z * z)}

    def apply(self, sys, aux, dt, step_n, generator=None, kinetic_tensor=None,
              virial=None, neighbors=None, draws=None):
        d = draws if draws is not None else self.draw(sys, generator)
        r1, g = d["r1"], d["g"]
        nf = sys.n_dof
        ke = kinetic_energy(sys.masses, sys.velocities)
        ratio = 0.5 * nf * KB * self.temperature / torch.clamp(nf * ke,
                                                                min=1e-12)
        c = math.exp(-dt / self.coupling_const)
        alpha2 = (c + (1.0 - c) * ratio * (g + r1 * r1)
                  + 2.0 * r1 * torch.sqrt(c * (1.0 - c) * ratio))
        alpha = torch.sqrt(torch.clamp(alpha2, min=0.0))
        return sys.update(velocities=sys.velocities * alpha), aux


@dataclasses.dataclass(frozen=True)
class AndersenThermostat(_Thermostat):
    """Each atom's velocity is redrawn from Maxwell-Boltzmann with
    probability dt / coupling_const per step."""

    temperature: float
    coupling_const: float

    def draw(self, sys, generator):
        """u (N,) uniform for the resample test and z (N, 3) standard
        normals for the new velocities."""
        x = sys.coords
        return {"u": torch.rand(x.shape[0], generator=generator,
                                dtype=x.dtype, device=x.device),
                "z": torch.randn(x.shape, generator=generator, dtype=x.dtype,
                                 device=x.device)}

    def apply(self, sys, aux, dt, step_n, generator=None, kinetic_tensor=None,
              virial=None, neighbors=None, draws=None):
        d = draws if draws is not None else self.draw(sys, generator)
        m = sys.masses
        positive = m > 0
        sigma = torch.sqrt(KB * self.temperature / torch.where(
            positive, m, torch.ones_like(m)))
        new_v = torch.where(positive[:, None], sigma[:, None] * d["z"],
                            torch.zeros_like(d["z"]))
        resample = d["u"] < dt / self.coupling_const
        return sys.update(velocities=torch.where(
            resample[:, None], new_v, sys.velocities)), aux


@dataclasses.dataclass(frozen=True)
class BerendsenThermostat(_Thermostat):
    """Weak-coupling velocity rescale toward the target temperature."""

    temperature: float
    coupling_const: float

    def apply(self, sys, aux, dt, step_n, generator=None, kinetic_tensor=None,
              virial=None, neighbors=None, draws=None):
        t_inst = torch.clamp(_instant_temp(sys), min=1e-12)
        lam2 = 1.0 + (dt / self.coupling_const) * (
            self.temperature / t_inst - 1.0)
        lam = torch.sqrt(torch.clamp(lam2, min=0.0))
        return sys.update(velocities=sys.velocities * lam), aux


class _Barostat:
    invalidates_forces = True
    # simulate re-sets the neighbor finder up between chunks only for a
    # coupler that can change the box
    is_barostat = True

    def acts(self, step_n):
        return _every(self.n_steps, step_n)

    @property
    def needs_virial_interval(self):
        return self.n_steps

    def draw(self, sys, generator):
        return {}


@dataclasses.dataclass(frozen=True)
class BerendsenBarostat(_Barostat):
    """Weak-coupling isotropic box rescale toward the target pressure
    (kJ/mol/nm^3) from the current kinetic tensor and virial, every
    ``n_steps``."""

    pressure: float
    coupling_const: float
    compressibility: float = DEFAULT_COMPRESSIBILITY
    n_steps: int = 1
    max_scale_frac: float = 0.1
    scale_molecules: bool = False

    def apply(self, sys, aux, dt, step_n, generator=None, kinetic_tensor=None,
              virial=None, neighbors=None, draws=None):
        if not self.acts(step_n):
            return sys, aux
        _, p = _pressure(sys, kinetic_tensor, virial)
        mu3 = 1.0 - (self.n_steps * dt / self.coupling_const) \
            * self.compressibility * (self.pressure - p)
        mu3 = torch.clamp(mu3, 1.0 - self.max_scale_frac,
                          1.0 + self.max_scale_frac)
        return _scale(sys, mu3 ** (1.0 / 3.0), self.scale_molecules), aux


@dataclasses.dataclass(frozen=True)
class MonteCarloBarostat(_Barostat):
    """OpenMM-style Monte Carlo volume moves every ``n_steps``: propose
    dV ~ U(-scale, scale), scale the molecules' centres (or every atom),
    accept on exp(-(dU + P dV - N kB T ln(V'/V)) / kB T) from two potential
    energies on the current list. The proposal scale adapts every 10
    attempts toward 25-75% acceptance; the state (scale, attempted,
    accepted) lives in aux["mc_baro"] as device tensors. ``coupling``:
    "isotropic", "anisotropic" (one random axis per attempt) or
    "semiisotropic" (xy together or z alone)."""

    pressure: float
    temperature: float
    n_steps: int = 30
    initial_scale_frac: float = 0.01
    scale_molecules: bool = True
    coupling: str = "isotropic"

    needs_virial_interval = 0

    def init_state(self, sys):
        vol = sys.boundary.volume().to(sys.coords.dtype)
        zero = torch.zeros((), dtype=torch.int32, device=sys.device)
        return {"scale": self.initial_scale_frac * vol, "attempted": zero,
                "accepted": zero}

    def draw(self, sys, generator):
        """dv in [-1, 1) (times the scale), u for the acceptance test, and
        the axis (anisotropic) or the xy/z pick (semiisotropic)."""
        x = sys.coords
        out = {"dv": 2.0 * _scalar(torch.rand, generator, x) - 1.0,
               "u": _scalar(torch.rand, generator, x)}
        if self.coupling == "anisotropic":
            out["axis"] = torch.randint(3, (), generator=generator,
                                        device=x.device)
        elif self.coupling == "semiisotropic":
            out["pick_z"] = _scalar(torch.rand, generator, x) < 0.5
        return out

    def _mu(self, s_vol, d, like):
        if self.coupling == "isotropic":
            return s_vol ** (1.0 / 3.0)
        one = torch.ones((), dtype=like.dtype, device=like.device)
        if self.coupling == "anisotropic":
            axis = torch.arange(3, device=like.device) == d["axis"]
            return torch.where(axis, s_vol, one)
        xy = torch.sqrt(s_vol)
        return torch.where(d["pick_z"], torch.stack([one, one, s_vol]),
                           torch.stack([xy, xy, one]))

    def apply(self, sys, aux, dt, step_n, generator=None, kinetic_tensor=None,
              virial=None, neighbors=None, draws=None):
        state = aux.get("mc_baro")
        if state is None:
            state = self.init_state(sys)
        if not self.acts(step_n):
            return sys, {**aux, "mc_baro": state}
        d = draws if draws is not None else self.draw(sys, generator)
        vol = sys.boundary.volume()
        dv = d["dv"] * state["scale"]
        v_new = vol + dv
        trial = _scale(sys, self._mu(v_new / vol, d, sys.coords),
                       self.scale_molecules)
        n_scaled = sys.n_molecules if self.scale_molecules else sys.n_atoms
        e_old = potential_energy(sys, neighbors, step_n)
        e_new = potential_energy(trial, neighbors, step_n)
        kt = KB * self.temperature
        w = (e_new - e_old + self.pressure * dv
             - n_scaled * kt * torch.log(v_new / vol))
        accept = (d["u"] < torch.exp(torch.clamp(-w / kt, max=0.0))) \
            & (v_new > 0)
        sys = sys.update(
            coords=torch.where(accept, trial.coords, sys.coords),
            boundary=trial.boundary.where(accept, sys.boundary))
        attempted = state["attempted"] + 1
        accepted = state["accepted"] + accept.to(torch.int32)
        # adapt the proposal scale every 10 attempts
        adapt = (attempted % 10) == 0
        frac = accepted.to(dv.dtype) / torch.clamp(attempted, min=1).to(
            dv.dtype)
        scale = state["scale"]
        scale = torch.where(adapt & (frac < 0.25), scale / 1.1, scale)
        scale = torch.where(adapt & (frac > 0.75), scale * 1.1, scale)
        return sys, {**aux, "mc_baro": {"scale": scale,
                                        "attempted": attempted,
                                        "accepted": accepted}}


@dataclasses.dataclass(frozen=True)
class CRescaleBarostat(_Barostat):
    """Stochastic cell rescaling (Bernetti & Bussi 2020), isotropic:
    d eps = -beta dt / tau (P0 - P) + sqrt(2 kB T beta dt / (V tau)) xi,
    mu = exp(d eps / 3), every ``n_steps`` with dt the n_steps-step
    interval."""

    pressure: float
    temperature: float
    coupling_const: float
    compressibility: float = DEFAULT_COMPRESSIBILITY
    n_steps: int = 1
    scale_molecules: bool = False
    max_scale_frac: float = 0.1

    def draw(self, sys, generator):
        return {"xi": _scalar(torch.randn, generator, sys.coords)}

    def apply(self, sys, aux, dt, step_n, generator=None, kinetic_tensor=None,
              virial=None, neighbors=None, draws=None):
        if not self.acts(step_n):
            return sys, aux
        d = draws if draws is not None else self.draw(sys, generator)
        vol, p = _pressure(sys, kinetic_tensor, virial)
        beta = self.compressibility
        dt_eff = self.n_steps * dt
        det = -beta * dt_eff / self.coupling_const * (self.pressure - p)
        noise = torch.sqrt(2.0 * KB * self.temperature * beta * dt_eff
                           / (vol * self.coupling_const))
        deps = torch.clamp(det + noise * d["xi"], -self.max_scale_frac,
                           self.max_scale_frac)
        return _scale(sys, torch.exp(deps / 3.0), self.scale_molecules,
                      velocities=True), aux


def apply_couplers(couplers, sys, aux, dt, step_n, generator=None,
                   kinetic_tensor=None, virial=None, neighbors=None,
                   draws=None):
    """Apply each coupler in turn; ``draws``, when given, holds one entry
    (a dict or None) per coupler."""
    for i, c in enumerate(couplers):
        sys, aux = c.apply(sys, aux, dt, step_n, generator, kinetic_tensor,
                           virial, neighbors,
                           None if draws is None else draws[i])
    return sys, aux


def couplers_invalidate_forces(couplers):
    return any(c.invalidates_forces for c in couplers)


def forces_invalidated_at(couplers, step_n):
    """Did a coupler that moves coordinates or the box act at step_n?"""
    return any(c.invalidates_forces and c.acts(step_n) for c in couplers)


def needs_virial_interval(couplers, loggers=()):
    """Greatest common divisor of the positive virial intervals of the
    couplers and loggers, or 0 (mollytpu/sim/coupling.py:357-377)."""
    g = 0
    for c in (*couplers, *loggers):
        g = math.gcd(g, int(getattr(c, "needs_virial_interval", 0)))
    return g


def virial_due(couplers, step_n):
    """Does a coupler read the pressure at step_n (each at the multiples
    of its own interval)?"""
    return any(c.needs_virial_interval
               and step_n % c.needs_virial_interval == 0 for c in couplers)
