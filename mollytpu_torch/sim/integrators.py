"""Integrators: Langevin (BAOA middle scheme) and velocity Verlet, with
thermostat and barostat coupling (counterpart of
mollytpu/sim/integrators.py:47-142, 205-242).

Contract as in the JAX package:

    init_aux(sys, neighbors, needs_virial) -> aux  (forces cache, coupler
        state)
    step(sys, neighbors, aux, step_n, generator, needs_virial, draws)
        -> (sys, aux)

Every step ends in ``_finish_step``: centre-of-mass motion removal, then
the couplers, then a force recompute if a coupler moved coordinates or the
box. The host knows step_n, so the recompute runs only on the steps where
such a coupler acted (the JAX package recomputes after every step when any
coupler could move them; the forces are the same). ``needs_virial`` is the
step's own: the caller asks for it on the steps whose pressure a coupler
reads (sim.coupling.virial_due), and aux["virial"] keeps the virial the
couplers read.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..forces import forces_virial
from ..spatial import kinetic_energy_tensor, remove_cm_motion
from ..units import KB
from .coupling import apply_couplers, forces_invalidated_at


def _accels(masses, forces):
    positive = masses > 0
    safe = torch.where(positive, masses, torch.ones_like(masses))
    return torch.where(positive[:, None], forces / safe[:, None],
                       torch.zeros_like(forces))


def _apply_position_constraints(sys, coords_prev, coords_new, vels, dt):
    for c in sys.constraints:
        coords_new, vels = c.apply_position_constraints(
            coords_prev, coords_new, vels, sys.masses, sys.boundary, dt)
    return coords_new, vels


def _apply_velocity_constraints(sys, coords, vels):
    for c in sys.constraints:
        vels = c.apply_velocity_constraints(coords, vels, sys.masses,
                                            sys.boundary)
    return vels


def _recompute(sys, neighbors, step_n, needs_virial):
    f, v = forces_virial(sys, neighbors, step_n, needs_virial=needs_virial)
    return {"forces": f, "virial": v}


class _IntegratorBase:

    def init_aux(self, sys, neighbors, needs_virial=False):
        aux = _recompute(sys, neighbors, 0, needs_virial)
        for c in self.coupling:
            if hasattr(c, "init_state"):
                aux["mc_baro"] = c.init_state(sys)
        return aux

    def _finish_step(self, sys, neighbors, aux, step_n, generator,
                     needs_virial, kinetic_tensor=None, draws=None):
        """CM motion removal, the couplers, and the forces again where a
        coupler moved coordinates or the box (integrators.py:79-109)."""
        if self.remove_cm:
            sys = sys.update(velocities=remove_cm_motion(sys.masses,
                                                         sys.velocities))
        if self.coupling:
            if kinetic_tensor is None and needs_virial:
                kinetic_tensor = kinetic_energy_tensor(sys.masses,
                                                       sys.velocities)
            sys, aux = apply_couplers(self.coupling, sys, aux, self.dt,
                                      step_n, generator, kinetic_tensor,
                                      aux["virial"], neighbors, draws)
            if forces_invalidated_at(self.coupling, step_n):
                aux = {**aux, "forces": forces_virial(sys, neighbors,
                                                      step_n)[0]}
        return sys, aux


@dataclasses.dataclass(frozen=True)
class VelocityVerlet(_IntegratorBase):
    """Kick-drift-kick with constraint hooks (integrators.py:112-142)."""

    dt: float
    coupling: tuple = ()
    remove_cm: bool = True

    def step(self, sys, neighbors, aux, step_n, generator=None,
             needs_virial=False, draws=None):
        dt = self.dt
        m = sys.masses
        vels = sys.velocities + 0.5 * dt * _accels(m, aux["forces"])
        vels = _apply_velocity_constraints(sys, sys.coords, vels)
        coords_prev = sys.coords
        coords = sys.coords + dt * vels
        coords, vels = _apply_position_constraints(sys, coords_prev, coords,
                                                   vels, dt)
        sys = sys.update(coords=sys.boundary.wrap(coords), velocities=vels)
        aux = {**aux, **_recompute(sys, neighbors, step_n, needs_virial)}
        vels = sys.velocities + 0.5 * dt * _accels(m, aux["forces"])
        sys = sys.update(velocities=_apply_velocity_constraints(
            sys, sys.coords, vels))
        kin_t = (kinetic_energy_tensor(m, sys.velocities) if needs_virial
                 else None)
        return self._finish_step(sys, neighbors, aux, step_n, generator,
                                 needs_virial, kin_t, draws)


@dataclasses.dataclass(frozen=True)
class Langevin(_IntegratorBase):
    """BAOA middle-scheme Langevin leapfrog, OpenMM style. dt in ps,
    temperature in K, friction in 1/ps."""

    dt: float
    temperature: float
    friction: float
    coupling: tuple = ()
    remove_cm: bool = True

    def step(self, sys, neighbors, aux, step_n, generator=None, noise=None,
             needs_virial=False, draws=None):
        """One step. ``noise`` is an optional (N, 3) standard-normal tensor;
        without it the noise is drawn from ``generator``. ``draws`` holds
        one entry per coupler for its random numbers (coupling.py)."""
        dt = self.dt
        m = sys.masses
        # B: full kick
        vels = sys.velocities + dt * _accels(m, aux["forces"])
        vels = _apply_velocity_constraints(sys, sys.coords, vels)
        # A: half drift
        coords_prev = sys.coords
        coords = sys.coords + 0.5 * dt * vels
        # O: Ornstein-Uhlenbeck
        c1 = math.exp(-self.friction * dt)
        positive = m > 0
        safe_m = torch.where(positive, m, torch.ones_like(m))
        sigma = torch.sqrt(KB * self.temperature / safe_m) * math.sqrt(
            1.0 - c1 ** 2)
        if noise is None:
            noise = torch.randn(vels.shape, generator=generator,
                                dtype=vels.dtype, device=vels.device)
        vels = c1 * vels + torch.where(positive[:, None],
                                       sigma[:, None] * noise,
                                       torch.zeros_like(vels))
        vels = _apply_velocity_constraints(sys, coords, vels)
        # A: half drift
        coords = coords + 0.5 * dt * vels
        coords, vels = _apply_position_constraints(sys, coords_prev, coords,
                                                   vels, dt)
        sys = sys.update(coords=sys.boundary.wrap(coords), velocities=vels)
        aux = {**aux, **_recompute(sys, neighbors, step_n, needs_virial)}
        return self._finish_step(sys, neighbors, aux, step_n, generator,
                                 needs_virial, draws=draws)
