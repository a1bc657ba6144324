"""Langevin integrator, BAOA middle scheme
(counterpart of mollytpu/sim/integrators.py:47-110, 205-242).

Contract as in the JAX package:

    init_aux(sys, neighbors, needs_virial) -> aux  (forces cache)
    step(sys, neighbors, aux, step_n, generator, noise, needs_virial)
        -> (sys, aux)
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..forces import forces_virial
from ..spatial import remove_cm_motion
from ..units import KB


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


@dataclasses.dataclass(frozen=True)
class Langevin:
    """BAOA middle-scheme Langevin leapfrog, OpenMM style. dt in ps,
    temperature in K, friction in 1/ps."""

    dt: float
    temperature: float
    friction: float
    remove_cm: bool = True

    def init_aux(self, sys, neighbors, needs_virial=False):
        return _recompute(sys, neighbors, 0, needs_virial)

    def step(self, sys, neighbors, aux, step_n, generator=None, noise=None,
             needs_virial=False):
        """One step. ``noise`` is an optional (N, 3) standard-normal tensor;
        without it the noise is drawn from ``generator``."""
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
        coords = sys.boundary.wrap(coords)
        sys = sys.update(coords=coords, velocities=vels)
        aux = _recompute(sys, neighbors, step_n, needs_virial)
        if self.remove_cm:
            sys = sys.update(velocities=remove_cm_motion(m, sys.velocities))
        return sys, aux
