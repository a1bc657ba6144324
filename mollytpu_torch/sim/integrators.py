"""Integrators: Langevin (BAOA middle scheme), velocity Verlet and the
multiple-time-step MTSIntegrator (rRESPA) and MTSLangevinIntegrator
(BAOAB-RESPA), with thermostat and barostat coupling (counterpart of
mollytpu/sim/integrators.py:47-142, 205-242, 408-605).

Contract as in the JAX package:

    init_aux(sys, neighbors, needs_virial) -> aux  (forces cache, coupler
        state)
    step(sys, neighbors, aux, step_n, generator, needs_virial, draws)
        -> (sys, aux)

Every step ends in ``_finish_step``: centre-of-mass motion removal, then
the couplers, then a recompute of the forces, and of the virial where it
is due, if a coupler moved coordinates or the box. The host knows step_n,
so the recompute runs only on the steps where such a coupler acted (the
JAX package recomputes after every step when any coupler could move them;
the forces are the same). ``needs_virial`` is the
step's own: the caller asks for it on the steps whose pressure a coupler
reads (sim.coupling.virial_due); aux["virial"] holds the virial at the
step's final coordinates and box.
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
        """CM motion removal, the couplers, and the forces (and the virial,
        where due) again where a coupler moved coordinates or the box
        (integrators.py:79-109)."""
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
                aux = {**aux, **_recompute(sys, neighbors, step_n,
                                           needs_virial)}
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
class DPDVelocityVerlet(_IntegratorBase):
    """Groot-Warren modified velocity Verlet for velocity-dependent DPD
    forces: the forces at the new positions are evaluated with predicted
    velocities v + lam dt a (integrators.py:381-405)."""

    dt: float
    lam: float = 0.5
    coupling: tuple = ()
    remove_cm: bool = True

    def step(self, sys, neighbors, aux, step_n, generator=None,
             needs_virial=False, draws=None):
        dt = self.dt
        m = sys.masses
        a_t = _accels(m, aux["forces"])
        coords = sys.boundary.wrap(sys.coords + dt * sys.velocities
                                   + 0.5 * dt * dt * a_t)
        v_pred = sys.velocities + self.lam * dt * a_t
        new = _recompute(sys.update(coords=coords, velocities=v_pred),
                         neighbors, step_n, needs_virial)
        vels = sys.velocities + 0.5 * dt * (a_t + _accels(m, new["forces"]))
        sys = sys.update(coords=coords, velocities=vels)
        return self._finish_step(sys, neighbors, {**aux, **new}, step_n,
                                 generator, needs_virial, draws=draws)


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


def _split_fast_slow(sys):
    """The classic MTS split: the bonded lists are the fast group, the
    pairwise and general interactions the slow one."""
    return (sys.update(pairwise_inters=(), general_inters=()),
            sys.update(specific_lists=()))


def _mts_fractions(sim, sys):
    """The evaluation fractions in ascending order and, per fraction, the
    system with the interactions evaluated that many times per outer step
    (mollytpu/sim/integrators.py:417-461). With no fractions given, the
    bonded lists run n_substeps times, everything else once."""
    np_, ns, ng = (len(sys.pairwise_inters), len(sys.specific_lists),
                   len(sys.general_inters))
    pf, sf, gf = sim.pi_fractions, sim.si_fractions, sim.gi_fractions
    if not (pf or sf or gf):
        pf, sf, gf = (1,) * np_, (sim.n_substeps,) * ns, (1,) * ng
    for name, what, n, fr in (
            ("pi_fractions", "pairwise interactions", np_, pf),
            ("si_fractions", "specific interaction lists", ns, sf),
            ("gi_fractions", "general interactions", ng, gf)):
        if len(fr) != n:
            raise ValueError(f"system has {n} {what} but {name} has "
                             f"{len(fr)}")
    allf = tuple(pf) + tuple(sf) + tuple(gf)
    if not allf:
        raise ValueError("MTS integrator requires at least one interaction")
    fractions = tuple(sorted({int(f) for f in allf}))
    if fractions[0] < 1:
        raise ValueError(f"MTS fraction {fractions[0]} cannot be < 1")
    if fractions[0] != 1:
        raise ValueError("MTS fractions must include 1, lowest is "
                         f"{fractions[0]}")
    for a, b in zip(fractions, fractions[1:]):
        if b % a != 0:
            raise ValueError(f"MTS fraction {b} not a multiple of {a}")
    groups = [sys.update(
        pairwise_inters=tuple(p for p, x in zip(sys.pairwise_inters, pf)
                              if x == f),
        specific_lists=tuple(s for s, x in zip(sys.specific_lists, sf)
                             if x == f),
        general_inters=tuple(g for g, x in zip(sys.general_inters, gf)
                             if x == f)) for f in fractions]
    return fractions, groups


def _level_forces(sim, sys, neighbors, step_n):
    """{"f_lvl<i>": forces of level i's interactions}."""
    _, groups = _mts_fractions(sim, sys)
    return {f"f_lvl{i}": forces_virial(g, neighbors, step_n)[0]
            for i, g in enumerate(groups)}


@dataclasses.dataclass(frozen=True)
class MTSIntegrator(_IntegratorBase):
    """rRESPA multiple time stepping with per-interaction evaluation
    fractions (mollytpu/sim/integrators.py:464-562).

    pi_fractions / si_fractions / gi_fractions give how many times each
    pairwise interaction / bonded list / general interaction is evaluated
    per outer step dt (gi_fractions=(1,) with pi_fractions=(2,) evaluates
    PME once and the pair kernel twice per outer step). The fractions must
    include 1 and each must divide the next; with none given, the bonded
    lists run n_substeps times and everything else once."""

    dt: float
    n_substeps: int = 4
    pi_fractions: tuple = ()
    si_fractions: tuple = ()
    gi_fractions: tuple = ()
    coupling: tuple = ()
    remove_cm: bool = True

    def init_aux(self, sys, neighbors, needs_virial=False):
        aux = _level_forces(self, sys, neighbors, 0)
        aux["forces"] = sum(aux.values())
        aux["virial"] = (
            forces_virial(sys, neighbors, 0, needs_virial=True)[1]
            if needs_virial else torch.zeros(
                (3, 3), dtype=sys.coords.dtype, device=sys.device))
        for c in self.coupling:
            if hasattr(c, "init_state"):
                aux["mc_baro"] = c.init_state(sys)
        return aux

    def _coord_update(self, sys, coords, vels, dt_x, noise, generator):
        """The innermost move: a drift and SHAKE, then the wrap."""
        coords_prev = coords
        coords, vels = _apply_position_constraints(
            sys, coords_prev, coords + dt_x * vels, vels, dt_x)
        return sys.boundary.wrap(coords), vels

    def step(self, sys, neighbors, aux, step_n, generator=None, noise=None,
             needs_virial=False, draws=None):
        """One outer step. ``noise`` (MTSLangevinIntegrator) is an optional
        sequence of (N, 3) standard-normal tensors, one per innermost
        substep in the order they run; without it the noise is drawn from
        ``generator``."""
        fractions, groups = _mts_fractions(self, sys)
        last = len(fractions) - 1
        fl = [aux[f"f_lvl{i}"] for i in range(len(fractions))]
        draws_left = iter(noise) if noise is not None else None
        m = sys.masses

        def recurse(level, coords, vels, n_parent):
            n_sub = fractions[level]
            dt_x = self.dt / n_sub
            for _ in range(n_sub // n_parent):
                vels = vels + 0.5 * dt_x * _accels(m, fl[level])
                if level == last:
                    coords, vels = self._coord_update(
                        sys, coords, vels, dt_x,
                        next(draws_left) if draws_left else None, generator)
                else:
                    coords, vels = recurse(level + 1, coords, vels, n_sub)
                fl[level] = forces_virial(groups[level].update(coords=coords),
                                          neighbors, step_n)[0]
                vels = vels + 0.5 * dt_x * _accels(m, fl[level])
            return coords, vels

        coords, vels = recurse(0, sys.coords, sys.velocities, 1)
        vels = _apply_velocity_constraints(sys, coords, vels)
        sys = sys.update(coords=coords, velocities=vels)
        aux = {**aux, **{f"f_lvl{i}": f for i, f in enumerate(fl)},
               "forces": sum(fl)}
        if needs_virial:
            # all interactions at the final configuration
            aux = {**aux, **_recompute(sys, neighbors, step_n, True)}
        sys, aux = self._finish_step(sys, neighbors, aux, step_n, generator,
                                     needs_virial, draws=draws)
        if self.coupling and forces_invalidated_at(self.coupling, step_n):
            aux = {**aux, **_level_forces(self, sys, neighbors, step_n)}
        return sys, aux


@dataclasses.dataclass(frozen=True)
class MTSLangevinIntegrator(MTSIntegrator):
    """BAOAB-RESPA: rRESPA with an Ornstein-Uhlenbeck step in the middle of
    the innermost move (mollytpu/sim/integrators.py:565-605); fractions as
    in MTSIntegrator. dt in ps, temperature in K, friction in 1/ps."""

    dt: float = 0.002
    temperature: float = 300.0
    friction: float = 1.0

    def _coord_update(self, sys, coords, vels, dt_x, noise, generator):
        m = sys.masses
        positive = m > 0
        safe_m = torch.where(positive, m, torch.ones_like(m))
        coords_prev = coords
        coords = coords + 0.5 * dt_x * vels
        c1 = math.exp(-self.friction * dt_x)
        sigma = torch.sqrt(KB * self.temperature / safe_m) * math.sqrt(
            1.0 - c1 ** 2)
        if noise is None:
            noise = torch.randn(vels.shape, generator=generator,
                                dtype=vels.dtype, device=vels.device)
        vels = c1 * vels + torch.where(positive[:, None],
                                       sigma[:, None] * noise,
                                       torch.zeros_like(vels))
        coords = coords + 0.5 * dt_x * vels
        coords, vels = _apply_position_constraints(sys, coords_prev, coords,
                                                   vels, dt_x)
        return sys.boundary.wrap(coords), vels
