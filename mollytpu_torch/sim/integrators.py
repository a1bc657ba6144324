"""Integrators: velocity Verlet, leapfrog Verlet, Stormer-Verlet, Langevin
(BAOA middle scheme), Langevin of any A/B/O splitting, overdamped
Langevin, Nose-Hoover, DPD velocity Verlet and the multiple-time-step
MTSIntegrator (rRESPA) and MTSLangevinIntegrator (BAOAB-RESPA), with
thermostat and barostat coupling (counterpart of
mollytpu/sim/integrators.py).

Contract as in the JAX package:

    init_aux(sys, neighbors, needs_virial) -> aux  (forces cache, coupler
        state)
    step(sys, neighbors, aux, step_n, generator, needs_virial, draws)
        -> (sys, aux)

A stochastic step takes its standard-normal draws from ``generator``, or
from ``noise`` where the caller injects them (the tests feed the JAX
package's draws): an (N, 3) tensor for Langevin and OverdampedLangevin, a
sequence of one per O for LangevinSplitting. Every step but
Stormer-Verlet's ends in ``_finish_step``: centre-of-mass motion removal,
then the couplers, then a recompute of the forces, and of the virial where
it is due, if a coupler moved coordinates or the box. The host knows step_n,
so the recompute runs only on the steps where such a coupler acted (the
JAX package recomputes after every step when any coupler could move them;
the forces are the same). ``needs_virial`` is the
step's own: the caller asks for it on the steps whose pressure a coupler
reads (sim.coupling.virial_due); aux["virial"] holds the virial at the
step's final coordinates and box.

Virtual sites are placed from their parents after the constraints and the
wrap, before the forces are recomputed, in every integrator but DPD's
velocity Verlet; the MTS integrators place them once per outer step, as
the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..forces import forces_virial
from ..spatial import (kinetic_energy, kinetic_energy_tensor,
                       remove_cm_motion)
from ..tracing import span
from ..units import KB
from .coupling import apply_couplers, forces_invalidated_at


def _accels(masses, forces):
    positive = masses > 0
    safe = torch.where(positive, masses, torch.ones_like(masses))
    return torch.where(positive[:, None], forces / safe[:, None],
                       torch.zeros_like(forces))


def _apply_position_constraints(sys, coords_prev, coords_new, vels, dt):
    if not sys.constraints:
        return coords_new, vels
    with span("md.constraints"):
        for c in sys.constraints:
            coords_new, vels = c.apply_position_constraints(
                coords_prev, coords_new, vels, sys.masses, sys.boundary, dt)
    return coords_new, vels


def _apply_velocity_constraints(sys, coords, vels):
    if not sys.constraints:
        return vels
    with span("md.constraints"):
        for c in sys.constraints:
            vels = c.apply_velocity_constraints(coords, vels, sys.masses,
                                                sys.boundary)
    return vels


def _placed(sys, coords):
    """The coordinates wrapped into the box, with the virtual sites set
    from their parents (mollytpu/sim/integrators.py:68-71)."""
    coords = sys.boundary.wrap(coords)
    if sys.virtual_sites is not None:
        coords = sys.virtual_sites.place(coords, sys.boundary)
    return coords


def _recompute(sys, neighbors, step_n, needs_virial):
    f, v = forces_virial(sys, neighbors, step_n, needs_virial=needs_virial)
    return {"forces": f, "virial": v}


def _normal(like, generator):
    return torch.randn(like.shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def _masked_noise(m, sigma, noise):
    """sigma_i * noise_i on atoms of positive mass, 0 elsewhere."""
    return torch.where((m > 0)[:, None], sigma[:, None] * noise,
                       torch.zeros_like(noise))


def _safe_masses(m):
    return torch.where(m > 0, m, torch.ones_like(m))


class _IntegratorBase:

    def init_aux(self, sys, neighbors, needs_virial=False):
        aux = _recompute(sys, neighbors, 0, needs_virial)
        aux.update(self.extra_state(sys))
        for c in self.coupling:
            if hasattr(c, "init_state"):
                aux["mc_baro"] = c.init_state(sys)
        return aux

    def extra_state(self, sys):
        """The integrator's own state in aux beyond forces and virial."""
        return {}

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
            with span("md.couple"):
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
        sys = sys.update(coords=_placed(sys, coords), velocities=vels)
        aux = {**aux, **_recompute(sys, neighbors, step_n, needs_virial)}
        vels = sys.velocities + 0.5 * dt * _accels(m, aux["forces"])
        sys = sys.update(velocities=_apply_velocity_constraints(
            sys, sys.coords, vels))
        kin_t = (kinetic_energy_tensor(m, sys.velocities) if needs_virial
                 else None)
        return self._finish_step(sys, neighbors, aux, step_n, generator,
                                 needs_virial, kin_t, draws)


@dataclasses.dataclass(frozen=True)
class Verlet(_IntegratorBase):
    """Leapfrog Verlet: v(t + dt/2) from a(t), then the drift; velocities
    are offset by half a step (mollytpu/sim/integrators.py:146-170)."""

    dt: float
    coupling: tuple = ()
    remove_cm: bool = True

    def step(self, sys, neighbors, aux, step_n, generator=None,
             needs_virial=False, draws=None):
        dt = self.dt
        vels = sys.velocities + dt * _accels(sys.masses, aux["forces"])
        vels = _apply_velocity_constraints(sys, sys.coords, vels)
        coords_prev = sys.coords
        coords, vels = _apply_position_constraints(
            sys, coords_prev, sys.coords + dt * vels, vels, dt)
        sys = sys.update(coords=_placed(sys, coords), velocities=vels)
        aux = {**aux, **_recompute(sys, neighbors, step_n, needs_virial)}
        return self._finish_step(sys, neighbors, aux, step_n, generator,
                                 needs_virial, draws=draws)


@dataclasses.dataclass(frozen=True)
class StormerVerlet(_IntegratorBase):
    """Position Verlet x(t + dt) = 2 x(t) - x(t - dt) + a dt^2, with
    x(t - dt) in aux["coords_prev"] and O(dt) velocities; no couplers and
    no centre-of-mass removal (mollytpu/sim/integrators.py:173-202)."""

    dt: float
    coupling: tuple = ()
    remove_cm: bool = False

    def extra_state(self, sys):
        return {"coords_prev": sys.coords - sys.velocities * self.dt}

    def step(self, sys, neighbors, aux, step_n, generator=None,
             needs_virial=False, draws=None):
        dt = self.dt
        a_t = _accels(sys.masses, aux["forces"])
        disp_prev = sys.boundary.displacement(aux["coords_prev"], sys.coords)
        vels = (disp_prev + a_t * dt * dt) / dt
        coords_prev = sys.coords
        coords, vels = _apply_position_constraints(
            sys, coords_prev, sys.coords + disp_prev + a_t * dt * dt, vels,
            dt)
        sys = sys.update(coords=_placed(sys, coords), velocities=vels)
        aux = {**aux, "coords_prev": coords_prev,
               **_recompute(sys, neighbors, step_n, needs_virial)}
        return sys, aux


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
        sigma = torch.sqrt(KB * self.temperature / _safe_masses(m)) * \
            math.sqrt(1.0 - c1 ** 2)
        if noise is None:
            noise = _normal(vels, generator)
        vels = c1 * vels + _masked_noise(m, sigma, noise)
        vels = _apply_velocity_constraints(sys, coords, vels)
        # A: half drift
        coords = coords + 0.5 * dt * vels
        coords, vels = _apply_position_constraints(sys, coords_prev, coords,
                                                   vels, dt)
        sys = sys.update(coords=_placed(sys, coords), velocities=vels)
        aux = {**aux, **_recompute(sys, neighbors, step_n, needs_virial)}
        return self._finish_step(sys, neighbors, aux, step_n, generator,
                                 needs_virial, draws=draws)


@dataclasses.dataclass(frozen=True)
class LangevinSplitting(_IntegratorBase):
    """Langevin of any A/B/O splitting, e.g. "BAOAB"; a letter that repeats
    divides the step among its occurrences. The forces are recomputed, and
    the position constraints applied from the step's start, at the last A
    only; each O draws its own noise, in order
    (mollytpu/sim/integrators.py:246-302)."""

    dt: float
    temperature: float
    friction: float
    splitting: str = "BAOAB"
    coupling: tuple = ()
    remove_cm: bool = True

    def step(self, sys, neighbors, aux, step_n, generator=None, noise=None,
             needs_virial=False, draws=None):
        """``noise`` is an optional sequence of (N, 3) standard-normal
        tensors, one per O in the order they run."""
        s = self.splitting.upper()
        n_a, n_b, n_o = (s.count(ch) or 1 for ch in "ABO")
        dt, m = self.dt, sys.masses
        c1 = math.exp(-self.friction * dt / n_o)
        sigma = torch.sqrt(KB * self.temperature / _safe_masses(m)) * \
            math.sqrt(1.0 - c1 ** 2)
        draws_left = iter(noise) if noise is not None else None
        coords, vels = sys.coords, sys.velocities
        coords_prev = coords
        a_cur = _accels(m, aux["forces"])
        last_a = s.rfind("A")
        for i, ch in enumerate(s):
            if ch == "A":
                coords = coords + (dt / n_a) * vels
                if i == last_a:
                    coords, vels = _apply_position_constraints(
                        sys, coords_prev, coords, vels, dt)
                    new = _recompute(
                        sys.update(coords=sys.boundary.wrap(coords)),
                        neighbors, step_n, needs_virial)
                    aux = {**aux, **new}
                    a_cur = _accels(m, new["forces"])
            elif ch == "B":
                vels = vels + (dt / n_b) * a_cur
            elif ch == "O":
                z = next(draws_left) if draws_left else _normal(vels,
                                                                generator)
                vels = c1 * vels + _masked_noise(m, sigma, z)
        vels = _apply_velocity_constraints(sys, coords, vels)
        sys = sys.update(coords=_placed(sys, coords), velocities=vels)
        return self._finish_step(sys, neighbors, aux, step_n, generator,
                                 needs_virial, draws=draws)


@dataclasses.dataclass(frozen=True)
class OverdampedLangevin(_IntegratorBase):
    """Euler-Maruyama Brownian dynamics, friction in 1/ps
    (mollytpu/sim/integrators.py:305-335)."""

    dt: float
    temperature: float
    friction: float
    coupling: tuple = ()
    remove_cm: bool = True

    def step(self, sys, neighbors, aux, step_n, generator=None, noise=None,
             needs_virial=False, draws=None):
        """``noise`` is an optional (N, 3) standard-normal tensor."""
        dt, m = self.dt, sys.masses
        if noise is None:
            noise = _normal(sys.coords, generator)
        sigma = torch.sqrt(2.0 * KB * self.temperature * dt
                           / (self.friction * _safe_masses(m)))
        coords_prev = sys.coords
        coords = (sys.coords + _accels(m, aux["forces"]) * dt / self.friction
                  + _masked_noise(m, sigma, noise))
        coords, vels = _apply_position_constraints(
            sys, coords_prev, coords, sys.velocities, dt)
        sys = sys.update(coords=_placed(sys, coords), velocities=vels)
        aux = {**aux, **_recompute(sys, neighbors, step_n, needs_virial)}
        return self._finish_step(sys, neighbors, aux, step_n, generator,
                                 needs_virial, draws=draws)


@dataclasses.dataclass(frozen=True)
class NoseHoover(_IntegratorBase):
    """Single-chain Nose-Hoover thermostat on velocity Verlet, damping
    tau_T in ps; the friction zeta lives in aux["nh_zeta"]
    (mollytpu/sim/integrators.py:338-378). The step evaluates the forces
    once, at the new positions; the next step reuses them."""

    dt: float
    temperature: float
    damping: float = 0.1
    coupling: tuple = ()
    remove_cm: bool = True

    def extra_state(self, sys):
        return {"nh_zeta": torch.zeros((), dtype=sys.coords.dtype,
                                       device=sys.device)}

    def step(self, sys, neighbors, aux, step_n, generator=None,
             needs_virial=False, draws=None):
        dt, m = self.dt, sys.masses
        zeta = aux["nh_zeta"]
        vels = sys.velocities + 0.5 * dt * (_accels(m, aux["forces"])
                                            - zeta * sys.velocities)
        vels = _apply_velocity_constraints(sys, sys.coords, vels)
        coords_prev = sys.coords
        coords, vels = _apply_position_constraints(
            sys, coords_prev, sys.coords + dt * vels, vels, dt)
        sys = sys.update(coords=_placed(sys, coords), velocities=vels)
        ke = kinetic_energy(m, vels)
        ke_target = 0.5 * (sys.n_dof + 1) * KB * self.temperature
        zeta = zeta + dt * (ke - ke_target) / (ke_target * self.damping ** 2)
        aux = {**aux, "nh_zeta": zeta,
               **_recompute(sys, neighbors, step_n, needs_virial)}
        vels = (vels + 0.5 * dt * _accels(m, aux["forces"])) / (
            1.0 + 0.5 * dt * zeta)
        sys = sys.update(velocities=_apply_velocity_constraints(
            sys, sys.coords, vels))
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
        if sys.virtual_sites is not None:
            # once per outer step: the inner force evaluations see the
            # sites where the last outer step left them, as in JAX
            coords = sys.virtual_sites.place(coords, sys.boundary)
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
        coords_prev = coords
        coords = coords + 0.5 * dt_x * vels
        c1 = math.exp(-self.friction * dt_x)
        sigma = torch.sqrt(KB * self.temperature / _safe_masses(m)) * \
            math.sqrt(1.0 - c1 ** 2)
        if noise is None:
            noise = _normal(vels, generator)
        vels = c1 * vels + _masked_noise(m, sigma, noise)
        coords = coords + 0.5 * dt_x * vels
        coords, vels = _apply_position_constraints(sys, coords_prev, coords,
                                                   vels, dt_x)
        return sys.boundary.wrap(coords), vels
