"""Thermostats and barostats of mollytpu_torch (sim/coupling.py) against
the JAX package's (mollytpu/sim/coupling.py), float64, on the 64-water
reaction-field box: the JAX package on its dense all-pairs path, the port
on its cluster-pair list and the pair kernel's plain twin, both systems
the same arrays (bridge.system_from_arrays). Each coupler's ``apply`` is
fed the draws the JAX package takes from the same key; then velocity
Verlet with each thermostat runs 20 steps.

Tolerances:
- no energy evaluated (thermostats, Berendsen and C-rescale barostats): the
  same formulas on both sides, 1e-12 relative;
- the Monte Carlo barostat's two trial energies: reaction-field terms are
  exact on both sides and differ by summation order only, 1e-9 of
  max(1, |E|) (the bound tests/test_torch_k1b.py holds the list against
  the dense path to); the accept decisions must be the same, and then the
  box and coordinates agree to 1e-12;
- 20 velocity Verlet steps: forces agree to ~1e-12, so coordinates to 1e-9
  nm and velocities to 1e-7 nm/ps leave decades.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.sim.simulate import _make_chunk_fn

import mollytpu_torch as pt
from mollytpu_torch.bridge import system_from_arrays
from torch_parity import (CADENCE, CPU, LIST_RADIUS, jax_coupler_draws,
                          jax_dense_rf_system, jax_step_draws, max_rel, np64,
                          port_neighbors)
from torch_parity import jax_fresh_start
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL, ENERGY = 1e-12, 1e-9
DT, TEMP = 0.002, 300.0
P_BAR = pt.units.BAR

#: thermostats by name: (JAX, port); Andersen at dt / tau = 0.2 so that
#: about a fifth of the atoms are redrawn per step
THERMOSTATS = {
    "immediate": lambda m: m.ImmediateThermostat(TEMP),
    "bussi": lambda m: m.VelocityRescaleThermostat(TEMP, 0.1),
    "andersen": lambda m: m.AndersenThermostat(TEMP, 0.01),
    "berendsen": lambda m: m.BerendsenThermostat(TEMP, 0.1),
}


@pytest.fixture(scope="module")
def start():
    js = jax_dense_rf_system()
    ps = system_from_arrays(jax.device_get(js), device=CPU,
                            dist_neighbors=LIST_RADIUS, n_steps=CADENCE)
    return js, ps


def _draws(coupler, key, sys):
    return jax_coupler_draws(coupler, key, sys.n_atoms, sys.n_dof)


#: the JAX energy, compiled once for every test of the file
jax_energy = jax.jit(mt.potential_energy)


@pytest.mark.parametrize("name", sorted(THERMOSTATS))
def test_thermostat_apply_matches_jax(start, name):
    js, ps = start
    cj, cp = THERMOSTATS[name](mt), THERMOSTATS[name](pt)
    key = jax.random.PRNGKey(5)
    out_j, _ = cj.apply(js, {}, DT, 0, key)
    out_p, _ = cp.apply(ps, {}, DT, 0, draws=_draws(cj, key, js))
    assert max_rel(out_j.velocities, out_p.velocities) < TOL
    assert torch.equal(out_p.coords, ps.coords)
    if name == "andersen":
        redrawn = np.any(np64(out_p.velocities) != np64(ps.velocities),
                         axis=1)
        assert 10 < redrawn.sum() < ps.n_atoms - 10


def _virial_inputs(seed):
    """A symmetric kinetic tensor and virial (kJ/mol) from a seed."""
    rng = np.random.default_rng(seed)
    k, w = rng.normal(size=(3, 3)), rng.normal(size=(3, 3))
    return 200.0 * np.eye(3) + 5.0 * (k + k.T), 300.0 * (w + w.T)


@pytest.mark.parametrize("kind, molecular", [
    ("berendsen", False), ("berendsen", True), ("crescale", False),
    ("crescale", True)])
def test_pressure_coupler_apply_matches_jax(start, kind, molecular):
    """Box, coordinates and velocities after one move from the same
    kinetic tensor and virial, and no move off the coupler's schedule."""
    js, ps = start
    kin, vir = _virial_inputs(3)

    def make(m):
        if kind == "berendsen":
            return m.BerendsenBarostat(P_BAR, 0.5, n_steps=5,
                                       scale_molecules=molecular)
        return m.CRescaleBarostat(P_BAR, TEMP, 0.5, n_steps=5,
                                  scale_molecules=molecular)

    cj, cp = make(mt), make(pt)
    key = jax.random.PRNGKey(9)
    draws = _draws(cj, key, js)
    for step_n in (10, 3):
        out_j, _ = cj.apply(js, {}, DT, step_n, key, jnp.asarray(kin),
                            jnp.asarray(vir))
        out_p, _ = cp.apply(ps, {}, DT, step_n, None, torch.as_tensor(kin),
                            torch.as_tensor(vir), draws=draws)
        assert cp.acts(step_n) == (step_n % 5 == 0)
        np.testing.assert_allclose(np64(out_p.boundary.side_lengths),
                                   np64(out_j.boundary.side_lengths),
                                   rtol=TOL)
        assert max_rel(out_j.coords, out_p.coords) < TOL
        assert max_rel(out_j.velocities, out_p.velocities) < TOL
    assert torch.equal(out_p.coords, ps.coords)


#: (coupling, scale_molecules, pressure in bar): the high pressure makes
#: expansions lose, so both decisions occur among the keys
MC_CASES = [("isotropic", True, 1.0), ("isotropic", False, 3000.0),
            ("anisotropic", True, 3000.0), ("semiisotropic", False, 1.0)]


@pytest.mark.parametrize("coupling, molecular, bar", MC_CASES)
def test_mc_barostat_apply_matches_jax(start, coupling, molecular, bar):
    """Four attempts from the same state with four keys: the trial
    energies, the decision, the box, the coordinates and the adapted
    state."""
    js, ps = start
    kw = dict(n_steps=1, scale_molecules=molecular, coupling=coupling)
    cj = mt.MonteCarloBarostat(bar * P_BAR, TEMP, **kw)
    cp = pt.MonteCarloBarostat(bar * P_BAR, TEMP, **kw)
    nb = port_neighbors(ps)
    e_old = float(pt.potential_energy(ps, nb))
    assert abs(e_old - float(jax_energy(js))) < ENERGY * max(1.0, abs(e_old))
    apply_j = jax.jit(lambda s, a, k: cj.apply(s, a, DT, 0, k))
    decisions = []
    aux_j, aux_p = {"mc_baro": cj.init_state(js)}, {
        "mc_baro": cp.init_state(ps)}
    for seed in range(4):
        key = jax.random.PRNGKey(100 + seed)
        draws = _draws(cj, key, js)
        # the trial the port evaluates, at its own box
        s_vol = 1.0 + draws["dv"] * aux_p["mc_baro"]["scale"] / \
            ps.boundary.volume()
        mu = cp._mu(s_vol, draws, ps.coords)
        out_j, aux_j = apply_j(js, aux_j, key)
        out_p, aux_p = cp.apply(ps, aux_p, DT, 0, draws=draws, neighbors=nb)
        trial = pt.sim.coupling._scale(ps, mu, molecular)
        trial_j = js.update(coords=jnp.asarray(np64(trial.coords)),
                            boundary=mt.rectangular(jnp.asarray(np64(
                                trial.boundary.side_lengths)),
                                dtype=jnp.float64))
        e_p = float(pt.potential_energy(trial, nb))
        assert abs(e_p - float(jax_energy(trial_j))) < ENERGY * max(
            1.0, abs(e_p))
        accepted = int(aux_p["mc_baro"]["accepted"])
        assert accepted == int(aux_j["mc_baro"]["accepted"])
        decisions.append(accepted)
        np.testing.assert_allclose(np64(out_p.boundary.side_lengths),
                                   np64(out_j.boundary.side_lengths),
                                   rtol=TOL)
        assert max_rel(out_j.coords, out_p.coords) < TOL
        assert float(aux_p["mc_baro"]["scale"]) == pytest.approx(
            float(aux_j["mc_baro"]["scale"]), rel=TOL)
    # both decisions occur: the count rose on some attempts, not on all
    steps = np.diff([0] + decisions)
    assert steps.any() and not steps.all()


@pytest.mark.parametrize("name", sorted(THERMOSTATS))
def test_velocity_verlet_with_thermostat_matches_jax(start, name):
    """20 steps from the same state, the thermostat fed the JAX chunk
    runner's draws; the port crosses one list rebuild (cadence 20)."""
    js, ps = start
    n_steps = 20
    sim_j = mt.VelocityVerlet(dt=DT, coupling=(THERMOSTATS[name](mt),))
    sim_p = pt.VelocityVerlet(dt=DT, coupling=(THERMOSTATS[name](pt),))
    key = jax.random.PRNGKey(11)
    chunk = _make_chunk_fn(sim_j, False, None)
    out_j = jax.jit(lambda s, k: chunk(s, None, sim_j.init_aux(s, None), k,
                                       0, n=n_steps)[0])(jax_fresh_start(js, sim_j), key)
    _, draws = jax_step_draws(key, n_steps, js.n_atoms, js.n_dof,
                              sim_j.coupling)
    out_p, nb, _ = pt.simulate(ps, sim_p, n_steps,
                               draws=lambda k: draws[k])
    assert nb.step_built == n_steps
    np.testing.assert_allclose(np64(out_p.coords), np64(out_j.coords),
                               atol=1e-9)
    np.testing.assert_allclose(np64(out_p.velocities),
                               np64(out_j.velocities), atol=1e-7)
