"""The integrators of mollytpu_torch against the JAX package (float64):
Verlet, StormerVerlet, LangevinSplitting, OverdampedLangevin and
NoseHoover for 20 steps on the 64-water box with its rigid waters, the
port fed the JAX chunk runner's draws (simulate.py:71: per step a split,
then per O of a splitting another, integrators.py:283-289);
OverdampedLangevin on the Muller-Brown surface; a user's general
interaction through GeneralInteraction's autograd forces and strain
virial; and the fresh-run start of ``simulate``, held against JAX's
``simulate`` itself from velocities that carry centre-of-mass motion.

The JAX system is the dense reaction-field box (exact, no polynomial
erfc), the port's the same through the bridge on the pair kernel's twin:
after 20 steps of 2 fs the coordinates agree to 1e-7 nm, as the slices'
trajectories do."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt

import mollytpu_torch as pt
from mollytpu_torch.bridge import system_from_arrays
from torch_parity import (CADENCE, CPU, LIST_RADIUS, jax_dense_rf_system,
                          jax_fresh_start, jax_noise_sequence, max_rel, np64)
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DT, TEMP, FRICTION = 0.002, 300.0, 1.0
N_STEPS = 20
TRAJ, VEL = 1e-7, 1e-5


@pytest.fixture(scope="module")
def start():
    js = jax_dense_rf_system()
    ps = system_from_arrays(jax.device_get(js), device=CPU,
                            dist_neighbors=LIST_RADIUS, n_steps=CADENCE)
    return js, ps


def _integrators(m):
    """Each new integrator of module m (mollytpu or mollytpu_torch)."""
    return {
        "verlet": m.Verlet(dt=DT),
        "stormer": m.StormerVerlet(dt=DT),
        "baoab": m.LangevinSplitting(dt=DT, temperature=TEMP,
                                     friction=FRICTION, splitting="BAOAB"),
        "baooab": m.LangevinSplitting(dt=DT, temperature=TEMP,
                                      friction=FRICTION, splitting="BAOOAB"),
        "obaboa": m.LangevinSplitting(dt=DT, temperature=TEMP,
                                      friction=FRICTION, splitting="OBABO"),
        "overdamped": m.OverdampedLangevin(dt=0.0005, temperature=TEMP,
                                           friction=500.0),
        "nose_hoover": m.NoseHoover(dt=DT, temperature=TEMP, damping=0.1),
    }


def jax_draws(sim, key, n_steps, shape):
    """The standard-normal draws of each step of the JAX chunk runner from
    ``key``, as the port's ``noise`` takes them (None: no draws)."""
    name = type(sim).__name__
    if name == "OverdampedLangevin":
        return jax_noise_sequence(key, n_steps, shape)
    if name != "LangevinSplitting":
        return None
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        step = []
        for _ in range(sim.splitting.upper().count("O")):
            sub, o = jax.random.split(sub)
            step.append(torch.as_tensor(np64(jax.random.normal(
                o, shape, jnp.float64))))
        out.append(step)
    return out


def _jax_run(sim, js, key, n_steps):
    chunk = mt.sim.simulate._make_chunk_fn(sim, False, None)
    return jax.jit(lambda s, k: chunk(s, None, sim.init_aux(s, None), k, 0,
                                      n=n_steps))(js, key)


@pytest.mark.parametrize("name", ["baoab", "baooab", "nose_hoover",
                                  "obaboa", "overdamped", "stormer",
                                  "verlet"])
def test_integrator_matches_jax(start, name):
    js, ps = start
    sim_j, sim_p = _integrators(mt)[name], _integrators(pt)[name]
    key = jax.random.PRNGKey(13)
    out_j, _, aux_j, _ = _jax_run(sim_j, jax_fresh_start(js, sim_j), key,
                                  N_STEPS)
    noise = jax_draws(sim_j, key, N_STEPS, (js.n_atoms, 3))
    out_p, nb, aux_p = pt.simulate(
        ps, sim_p, N_STEPS, noise=None if noise is None else noise.__getitem__)
    assert nb.step_built == N_STEPS
    np.testing.assert_allclose(np64(out_p.coords), np64(out_j.coords),
                               rtol=0, atol=TRAJ)
    np.testing.assert_allclose(np64(out_p.velocities),
                               np64(out_j.velocities), rtol=0, atol=VEL)
    assert max_rel(aux_j["forces"], aux_p["forces"]) < 1e-7
    if name == "nose_hoover":
        assert float(aux_p["nh_zeta"]) == pytest.approx(
            float(aux_j["nh_zeta"]), rel=1e-8, abs=1e-12)
    if name == "stormer":
        np.testing.assert_allclose(np64(aux_p["coords_prev"]),
                                   np64(aux_j["coords_prev"]), rtol=0,
                                   atol=TRAJ)
    assert float(out_p.constraints[0].max_violation(
        out_p.coords, out_p.boundary)) < 1e-9


def _muller_brown(m, dtype, device=None):
    """Five unit-mass particles on the Muller-Brown surface in an open
    box."""
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.uniform(-1.2, 0.8, (5, 1)),
                        rng.uniform(-0.2, 1.8, (5, 1)), np.zeros((5, 1))],
                       axis=1)
    if m is mt:
        return mt.System(
            atoms=mt.make_atoms(n=5, mass=1.0, dtype=dtype),
            coords=jnp.asarray(x), boundary=mt.rectangular(
                jnp.full((3,), jnp.inf), dtype=dtype),
            general_inters=(mt.MullerBrown(),), n_dof=15)
    return pt.System(
        atoms=pt.make_atoms(n=5, mass=1.0, dtype=dtype, device=device),
        coords=torch.as_tensor(x, dtype=dtype, device=device),
        boundary=pt.rectangular([float("inf")] * 3, dtype=dtype,
                                device=device),
        general_inters=(pt.MullerBrown(),), n_dof=15)


def test_overdamped_langevin_on_muller_brown_matches_jax():
    js = _muller_brown(mt, jnp.float64)
    ps = _muller_brown(pt, torch.float64, CPU)
    kw = dict(dt=1e-4, temperature=100.0, friction=10.0, remove_cm=False)
    sim_j, sim_p = mt.OverdampedLangevin(**kw), pt.OverdampedLangevin(**kw)
    key = jax.random.PRNGKey(3)
    out_j, _, _, _ = _jax_run(sim_j, js, key, N_STEPS)
    noise = jax_noise_sequence(key, N_STEPS, (5, 3))
    out_p, _, _ = pt.simulate(ps, sim_p, N_STEPS, noise=noise.__getitem__)
    np.testing.assert_allclose(np64(out_p.coords), np64(out_j.coords),
                               rtol=0, atol=1e-10)


def test_general_interaction_forces_and_virial_match_jax():
    """MullerBrown's autograd forces, and GeneralInteraction's isotropic
    strain virial of a user's interaction in a periodic box."""
    js = _muller_brown(mt, jnp.float64)
    ps = _muller_brown(pt, torch.float64, CPU)
    f_j, _ = mt.MullerBrown().force_virial(js.coords, js.boundary, js.atoms)
    f_p, _ = pt.MullerBrown().force_virial(ps.coords, ps.boundary, ps.atoms)
    assert max_rel(f_j, f_p) < 1e-12
    e_j = mt.MullerBrown().energy(js.coords, js.boundary, js.atoms)
    assert float(pt.MullerBrown().energy(ps.coords, ps.boundary, ps.atoms)) \
        == pytest.approx(float(e_j), rel=1e-12)

    class Pairs(pt.GeneralInteraction):
        """sum over the minimum-image pairs of 1 / r^2."""

        def energy(self, coords, boundary, atoms):
            i, j = torch.triu_indices(coords.shape[0], coords.shape[0], 1)
            dr = boundary.displacement(coords[i], coords[j])
            return torch.sum(1.0 / (dr * dr).sum(dim=-1))

    class JaxPairs(mt.GeneralInteraction):
        def energy(self, coords, boundary, atoms):
            i, j = np.triu_indices(coords.shape[0], 1)
            dr = boundary.displacement(coords[i], coords[j])
            return jnp.sum(1.0 / (dr * dr).sum(axis=-1))

    x = np.random.default_rng(5).uniform(0.0, 2.0, (12, 3))
    jb = mt.rectangular(jnp.asarray([2.0, 2.2, 2.4]), dtype=jnp.float64)
    pb = pt.rectangular([2.0, 2.2, 2.4], dtype=torch.float64, device=CPU)
    f_j, v_j = JaxPairs().force_virial(jnp.asarray(x), jb, None, True)
    f_p, v_p = Pairs().force_virial(torch.as_tensor(x), pb, None, True)
    assert max_rel(f_j, f_p) < 1e-12 and max_rel(v_j, v_p) < 1e-12


def test_simulate_removes_cm_motion_before_a_fresh_run(start):
    """pt.simulate against JAX's simulate (not its chunk runner): from
    velocities with a centre-of-mass drift of 0.3 nm/ps, JAX's removes the
    drift before the first step (simulate.py:157-164)."""
    js, ps = start
    drift = np.array([0.3, -0.2, 0.1])
    js = js.update(velocities=js.velocities + jnp.asarray(drift))
    ps = ps.update(velocities=ps.velocities + torch.as_tensor(drift))
    sim_j = mt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)
    sim_p = pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)
    key = jax.random.PRNGKey(17)
    n = 5
    out_j, _ = mt.simulate(js, sim_j, n, key)
    noise = jax_noise_sequence(key, n, (js.n_atoms, 3))
    out_p, _, _ = pt.simulate(ps, sim_p, n, noise=noise.__getitem__)
    np.testing.assert_allclose(np64(out_p.coords), np64(out_j.coords),
                               rtol=0, atol=TRAJ)
    np.testing.assert_allclose(np64(out_p.velocities),
                               np64(out_j.velocities), rtol=0, atol=VEL)
