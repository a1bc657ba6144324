"""The whole PME water-box slice of mollytpu_torch against the JAX package
on the 64-water box (float64): forces, virial and energy of the full force
field; one Langevin step fed JAX's own noise; 40 chunked steps at rebuild
cadence 20 (two rebuilds) fed the same key sequence the JAX chunk runner
splits (simulate.py:71, integrators.py:229).

Tolerances: the JAX pair kernel's polynomial erfc (< 6e-7 abs) makes pair
forces differ by ~1e-7 of their largest entry; over 40 steps of 2 fs that
moves coordinates by far less than 1e-7 nm and velocities by less than
1e-4 nm/ps, the bounds used below. The port system is built from the JAX
one through the bridge, and directly by its own setup; both must agree."""

from functools import partial

import jax
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.sim.simulate import _make_chunk_fn

import mollytpu_torch as pt
from mollytpu_torch.bridge import system_from_arrays
from torch_parity import (CADENCE, CPU, LIST_RADIUS, jax_forces_virial,
                          jax_neighbors, jax_noise_sequence,
                          jax_potential_energy, jax_system, max_rel, np64,
                          port_neighbors, port_system, seeded_velocities)
from torch_parity import jax_fresh_start
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DT, TEMP, FRICTION = 0.002, 300.0, 1.0
N_STEPS = 2 * CADENCE


@pytest.fixture(scope="module")
def start():
    """JAX and port systems with the same seeded velocities."""
    js = seeded_velocities(jax_system("tiny64"), temp=TEMP)
    ps = system_from_arrays(jax.device_get(js), device=CPU,
                            dist_neighbors=LIST_RADIUS, n_steps=CADENCE)
    return js, ps


def test_port_setup_equals_bridged_system(start):
    _, bridged = start
    own = port_system("tiny64")
    f1, v1 = pt.forces_virial(own, port_neighbors(own), needs_virial=True)
    f2, v2 = pt.forces_virial(bridged, port_neighbors(bridged),
                              needs_virial=True)
    assert max_rel(f1, f2) < 1e-12 and max_rel(v1, v2) < 1e-12


def test_forces_virial_energy_match(start):
    js, ps = start
    nbs = jax_neighbors(js)
    f_j, v_j = jax_forces_virial(js, nbs)
    e_j = jax_potential_energy(js, nbs)
    nb = port_neighbors(ps)
    f_p, v_p = pt.forces_virial(ps, nb, needs_virial=True)
    e_p = pt.potential_energy(ps, nb)
    assert max_rel(f_j, f_p) < 2e-6
    assert max_rel(v_j, v_p) < 2e-5
    # the polynomial erfc error summed over ~1e4 pair terms of ~1e4 kJ/mol
    assert abs(float(e_p) - float(e_j)) < 2e-2


def test_one_langevin_step_with_jax_noise(start):
    js, ps = start
    sim_j = mt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)
    nbs = jax_neighbors(js)
    key = jax.random.PRNGKey(3)
    noise = jax_noise_sequence(key, 1, (js.n_atoms, 3))[0]

    @jax.jit
    def jstep(sys, nbs):
        aux = sim_j.init_aux(sys, nbs)
        _, sub = jax.random.split(key)
        return sim_j.step(sys, nbs, aux, 0, sub)[0]

    out_j = jstep(js, nbs)
    sim_p = pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)
    nb = port_neighbors(ps)
    out_p, _ = sim_p.step(ps, nb, sim_p.init_aux(ps, nb), 0, noise=noise)
    np.testing.assert_allclose(np64(out_p.coords), np64(out_j.coords),
                               atol=1e-9)
    np.testing.assert_allclose(np64(out_p.velocities),
                               np64(out_j.velocities), atol=1e-6)


def test_chunked_steps_with_rebuilds_match(start):
    js, ps = start
    sim_j = mt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)
    nbs = jax_neighbors(js)
    key = jax.random.PRNGKey(7)
    run = jax.jit(partial(_make_chunk_fn(sim_j, False, js.neighbor_finder,
                                         align=0), n=N_STEPS))
    out_j, _, _, _ = run(jax_fresh_start(js, sim_j), nbs,
                         sim_j.init_aux(js, nbs), key, 0)

    noise = jax_noise_sequence(key, N_STEPS, (js.n_atoms, 3))
    sim_p = pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)
    out_p, nb, _ = pt.simulate(ps, sim_p, N_STEPS, noise=lambda k: noise[k])
    assert nb.step_built == N_STEPS
    np.testing.assert_allclose(np64(out_p.coords), np64(out_j.coords),
                               atol=1e-7)
    np.testing.assert_allclose(np64(out_p.velocities),
                               np64(out_j.velocities), atol=1e-4)
    viol = float(out_p.constraints[0].max_violation(out_p.coords,
                                                    out_p.boundary))
    assert viol < 1e-9
    assert np.isfinite(float(pt.temperature(out_p.masses, out_p.velocities,
                                            out_p.n_dof)))


def test_simulate_with_generator_runs():
    """The generator path (no injected noise): finite, constrained, and
    reproducible for a fixed seed."""
    ps = port_system("tiny64")
    sim = pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(0)
        v0 = pt.random_velocities(ps.masses, TEMP, gen)
        out, _, _ = pt.simulate(ps.update(velocities=v0), sim, 5,
                                generator=gen)
        outs.append(out)
    assert torch.equal(outs[0].coords, outs[1].coords)
    assert torch.all(torch.isfinite(outs[0].coords))
    assert float(outs[0].constraints[0].max_violation(
        outs[0].coords, outs[0].boundary)) < 1e-9
