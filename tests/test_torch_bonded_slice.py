"""The Bonded-PME slice of mollytpu_torch against the JAX package on the
64-water box with flexible H-O-H angles (constraints="hbonds",
rigid_water=False: the O-H bonds are constrained, the 64 angles stay
harmonic terms), float64: the system built by the port's setup and through
the bridge; forces, virial and energy; 40 chunked Langevin steps at rebuild
cadence 20 fed the JAX chunk runner's noise.

Tolerances are those of tests/test_torch_slice.py: the JAX pair kernel's
polynomial erfc (< 6e-7 abs) makes pair forces differ by ~1e-7 of their
largest entry, which over 40 steps moves coordinates by far less than
1e-7 nm and velocities by less than 1e-4 nm/ps."""

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


def _start():
    js = seeded_velocities(jax_system("tiny64", rigid=False))
    ps = system_from_arrays(jax.device_get(js), device=CPU,
                            dist_neighbors=LIST_RADIUS, n_steps=CADENCE)
    return js, ps


def test_forces_virial_energy_match():
    js, ps = _start()
    assert [s.n_terms for s in ps.specific_lists] == [0, 64]
    own = port_system("tiny64", rigid=False)
    nb = port_neighbors(ps)
    f_p, v_p = pt.forces_virial(ps, nb, needs_virial=True)
    f_o, v_o = pt.forces_virial(own, port_neighbors(own), needs_virial=True)
    assert max_rel(f_o, f_p) < 1e-12 and max_rel(v_o, v_p) < 1e-12
    nbs = jax_neighbors(js)
    f_j, v_j = jax_forces_virial(js, nbs)
    assert max_rel(f_j, f_p) < 2e-6
    assert max_rel(v_j, v_p) < 2e-5
    assert abs(float(pt.potential_energy(ps, nb))
               - float(jax_potential_energy(js, nbs))) < 2e-2
    # the angles are in those forces: without them they differ
    f_nb, _ = pt.forces_virial(ps.update(specific_lists=()), nb)
    assert max_rel(f_p, f_nb) > 1e-3


def test_chunked_steps_with_rebuilds_match():
    js, ps = _start()
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
    assert float(out_p.constraints[0].max_violation(
        out_p.coords, out_p.boundary)) < 1e-9
    # the angles moved off their start
    theta = pt.specific_energy(out_p.specific_lists[1], out_p.coords,
                               out_p.boundary)
    assert float(theta) != float(pt.specific_energy(
        ps.specific_lists[1], ps.coords, ps.boundary))
    assert torch.isfinite(out_p.velocities).all()
