"""The reaction-field slice of mollytpu_torch (system_from_pdb's
nonbonded_method="cutoff") against the JAX package, in the 64-water cube
and the 64-water rhombic dodecahedron (float64): forces, virial and energy
of the full force field, and 40 chunked Langevin steps at rebuild cadence
20 (two rebuilds) fed the key sequence the JAX chunk runner splits
(simulate.py:71, integrators.py:229), as tests/test_torch_slice.py does for
PME.

Tolerances: the reaction field is exact on both sides (no polynomial
erfc), so forces and virial agree to 1e-9 of their largest entry and the
energy to 1e-9 of its size; after 40 steps of 2 fs the coordinates agree to
1e-6 nm and the velocities to 1e-4 nm/ps, the PME slice's bounds."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.sim.simulate import _make_chunk_fn

import mollytpu_torch as pt
from mollytpu_torch.bridge import system_from_arrays
from torch_parity import (CADENCE, CPU, LIST_RADIUS, jax_forces_virial,
                          jax_neighbors, jax_potential_energy, jax_system,
                          max_rel, np64, port_neighbors, port_system)
from torch_parity import jax_fresh_start
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DT, TEMP, FRICTION = 0.002, 300.0, 1.0
N_STEPS = 2 * CADENCE
EXACT = 1e-9


@pytest.fixture(scope="module", params=["tiny64", "dodeca64"])
def start(request):
    """JAX and port RF systems with the same seeded velocities."""
    js = jax_system(request.param, "cutoff")
    rng = np.random.default_rng(1)
    m = np64(js.atoms.mass)
    v = rng.normal(size=(js.n_atoms, 3)) * np.sqrt(pt.units.KB * TEMP / m)[
        :, None]
    js = js.update(velocities=jnp.asarray(v))
    ps = system_from_arrays(jax.device_get(js), device=CPU,
                            dist_neighbors=LIST_RADIUS, n_steps=CADENCE)
    return request.param, js, ps


def test_rf_port_setup_equals_bridged_system(start):
    name, _, bridged = start
    own = port_system(name, "cutoff")
    assert type(own.boundary) is type(bridged.boundary)
    f1, v1 = pt.forces_virial(own, port_neighbors(own), needs_virial=True)
    f2, v2 = pt.forces_virial(bridged, port_neighbors(bridged),
                              needs_virial=True)
    assert max_rel(f1, f2) < 1e-12 and max_rel(v1, v2) < 1e-12


def test_rf_forces_virial_energy_match(start):
    _, js, ps = start
    nbs = jax_neighbors(js)
    f_j, v_j = jax_forces_virial(js, nbs)
    e_j = jax_potential_energy(js, nbs)
    nb = port_neighbors(ps)
    f_p, v_p = pt.forces_virial(ps, nb, needs_virial=True)
    e_p = pt.potential_energy(ps, nb)
    assert max_rel(f_j, f_p) < EXACT
    assert max_rel(v_j, v_p) < EXACT
    assert abs(float(e_p) - float(e_j)) < EXACT * max(1.0, abs(float(e_j)))


def test_rf_chunked_steps_with_rebuilds_match(start):
    _, js, ps = start
    sim_j = mt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)
    nbs = jax_neighbors(js)
    key = jax.random.PRNGKey(7)
    run = jax.jit(partial(_make_chunk_fn(sim_j, False, js.neighbor_finder,
                                         align=0), n=N_STEPS))
    out_j, _, _, _ = run(jax_fresh_start(js, sim_j), nbs,
                         sim_j.init_aux(js, nbs), key, 0)

    noise = []
    for _ in range(N_STEPS):
        key, sub = jax.random.split(key)
        noise.append(np.array(jax.random.normal(sub, (js.n_atoms, 3),
                                                jnp.float64)))
    sim_p = pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)
    out_p, nb, _ = pt.simulate(ps, sim_p, N_STEPS,
                               noise=lambda k: torch.as_tensor(noise[k]))
    assert nb.step_built == N_STEPS
    np.testing.assert_allclose(np64(out_p.coords), np64(out_j.coords),
                               atol=1e-6)
    np.testing.assert_allclose(np64(out_p.velocities),
                               np64(out_j.velocities), atol=1e-4)
    viol = float(out_p.constraints[0].max_violation(out_p.coords,
                                                    out_p.boundary))
    assert viol < 1e-9
