"""The PME slice in the rhombic dodecahedron (system_from_pdb's
nonbonded_method="pme" in a triclinic box) against the JAX package on the
64-water dodecahedron, float64: the built system (atom parameters,
exclusions, constraints, PME mesh and moduli, the exclusion correction's
pairs), the whole force field, the pair kernel's twin against JAX's
Pallas kernel in interpret mode, and 40 Langevin steps with rebuilds at
cadence 20 fed JAX's noise.

Tolerances:
- the force field against JAX's dense all-pairs engine with the exact
  erfc (approximate_pme=False, PME as built): forces, virial and energy
  within 1e-9 relative;
- the pair kernel's twin against the Pallas kernel: its Ewald erfc is a
  degree-14 polynomial (< 6e-7 absolute, pallas_pairwise.py:65-69), an
  absolute error per pair term, so the pair forces get an absolute bound,
  5e-5 kJ/mol/nm (the lattice start's pair forces peak near 6 kJ/mol/nm,
  where the cube's relative 2e-6 would be 1.2e-5; the largest difference
  here is 1.3e-5), the virial (~1e4 cancelling Coulomb pair terms) 2e-5
  relative, as tests/test_torch_pair_kernel.py holds the cube, and the
  full force field 2e-6 relative as tests/test_torch_slice.py does;
- the trajectory against JAX's chunk runner on the exact dense system:
  after 40 steps of 2 fs the coordinates agree to 1e-7 nm and the
  velocities to 1e-4 nm/ps, the PME cube's bounds."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.models.forcefield import ForceField as JaxForceField
from mollytpu.models.setup import system_from_pdb as jax_system_from_pdb
from mollytpu.ops.pallas_pairwise import (build_fused_spec,
                                          pallas_block_nonbonded)
from mollytpu.sim.simulate import _make_chunk_fn

import mollytpu_torch as pt
from mollytpu_torch.bridge import pairs_from_bitmap, system_from_arrays
from mollytpu_torch.ops import pair_kernel
from torch_parity import (CADENCE, CPU, LIST_RADIUS, box_path,
                          jax_forces_virial, jax_fresh_start,
                          jax_noise_sequence, jax_neighbors,
                          jax_potential_energy, jax_system, max_rel, np64,
                          port_neighbors, port_system, seeded_velocities)
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BOX = "dodeca64"
DT, TEMP, FRICTION = 0.002, 300.0, 1.0
N_STEPS = 2 * CADENCE
EXACT, POLY, POLY_SUM, POLY_FORCE = 1e-9, 2e-6, 2e-5, 5e-5


@pytest.fixture(scope="module")
def exact():
    """JAX's dodecahedron PME system on its dense all-pairs engine with the
    exact erfc and the PME of the default build (smoothed mesh), seeded
    velocities; and the port's system bridged from it."""
    js = jax_system_from_pdb(
        box_path(BOX), JaxForceField(pt.TIP3P_XML), nonbonded_method="pme",
        dtype=jnp.float64, constraints="hbonds", rigid_water=True,
        approximate_pme=False, build_cache=False, neighbor_finder=None)
    inters = tuple(dataclasses.replace(i, use_neighbors=False)
                   for i in js.pairwise_inters)
    general = (jax_system(BOX).general_inters[0],) + js.general_inters[1:]
    js = seeded_velocities(js.update(pairwise_inters=inters,
                                     general_inters=general), temp=TEMP)
    ps = system_from_arrays(jax.device_get(js), device=CPU,
                            dist_neighbors=LIST_RADIUS, n_steps=CADENCE)
    return js, ps


def test_dodecahedron_pme_system_matches_jax():
    js, ps = jax_system(BOX), port_system(BOX)
    assert isinstance(ps.boundary, pt.Triclinic)
    np.testing.assert_allclose(np64(ps.boundary.basis),
                               np64(js.boundary.basis), rtol=0, atol=1e-12)
    np.testing.assert_allclose(np64(ps.coords), np64(js.coords), rtol=0,
                               atol=1e-12)
    for field in ("mass", "charge", "sigma", "epsilon"):
        np.testing.assert_allclose(np64(getattr(ps.atoms, field)),
                                   np64(getattr(js.atoms, field)), rtol=0,
                                   atol=1e-12, err_msg=field)
    for field in ("excl_i", "excl_j", "spec_i", "spec_j", "excl_bits",
                  "spec_bits", "far_excl", "far_spec"):
        np.testing.assert_array_equal(
            getattr(ps.exclusions, field).numpy(),
            np.asarray(getattr(js.exclusions, field)), err_msg=field)
    (jc,), (pc,) = js.constraints, ps.constraints
    np.testing.assert_array_equal(pc.idx_i.numpy(), np.asarray(jc.idx_i))
    assert ps.n_dof == js.n_dof
    names = [type(g).__name__ for g in ps.general_inters]
    assert names == [type(g).__name__ for g in js.general_inters] == [
        "PME", "EwaldExclusionCorrection", "LJDispersionCorrection"]
    jp, pp = js.general_inters[0], ps.general_inters[0]
    assert pp.mesh_dims == jp.mesh_dims and pp.alpha == jp.alpha
    for k in ("moduli_x", "moduli_y", "moduli_z"):
        np.testing.assert_allclose(np64(getattr(pp, k)),
                                   np64(getattr(jp, k)), rtol=1e-14)
    je, pe = js.general_inters[1], ps.general_inters[1]
    pairs = pairs_from_bitmap(je.bits, je.far)
    np.testing.assert_array_equal(
        np.stack([pe.pair_i.numpy(), pe.pair_j.numpy()], axis=1), pairs)


def test_port_setup_equals_bridged_system():
    own = port_system(BOX)
    bridged = system_from_arrays(jax.device_get(jax_system(BOX)),
                                 device=CPU, dist_neighbors=LIST_RADIUS,
                                 n_steps=CADENCE)
    f1, v1 = pt.forces_virial(own, port_neighbors(own), needs_virial=True)
    f2, v2 = pt.forces_virial(bridged, port_neighbors(bridged),
                              needs_virial=True)
    assert max_rel(f1, f2) < 1e-12 and max_rel(v1, v2) < 1e-12


def test_force_field_matches_exact_jax(exact):
    js, ps = exact
    f_j, v_j = jax.jit(lambda s: mt.forces_virial(s, None,
                                                  needs_virial=True))(js)
    e_j = float(jax.jit(mt.potential_energy)(js))
    nb = port_neighbors(ps)
    f_p, v_p = pt.forces_virial(ps, nb, needs_virial=True)
    assert max_rel(f_j, f_p) < EXACT
    assert max_rel(v_j, v_p) < EXACT
    assert float(pt.potential_energy(ps, nb)) == pytest.approx(e_j,
                                                               rel=EXACT)


def test_pair_kernel_twin_matches_pallas_kernel():
    """The coul3-triclinic twin on the port's cluster-pair list against
    JAX's Pallas kernel in interpret mode on JAX's, forces-only and with
    energy + virial, and the full force field through each."""
    js, ps = jax_system(BOX), port_system(BOX)
    nbs, nb = jax_neighbors(js), port_neighbors(ps)
    spec_p = pair_kernel.build_fused_spec(ps.pairwise_inters)
    assert pair_kernel.instance_family(spec_p, ps.boundary) == \
        "coul3-triclinic"
    spec_j = build_fused_spec(js.pairwise_inters)
    f_j, e_j, v_j = jax.jit(lambda c: pallas_block_nonbonded(
        spec_j, c, js.boundary, js.atoms, js.exclusions, nbs,
        js.neighbor_finder, compute_energy=True))(js.coords)
    f_p, e_p, v_p = pair_kernel.block_nonbonded(
        spec_p, ps.coords, ps.boundary, ps.atoms, ps.exclusions, nb,
        compute_energy=True)
    assert float(np.abs(np64(f_j) - np64(f_p)).max()) < POLY_FORCE
    assert max_rel(v_j, v_p) < POLY_SUM
    # the energy cancels strongly: POLY times the summed magnitude of the
    # O-O Coulomb pair terms, ~1e4 kJ/mol
    assert abs(float(e_p) - float(e_j)) < POLY * 1e4
    f_j, v_j = jax_forces_virial(js, nbs)
    f_p, v_p = pt.forces_virial(ps, nb, needs_virial=True)
    assert max_rel(f_j, f_p) < POLY and max_rel(v_j, v_p) < POLY_SUM
    assert abs(float(pt.potential_energy(ps, nb))
               - float(jax_potential_energy(js, nbs))) < 2e-2


def test_chunked_steps_with_rebuilds_match(exact):
    js, ps = exact
    sim_j = mt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)
    key = jax.random.PRNGKey(7)
    run = jax.jit(partial(_make_chunk_fn(sim_j, False, None), n=N_STEPS))
    js0 = jax_fresh_start(js, sim_j)
    out_j, _, _, _ = run(js0, None, sim_j.init_aux(js0, None), key, 0)
    noise = jax_noise_sequence(key, N_STEPS, (js.n_atoms, 3))
    sim_p = pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)
    out_p, nb, _ = pt.simulate(ps, sim_p, N_STEPS, noise=noise.__getitem__)
    assert nb.step_built == N_STEPS
    np.testing.assert_allclose(np64(out_p.coords), np64(out_j.coords),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(np64(out_p.velocities),
                               np64(out_j.velocities), rtol=0, atol=1e-4)
    assert float(out_p.constraints[0].max_violation(
        out_p.coords, out_p.boundary)) < 1e-9
