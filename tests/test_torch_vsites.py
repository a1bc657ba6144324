"""Virtual sites of mollytpu_torch against the JAX package, float64:
placement and force distribution for the four site types (the JAX
package distributes by jax.vjp of the placement, the port by its chain
rule written out); the 64-water TIP4P-Ew box built by both packages
(masses, exclusions with the sites' inherited ones, 1-4 pairs, placed
coordinates, n_dof); its forces, virial and energy under PME and the
reaction field; 40 Langevin steps fed JAX's noise; one MTS step.

Tolerances:
- placement and distribution: the same arithmetic up to the order of a
  few sums, 1e-12;
- the force field against JAX's dense engine with the exact erfc
  (torch_parity.jax_exact_system): 1e-9 relative, as
  tests/test_torch_dodeca_pme_slice.py holds TIP3P;
- the trajectory: the bounds of tests/test_torch_slice.py, 1e-7 nm and
  1e-4 nm/ps after 40 steps of 2 fs;
- the MTS step: 1e-9 nm and 1e-6 nm/ps after one 4 fs outer step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.ops.virtual_sites import VirtualSites as JaxVirtualSites

import mollytpu_torch as pt
from mollytpu_torch.bridge import system_from_arrays
from mollytpu_torch.ops.virtual_sites import VirtualSites
from torch_parity import (CADENCE, CPU, LIST_RADIUS, jax_dense_steps,
                          jax_exact_system,
                          jax_fresh_start, jax_noise_sequence, jax_system,
                          max_rel, np64, port_neighbors, port_system,
                          seeded_velocities)
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BOX = "tip4p64"
DT, TEMP, FRICTION = 0.002, 300.0, 1.0
N_STEPS = 2 * CADENCE
EXACT, PLACE = 1e-9, 1e-12
SITE_KINDS = ("one", "average2", "average3", "outOfPlane")


def _sites(kinds, n_atoms=40, seed=0):
    """Random coordinates in a 2 nm cube and one site of each kind per
    group of four atoms (site last, parents the three before it), with
    random weights."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0.0, 2.0, (n_atoms, 3))
    specs = []
    for g, kind in enumerate(kinds * (n_atoms // (4 * len(kinds)))):
        base = 4 * g
        n_par = {"one": 1, "average2": 2}.get(kind, 3)
        w = rng.uniform(-0.5, 1.0, 3)
        specs.append((base + 3, kind, tuple(range(base, base + n_par)),
                      tuple(w[:n_par] if kind != "outOfPlane" else w)))
    return coords, specs


@pytest.mark.parametrize("kinds", [(k,) for k in SITE_KINDS]
                         + [SITE_KINDS], ids=list(SITE_KINDS) + ["mixed"])
def test_place_and_distribute_match_jax(kinds):
    coords, specs = _sites(kinds)
    jv = JaxVirtualSites.build(specs, dtype=jnp.float64)
    pv = VirtualSites.build(specs, dtype=torch.float64, device=CPU)
    jb = mt.cubic(2.0, dtype=jnp.float64)
    pb = pt.cubic(2.0, dtype=torch.float64, device=CPU)
    x_j, x_p = jnp.asarray(coords), torch.as_tensor(coords)
    placed = pv.place(x_p, pb)
    np.testing.assert_allclose(placed.numpy(), np64(jv.place(x_j, jb)),
                               rtol=0, atol=PLACE)
    forces = np.random.default_rng(1).normal(size=coords.shape)
    f_j = jax.jit(lambda x, f: jv.distribute_forces(x, jb, f))(
        jnp.asarray(np64(placed)), jnp.asarray(forces))
    f_p = pv.distribute_forces(placed, pb, torch.as_tensor(forces))
    np.testing.assert_allclose(f_p.numpy(), np64(f_j), rtol=0, atol=PLACE)
    assert not f_p[pv.site_idx].any()
    # the total force is kept
    np.testing.assert_allclose(f_p.sum(0).numpy(), forces.sum(0), atol=1e-12)


def test_tip4pew_system_matches_jax():
    js, ps = jax_system(BOX), port_system(BOX)
    assert ps.virtual_sites.n_sites == js.virtual_sites.n_sites == 64
    assert ps.n_dof == js.n_dof == 6 * 64 - 3
    for f in ("site_idx", "site_type", "parents"):
        np.testing.assert_array_equal(
            getattr(ps.virtual_sites, f).numpy(),
            np.asarray(getattr(js.virtual_sites, f)))
    np.testing.assert_allclose(np64(ps.virtual_sites.weights),
                               np64(js.virtual_sites.weights), atol=0)
    for field in ("mass", "charge", "sigma", "epsilon"):
        np.testing.assert_array_equal(np64(getattr(ps.atoms, field)),
                                      np64(getattr(js.atoms, field)),
                                      err_msg=field)
    assert not ps.atoms.mass[3::4].any()
    for field in ("excl_i", "excl_j", "spec_i", "spec_j", "excl_bits",
                  "spec_bits", "far_excl", "far_spec"):
        np.testing.assert_array_equal(
            getattr(ps.exclusions, field).numpy(),
            np.asarray(getattr(js.exclusions, field)), err_msg=field)
    # each M is excluded from O, H1 and H2 of its water
    m = ps.exclusions.excl_j.numpy() % 4 == 3
    assert m.sum() == 3 * 64
    np.testing.assert_array_equal(np64(ps.coords), np64(js.coords))
    (pc,), (jc,) = ps.constraints, js.constraints
    assert pc.n_constraints == jc.n_constraints == 3 * 64
    # M sits 0.0125 nm from O (the lattice's waters are TIP3P's geometry
    # to 1e-4 A, which moves M by 4e-6 nm)
    d = np.linalg.norm(np64(ps.coords)[3::4] - np64(ps.coords)[0::4], axis=1)
    np.testing.assert_allclose(d, 0.0125, rtol=0, atol=1e-5)


@pytest.mark.parametrize("method", ["pme", "cutoff"])
def test_tip4pew_forces_energy_match_jax(method):
    js = jax_exact_system(BOX, method)
    ps = port_system(BOX, method)
    f_j, v_j = jax.jit(lambda s: mt.forces_virial(s, None,
                                                  needs_virial=True))(js)
    e_j = float(jax.jit(mt.potential_energy)(js))
    nb = port_neighbors(ps)
    f_p, v_p = pt.forces_virial(ps, nb, needs_virial=True)
    assert max_rel(f_j, f_p) < EXACT
    assert max_rel(v_j, v_p) < EXACT
    assert float(pt.potential_energy(ps, nb)) == pytest.approx(e_j,
                                                               rel=EXACT)
    assert not f_p[ps.virtual_sites.site_idx].any()
    # the sites carry the charge: without distributing their forces the
    # parents' forces differ
    raw, _ = pt.forces_virial(ps.update(virtual_sites=None), nb)
    assert max_rel(raw, f_p) > 1e-2


@pytest.fixture(scope="module")
def exact_start():
    js = seeded_velocities(jax_exact_system(BOX), temp=TEMP)
    ps = system_from_arrays(jax.device_get(js), device=CPU,
                            dist_neighbors=LIST_RADIUS, n_steps=CADENCE)
    return js, ps


def test_langevin_trajectory_matches_jax(exact_start):
    js, ps = exact_start
    assert not ps.velocities[3::4].any()
    sim_j = mt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)
    key = jax.random.PRNGKey(7)
    out_j, _ = jax_dense_steps(sim_j, jax_fresh_start(js, sim_j), key,
                               N_STEPS)
    noise = jax_noise_sequence(key, N_STEPS, (js.n_atoms, 3))
    sim_p = pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)
    out_p, nb, aux = pt.simulate(ps, sim_p, N_STEPS, noise=noise.__getitem__)
    assert nb.step_built == N_STEPS
    np.testing.assert_allclose(np64(out_p.coords), np64(out_j.coords),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(np64(out_p.velocities),
                               np64(out_j.velocities), rtol=0, atol=1e-4)
    vs = out_p.virtual_sites
    placed = vs.positions(out_p.coords, out_p.boundary)
    assert float((placed - out_p.coords[vs.site_idx]).abs().max()) < 1e-15
    assert not out_p.velocities[vs.site_idx].any()
    assert not aux["forces"][vs.site_idx].any()
    assert float(out_p.constraints[0].max_violation(
        out_p.coords, out_p.boundary)) < 1e-9


def test_mts_step_with_sites_matches_jax(exact_start):
    """One BAOAB-RESPA outer step: the sites are placed once, after it, so
    the inner force evaluations see them where the step began."""
    js, ps = exact_start
    kw = dict(dt=2 * DT, temperature=TEMP, friction=FRICTION,
              pi_fractions=(2, 2), si_fractions=(2,) * len(js.specific_lists),
              gi_fractions=(1, 1, 1))
    sim_j, sim_p = mt.MTSLangevinIntegrator(**kw), \
        pt.MTSLangevinIntegrator(**kw)
    key = jax.random.PRNGKey(4)
    aux_j = sim_j.init_aux(js, None)
    _, sub = jax.random.split(key)
    out_j, _ = jax.jit(lambda s, a: sim_j.step(s, None, a, 0, sub))(js,
                                                                     aux_j)
    noise = jax_noise_sequence(key, 1, (js.n_atoms, 3), n_sub=2)[0]
    nb = port_neighbors(ps)
    out_p, _ = sim_p.step(ps, nb, sim_p.init_aux(ps, nb), 0, noise=noise)
    np.testing.assert_allclose(np64(out_p.coords), np64(out_j.coords),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(np64(out_p.velocities),
                               np64(out_j.velocities), rtol=0, atol=1e-6)
