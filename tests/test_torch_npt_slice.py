"""The NPT slice of mollytpu_torch against the JAX package, float64: box
and coordinate scaling, molecule centres, the pair kernel's twin at a box
scaled after its list was built (against pallas_block_nonbonded in
interpret mode), 40 coupled Langevin steps under the Monte Carlo and the
C-rescale barostat, the steepest-descent minimizer, molecule ids and the
neighbor finder's re-setup.

The trajectories and the minimizer run on the 64-water reaction-field box:
the JAX package on its dense all-pairs path, the port on its cluster-pair
list (rebuilt every 20 steps) and the kernel's twin, both exact, so the
JAX compile stays in seconds; Ewald's polynomial erfc is held in the
scaled-box kernel test instead.

Tolerances:
- scaling: the same formulas, 1e-12;
- the twin at the scaled box against the Pallas kernel: 1e-9 of max(1,
  largest entry) without Ewald, 2e-6 with it (the Pallas kernel's
  polynomial erfc, as tests/test_torch_k1b.py);
- 40 coupled steps: coordinates 1e-7 nm and velocities 1e-4 nm/ps (the
  bounds of tests/test_torch_slice.py), the box volume 1e-9 relative, and
  the same Monte Carlo decisions;
- 20 minimizer iterations: exact energies on both sides, so the same
  accepted moves; coordinates 1e-9 nm, energies 1e-9 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.ops.blockpairs import BlockPairFinder as JaxBlockPairFinder
from mollytpu.ops.pallas_pairwise import (build_fused_spec as
                                          jax_build_fused_spec,
                                          pallas_block_nonbonded)
from mollytpu.sim.simulate import _make_chunk_fn
from mollytpu.spatial import molecule_centers as jax_molecule_centers
from mollytpu.spatial import scale_coords as jax_scale_coords
from mollytpu.spatial import (scale_coords_molecular as
                              jax_scale_coords_molecular)

import mollytpu_torch as pt
from mollytpu_torch.bridge import system_from_arrays
from mollytpu_torch.ops import pair_kernel
from mollytpu_torch.ops.blockpairs import BlockPairFinder
from test_torch_k1b import CASES, EXACT, LIST, POLY, _box, _inters, _system
from torch_parity import (CADENCE, CPU, LIST_RADIUS, jax_dense_rf_system,
                          jax_find_neighbors, jax_step_draws, max_rel, np64,
                          port_neighbors, port_system)
from torch_parity import jax_fresh_start
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-12
DT, TEMP, FRICTION = 0.002, 300.0, 1.0
P_BAR = pt.units.BAR
N_STEPS = 2 * CADENCE

#: barostat scalings: scalar, per axis, and a full matrix (upper
#: triangular, so that a triclinic basis stays lower triangular)
MUS = {"scalar": 1.01, "axis": (1.01, 0.99, 1.02),
       "matrix": ((1.01, 0.002, 0.001), (0.0, 0.99, 0.003),
                  (0.0, 0.0, 1.02))}


def _mu(name):
    return torch.as_tensor(MUS[name], dtype=torch.float64)


@pytest.fixture(scope="module")
def start():
    js = jax_dense_rf_system()
    ps = system_from_arrays(jax.device_get(js), device=CPU,
                            dist_neighbors=LIST_RADIUS, n_steps=CADENCE)
    return js, ps


@pytest.mark.parametrize("box", ["cubic", "skewed"])
@pytest.mark.parametrize("mu", sorted(MUS))
def test_scale_coords_matches_jax(box, mu):
    """Box, coordinates, velocities (by the inverse), and the scaled box's
    fractional coordinates (its inverse, derived on the device)."""
    jb, pb = _box(box, mt), _box(box, pt)
    rng = np.random.default_rng(5)
    x, v = rng.uniform(0.0, 2.4, (50, 3)), rng.normal(size=(50, 3))
    jb2, jx, jv = jax_scale_coords(jb, jnp.asarray(x), jnp.asarray(MUS[mu]),
                                   jnp.asarray(v))
    pb2, px, pv = pt.scale_coords(pb, torch.as_tensor(x), _mu(mu),
                                  torch.as_tensor(v))
    np.testing.assert_allclose(np64(pb2.box_matrix()),
                               np64(jb2.basis if box != "cubic"
                                    else jnp.diag(jb2.side_lengths)),
                               atol=TOL)
    np.testing.assert_allclose(np64(px), np64(jx), atol=TOL)
    np.testing.assert_allclose(np64(pv), np64(jv), atol=TOL)
    np.testing.assert_allclose(np64(pb2.fractional(px)),
                               np64(jb2.fractional(jx)), atol=TOL)
    assert float(pb2.volume()) == pytest.approx(float(jb2.volume()),
                                                rel=TOL)


def _water_system(name):
    sys = port_system(name, "cutoff")
    assert sys.n_molecules == sys.n_atoms // 3
    return sys


def _oh_distance(boundary, coords):
    """Minimum-image O-H distances of every water (O first, then H, H)."""
    x = coords.view(-1, 3, 3)
    return torch.linalg.vector_norm(boundary.displacement(
        x[:, :1], x[:, 1:]), dim=-1)


@pytest.mark.parametrize("name", ["tiny64", "dodeca64"])
def test_scale_coords_molecular_matches_jax_off_the_faces(name):
    """Where no water straddles a face the port's whole-molecule centres
    are the JAX package's, and so is the scaled frame."""
    sys = _water_system(name)
    x = sys.coords
    raw = torch.linalg.vector_norm(x.view(-1, 3, 3)[:, 1:]
                                   - x.view(-1, 3, 3)[:, :1], dim=-1)
    assert float(raw.max()) < 0.11          # every water whole in the box
    jb = (mt.Triclinic(jnp.asarray(np64(sys.boundary.basis)))
          if name == "dodeca64"
          else mt.rectangular(jnp.asarray(np64(sys.boundary.side_lengths)),
                              dtype=jnp.float64))
    args = (sys.masses, sys.molecule_ids, sys.n_molecules)
    jargs = (jnp.asarray(np64(sys.masses)), jnp.asarray(
        sys.molecule_ids.numpy()), sys.n_molecules)
    np.testing.assert_allclose(
        np64(pt.molecule_centers(x, *args, sys.boundary)),
        np64(jax_molecule_centers(jnp.asarray(np64(x)), *jargs)), atol=TOL)
    for mu in ("scalar", "axis"):
        pb2, px = pt.scale_coords_molecular(sys.boundary, x, _mu(mu), *args)
        jb2, jx = jax_scale_coords_molecular(jb, jnp.asarray(np64(x)),
                                             jnp.asarray(MUS[mu]), *jargs)
        np.testing.assert_allclose(np64(px), np64(jx), atol=TOL)
        assert float(pb2.volume()) == pytest.approx(float(jb2.volume()),
                                                    rel=TOL)


def test_molecule_centre_of_a_water_straddling_a_face():
    """The frame translated along x so that water 0's oxygen sits 0.02 nm
    inside the +x face and one hydrogen lies beyond it, then wrapped as the
    integrators wrap. The JAX package averages the wrapped atoms and puts
    the centre between the pieces; the port's equals the whole molecule's
    (the unwrapped reference), and scaling by the centres keeps its O-H
    minimum-image distances in the new box, where the JAX package's moves
    them by about (mu - 1) L."""
    sys = _water_system("tiny64")
    side = float(sys.boundary.side_lengths[0])
    x = sys.coords.clone()
    h = 1 + int(torch.argmax(x[1:3, 0] - x[0, 0]))
    assert float(x[h, 0] - x[0, 0]) > 0.03
    unwrapped = x + torch.tensor([side - 0.02 - float(x[0, 0]), 0.0, 0.0],
                                 dtype=x.dtype)
    wrapped = sys.boundary.wrap(unwrapped)
    assert float(wrapped[h, 0]) < 0.1        # the hydrogen wrapped around
    m = sys.masses[:3]
    reference = (m[:, None] * unwrapped[:3]).sum(dim=0) / m.sum()
    args = (sys.masses, sys.molecule_ids, sys.n_molecules)
    ours = pt.molecule_centers(wrapped, *args, sys.boundary)[0]
    theirs = np64(jax_molecule_centers(
        jnp.asarray(np64(wrapped)), jnp.asarray(np64(sys.masses)),
        jnp.asarray(sys.molecule_ids.numpy()), sys.n_molecules))[0]
    np.testing.assert_allclose(np64(ours), np64(reference), atol=TOL)
    assert abs(theirs[0] - float(reference[0])) > 0.1
    mu = 1.01 ** (1.0 / 3.0)
    box2, px = pt.scale_coords_molecular(sys.boundary, wrapped, mu, *args)
    _, jx = jax_scale_coords_molecular(
        mt.rectangular(jnp.asarray(np64(sys.boundary.side_lengths)),
                       dtype=jnp.float64), jnp.asarray(np64(wrapped)), mu,
        jnp.asarray(np64(sys.masses)), jnp.asarray(sys.molecule_ids.numpy()),
        sys.n_molecules)
    before = _oh_distance(sys.boundary, wrapped)[0]
    np.testing.assert_allclose(np64(_oh_distance(box2, px)[0]),
                               np64(before), atol=TOL)
    moved = _oh_distance(box2, torch.as_tensor(np64(jx)))[0] - before
    assert float(moved.abs().max()) > 0.5 * (mu - 1.0) * side


@pytest.mark.parametrize("name, case", [("cubic", "lj1-ewald"),
                                        ("skewed", "lj3-rf")])
def test_twin_at_a_box_scaled_after_the_list(name, case):
    """The list is built at box B, the call runs at B mu with the scaled
    coordinates (a barostat move between rebuilds), mu = 1.01 and per
    axis: the twin reads the call's box and equals the Pallas kernel
    there. Evaluated with the build's box row instead, the same list and
    coordinates give other forces."""
    coords, excl, spec, q, sigma, eps = _system(name)
    n = coords.shape[0]
    jatoms = mt.make_atoms(n=n, mass=10.0, charge=jnp.asarray(q),
                           sigma=jnp.asarray(sigma), epsilon=jnp.asarray(eps),
                           dtype=jnp.float64)
    jb, jexcl, jc = _box(name, mt), mt.Exclusions.build(
        n, excl_pairs=excl, special_pairs=spec), jnp.asarray(coords)
    finder = JaxBlockPairFinder.setup(jb, LIST, n, coords=jc, atoms=jatoms,
                                      block=32, lanes=128)
    nbs = jax_find_neighbors(finder, jc, jb, jexcl)
    assert int(nbs.overflow) == 0
    spec_j = jax_build_fused_spec(_inters(mt, case, True))
    pallas = jax.jit(lambda c, b: pallas_block_nonbonded(
        spec_j, c, b, jatoms, jexcl, nbs, finder, compute_energy=True))

    patoms = pt.make_atoms(n=n, mass=10.0, charge=q, sigma=sigma,
                           epsilon=eps, dtype=torch.float64, device=CPU)
    pb, pexcl = _box(name, pt), pt.Exclusions.build(n, excl, spec,
                                                    device=CPU)
    pc = torch.as_tensor(coords)
    nb = BlockPairFinder.setup(pb, LIST, n, patoms).find(pc, pb, pexcl)
    pspec = pair_kernel.build_fused_spec(_inters(pt, case, True))
    tol = POLY if CASES[case][1] == 3 else EXACT
    for mu in ("scalar", "axis"):
        f_j, e_j, v_j = pallas(*jax_scale_coords(jb, jc, jnp.asarray(
            MUS[mu]))[::-1])
        pb2, pc2 = pt.scale_coords(pb, pc, _mu(mu))
        f, e, v = pair_kernel.block_nonbonded(pspec, pc2, pb2, patoms, pexcl,
                                              nb, compute_energy=True)
        assert max_rel(f_j, f) < tol
        assert max_rel(v_j, v) < tol
        assert abs(float(e) - float(e_j)) < tol * max(1.0, abs(float(e_j)))
        f_old, _, _ = pair_kernel.block_nonbonded(pspec, pc2, pb, patoms,
                                                  pexcl, nb)
        assert max_rel(f_j, f_old) > 1e3 * tol


def _barostat(mod, kind):
    if kind == "mc":
        return mod.MonteCarloBarostat(P_BAR, TEMP, n_steps=10,
                                      scale_molecules=False)
    return mod.CRescaleBarostat(P_BAR, TEMP, 1.0, n_steps=5)


@pytest.mark.parametrize("kind", ["mc", "crescale"])
def test_coupled_langevin_trajectory_matches_jax(start, kind):
    """40 steps of Langevin + barostat from the same state, fed the JAX
    chunk runner's noise and coupler draws; the port rebuilds its list at
    step 20 and checks it, and computes the virial only on the C-rescale
    steps (every 5th), where the JAX package computes it on every step."""
    js, ps = start
    sim_j = mt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION,
                        coupling=(_barostat(mt, kind),))
    sim_p = pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION,
                        coupling=(_barostat(pt, kind),))
    key = jax.random.PRNGKey(7)
    chunk = _make_chunk_fn(sim_j, kind == "crescale", None)
    out_j, _, aux_j, _ = jax.jit(lambda s, k: chunk(
        s, None, sim_j.init_aux(s, None), k, 0, n=N_STEPS))(
        jax_fresh_start(js, sim_j), key)
    noise, draws = jax_step_draws(key, N_STEPS, js.n_atoms, js.n_dof,
                                  sim_j.coupling)
    out_p, nb, aux_p = pt.simulate(ps, sim_p, N_STEPS,
                                   noise=lambda k: noise[k],
                                   draws=lambda k: draws[k])
    assert nb.step_built == N_STEPS
    np.testing.assert_allclose(np64(out_p.coords), np64(out_j.coords),
                               atol=1e-7)
    np.testing.assert_allclose(np64(out_p.velocities),
                               np64(out_j.velocities), atol=1e-4)
    vol_p, vol_j = float(out_p.boundary.volume()), float(
        out_j.boundary.volume())
    assert vol_p == pytest.approx(vol_j, rel=1e-9)
    assert vol_p != pytest.approx(float(ps.boundary.volume()), rel=1e-6)
    if kind == "mc":
        for k in ("attempted", "accepted"):
            assert int(aux_p["mc_baro"][k]) == int(aux_j["mc_baro"][k])
        assert int(aux_p["mc_baro"]["attempted"]) == 4


def test_virial_after_a_box_move_is_fresh(start):
    """A C-rescale step that moves the box: the step's virial is that of a
    fresh forces_virial at the new box, as after the JAX package's step
    (mollytpu/sim/integrators.py:106-108), and not the one the barostat
    read before the move."""
    js, ps = start
    sim_j = mt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION,
                        coupling=(_barostat(mt, "crescale"),))
    sim_p = pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION,
                        coupling=(_barostat(pt, "crescale"),))
    key = jax.random.PRNGKey(3)
    noise, draws = jax_step_draws(key, 1, js.n_atoms, js.n_dof,
                                  sim_j.coupling)
    _, sub = jax.random.split(key)
    out_j, aux_j = jax.jit(lambda s: sim_j.step(
        s, None, sim_j.init_aux(s, None, True), 0, sub,
        needs_virial=True))(js)
    nb = port_neighbors(ps)
    out_p, aux_p = sim_p.step(ps, nb, sim_p.init_aux(ps, nb, True), 0,
                              noise=noise[0], needs_virial=True,
                              draws=draws[0])
    assert float(out_p.boundary.volume()) != pytest.approx(
        float(ps.boundary.volume()), rel=1e-6)
    _, fresh = pt.forces_virial(out_p, nb, needs_virial=True)
    assert torch.equal(aux_p["virial"], fresh)
    assert max_rel(aux_j["virial"], aux_p["virial"]) < 1e-9
    # a virial at the old box differs
    sys_moved = out_p.update(boundary=ps.boundary)
    _, before = pt.forces_virial(sys_moved, nb, needs_virial=True)
    assert max_rel(fresh, before) > 1e-6


def test_minimizer_matches_jax(start):
    """20 iterations from the lattice: every accepted move, the step
    sizes they imply, the energies and the coordinates. The first step is
    0.005 nm: from 0.01 nm the accepted steps grow to ~0.3 nm, where five
    Newton iterations of SHAKE leave the projection unconverged and the
    two sides' rounding apart by 1e-6 nm within two iterations."""
    js, ps = start
    out_j, info_j = jax.jit(lambda s: mt.SteepestDescentMinimizer(
        step_size=0.005, max_steps=20).minimize(s))(js)
    out_p, info_p = pt.SteepestDescentMinimizer(
        step_size=0.005, max_steps=20).minimize(ps)
    e_j, e_p = np64(info_j["energies"]), np64(info_p["energies"])
    np.testing.assert_allclose(e_p, e_j, rtol=1e-9)
    assert e_p[-1] < float(info_p["energy_initial"])
    assert len(set(e_p.tolist())) > 5            # several moves accepted
    np.testing.assert_allclose(np64(out_p.coords), np64(out_j.coords),
                               atol=1e-9)
    # the projection of moves up to ~0.03 nm by five Newton iterations
    assert float(out_p.constraints[0].max_violation(
        out_p.coords, out_p.boundary)) < 1e-6
    assert info_p["closest_unlisted"] >= 1.0


def test_molecule_ids_and_finder_resetup(start):
    """Molecule ids from the bond graph as the JAX package's; the finder's
    5% drift band; re-setup for a moved box, refused for a box compressed
    below twice the list radius; npt_resetup rebuilds only past the
    band."""
    js, ps = start
    own = port_system("tiny64", "cutoff")
    assert own.n_molecules == js.n_molecules == 64
    assert np.array_equal(own.molecule_ids.numpy(),
                          np.asarray(js.molecule_ids))
    finder = ps.neighbor_finder
    side = float(ps.boundary.side_lengths[0])
    assert finder.ref_sides == pytest.approx((side,) * 3)
    assert not finder.box_drift_exceeded(ps.boundary.scale(1.04))
    assert finder.box_drift_exceeded(ps.boundary.scale(
        torch.tensor([1.0, 1.0, 0.94], dtype=torch.float64)))
    moved = finder.resetup(ps.boundary.scale(1.06), ps.n_atoms, ps.atoms)
    assert moved.ref_sides == pytest.approx((1.06 * side,) * 3)
    squeeze = 0.99 * 2.0 * LIST_RADIUS / side
    with pytest.raises(ValueError, match="side/2"):
        finder.resetup(ps.boundary.scale(squeeze), ps.n_atoms, ps.atoms)
    sim = pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION,
                      coupling=(pt.MonteCarloBarostat(1.0, TEMP),))
    nb = port_neighbors(ps)
    for mu, new in ((1.04, False), (1.06, True)):
        box, coords = pt.scale_coords(ps.boundary, ps.coords, mu)
        sys2, nb2 = pt.npt_resetup(sim, ps.update(boundary=box,
                                                  coords=coords), nb, 30)
        assert (sys2.neighbor_finder is not finder) == new
        assert (nb2 is not nb) == new and (nb2.step_built == 30) == new
