"""The global SHAKE / RATTLE sweeps and the constraint options of
mollytpu_torch against the JAX package (float64): the Jacobi sweeps on
constraint graphs that are not clusters (a six-ring and a chain of five
bonds), positions and velocities; setup's constraints="allbonds" and
"hangles" on the molecule of tests/test_torch_bonded_setup.py (pairs,
lengths, the bonded rows they replace, n_dof, the split of
constraint_algorithm="lincs") and "hangles" on the water box.

Tolerances: both packages run the same 60 sweeps; the port sums each
atom's corrections with index_add_ where JAX gathers them from incidence
tables, so they agree to rounding, 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.ops.constraints import SHAKERattle as JaxSHAKE

import mollytpu_torch as pt
from mollytpu_torch.bridge import system_from_arrays
from mollytpu_torch.ops.constraints import SHAKERattle
from test_torch_bonded_setup import assert_same_lists, build, write_molecule
from torch_parity import CPU, box_path, np64
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DT, TOL = 0.002, 1e-12


def _graph(name):
    """(coords, pairs, lengths, masses): a planar six-ring of 0.14 nm
    bonds, or a zigzag chain of six atoms; lengths 2% off the start."""
    rng = np.random.default_rng(5)
    if name == "ring":
        ang = np.arange(6) * np.pi / 3
        coords = 0.14 * np.stack([np.cos(ang), np.sin(ang), 0 * ang], 1)
        pairs = [(i, (i + 1) % 6) for i in range(6)]
        masses = np.array([12.0, 1.0] * 3)
    else:
        coords = np.array([[0.153 * k, 0.05 * (k % 2), 0.0]
                           for k in range(6)])
        pairs = [(i, i + 1) for i in range(5)]
        masses = np.array([12.0, 14.0, 12.0, 16.0, 12.0, 1.0])
    coords = coords + 1.0 + 0.003 * rng.normal(size=coords.shape)
    pairs = np.asarray(pairs)
    d = np.linalg.norm(coords[pairs[:, 0]] - coords[pairs[:, 1]], axis=1)
    return coords, pairs, 1.02 * d, masses


@pytest.fixture(params=["ring", "chain5"])
def graph(request):
    coords, pairs, dists, masses = _graph(request.param)
    jc = JaxSHAKE.build(pairs, jnp.asarray(dists), n_atoms=len(coords))
    pc = SHAKERattle.build(pairs, dists, dtype=torch.float64, device=CPU)
    assert not jc.clusters and not pc.clusters
    return coords, masses, jc, pc


def test_global_sweeps_positions_match_jax(graph):
    coords, masses, jc, pc = graph
    vels = np.random.default_rng(9).normal(scale=1.5, size=coords.shape)
    new = coords + DT * vels
    jb = mt.cubic(3.0, dtype=jnp.float64)
    pb = pt.cubic(3.0, dtype=torch.float64, device=CPU)
    xj, vj = jax.jit(lambda a, b, v: jc.apply_position_constraints(
        a, b, v, jnp.asarray(masses), jb, DT))(
        jnp.asarray(coords), jnp.asarray(new), jnp.asarray(vels))
    xp, vp = pc.apply_position_constraints(
        torch.as_tensor(coords), torch.as_tensor(new), torch.as_tensor(vels),
        torch.as_tensor(masses), pb, DT)
    np.testing.assert_allclose(xp.numpy(), np64(xj), rtol=0, atol=TOL)
    np.testing.assert_allclose(vp.numpy(), np64(vj), rtol=0, atol=1e-9)
    assert abs(float(pc.max_violation(xp, pb))
               - float(jc.max_violation(xj, jb))) < TOL


def test_global_sweeps_velocities_match_jax(graph):
    coords, masses, jc, pc = graph
    vels = np.random.default_rng(10).normal(scale=1.5, size=coords.shape)
    jb = mt.cubic(3.0, dtype=jnp.float64)
    pb = pt.cubic(3.0, dtype=torch.float64, device=CPU)
    vj = jax.jit(lambda x, v: jc.apply_velocity_constraints(
        x, v, jnp.asarray(masses), jb))(jnp.asarray(coords),
                                         jnp.asarray(vels))
    vp = pc.apply_velocity_constraints(torch.as_tensor(coords),
                                       torch.as_tensor(vels),
                                       torch.as_tensor(masses), pb)
    np.testing.assert_allclose(vp.numpy(), np64(vj), rtol=0, atol=TOL)


def _same_constraints(js, ps):
    assert [type(c).__name__ for c in ps.constraints] == [
        type(c).__name__ for c in js.constraints]
    for jc, pc in zip(js.constraints, ps.constraints):
        np.testing.assert_array_equal(pc.idx_i.numpy(), np.asarray(jc.idx_i))
        np.testing.assert_array_equal(pc.idx_j.numpy(), np.asarray(jc.idx_j))
        if type(pc).__name__ == "SHAKERattle":
            assert bool(pc.clusters) == bool(jc.clusters)
            np.testing.assert_array_equal(np64(pc.dists), np64(jc.dists))
        else:
            # the JAX package's LINCS lengths are float32 roundings
            np.testing.assert_allclose(np64(pc.dists), np64(jc.dists),
                                       rtol=1e-7)
    assert ps.n_dof == js.n_dof


@pytest.mark.parametrize("algorithm", ["shake", "lincs"])
@pytest.mark.parametrize("constraints", ["allbonds", "hangles"])
def test_molecule_constraint_options_match_jax(tmp_path, constraints,
                                               algorithm):
    pdb, xml = write_molecule(tmp_path, "amber")
    js, ps = build(pdb, xml, nonbonded_method="none",
                   constraints=constraints, constraint_algorithm=algorithm)
    _same_constraints(js, ps)
    assert_same_lists(js, ps)
    # the bridge carries the solvers: JAX's LINCS tables as they are, the
    # global sweeps where JAX has no clusters
    bridged = system_from_arrays(jax.device_get(js), device=CPU)
    _same_constraints(js, bridged)
    for jc, bc in zip(js.constraints, bridged.constraints):
        np.testing.assert_array_equal(np64(bc.dists), np64(jc.dists))
    n = sum(c.n_constraints for c in ps.constraints)
    # allbonds: the 11 bonds of each of 3 molecules; hangles: the 7 bonds
    # to H and the 6 H-C-H angles of each
    assert n == (33 if constraints == "allbonds" else 39)


def test_water_hangles_matches_rigid_water():
    """"hangles" makes the water triangles of rigid water."""
    kw = dict(nonbonded_method="cutoff", dtype=torch.float64, device=CPU)
    ff = pt.ForceField(pt.TIP3P_XML)
    hang = pt.system_from_pdb(box_path("tiny64"), ff, constraints="hangles",
                              **kw)
    rigid = pt.system_from_pdb(box_path("tiny64"), ff, constraints="hbonds",
                               rigid_water=True, **kw)
    (hc,), (rc,) = hang.constraints, rigid.constraints
    assert torch.equal(hc.idx_i, rc.idx_i) and torch.equal(hc.idx_j,
                                                           rc.idx_j)
    assert torch.equal(hc.dists, rc.dists) and hang.n_dof == rigid.n_dof
