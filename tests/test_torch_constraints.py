"""Cluster SHAKE / RATTLE of mollytpu_torch against the JAX package's
SHAKERattle, float64: one constrained drift (positions and the implied
velocity correction) and one velocity projection. Both run the same Newton
iterations and closed-form solves, so they agree to 1e-12 (rounding); the
constraints themselves hold to 1e-10 nm after the drift."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.ops.constraints import SHAKERattle as JaxSHAKE

import mollytpu_torch as pt
from mollytpu_torch.ops.constraints import SHAKERattle
from torch_parity import CPU, jax_system, np64, port_system
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-12
DT = 0.002


def _shapes():
    """Molecules of every cluster shape: a single bond, a path of two, a
    star of three (CH3-like) and a triangle (rigid water)."""
    rng = np.random.default_rng(4)
    centers = rng.uniform(0.5, 2.5, (4, 3))
    coords, pairs, masses = [], [], []

    def add(center, offsets, bonds, mass):
        base = len(coords)
        for o in offsets:
            coords.append(center + np.asarray(o))
        pairs.extend((base + a, base + b) for a, b in bonds)
        masses.extend(mass)

    add(centers[0], [(0, 0, 0), (0.1, 0.01, 0)], [(0, 1)], [12.0, 1.0])
    add(centers[1], [(0, 0, 0), (0.1, 0, 0), (-0.03, 0.095, 0)],
        [(0, 1), (0, 2)], [14.0, 1.0, 1.0])
    add(centers[2], [(0, 0, 0), (0.1, 0, 0), (-0.03, 0.095, 0),
                     (-0.03, -0.05, 0.08)], [(0, 1), (0, 2), (0, 3)],
        [12.0, 1.0, 1.0, 1.0])
    add(centers[3], [(0, 0, 0), (0.0957, 0, 0), (-0.024, 0.0927, 0)],
        [(0, 1), (0, 2), (1, 2)], [16.0, 1.0, 1.0])
    coords = np.asarray(coords)
    pairs = np.asarray(pairs)
    dists = np.linalg.norm(coords[pairs[:, 0]] - coords[pairs[:, 1]], axis=1)
    return coords, pairs, dists * 1.02, np.asarray(masses), 3.0


def _cases(name):
    if name == "shapes":
        coords, pairs, dists, masses, side = _shapes()
        jc = JaxSHAKE.build(pairs, jnp.asarray(dists), n_atoms=len(coords))
        pc = SHAKERattle.build(pairs, dists, dtype=torch.float64)
        return coords, masses, side, jc, pc
    js, ps = jax_system("tiny64"), port_system("tiny64")
    return (np64(js.coords), np64(js.atoms.mass),
            float(js.boundary.side_lengths[0]), js.constraints[0],
            ps.constraints[0])


@pytest.fixture(params=["water64", "shapes"])
def case(request):
    return _cases(request.param)


def test_cluster_shapes_match_jax(case):
    _, _, _, jc, pc = case
    assert sorted(b.pattern for b in pc.clusters) == sorted(
        b.pattern for b in jc.clusters)


def test_constrained_drift_matches_jax(case):
    coords, masses, side, jc, pc = case
    rng = np.random.default_rng(9)
    vels = rng.normal(scale=1.5, size=coords.shape)
    new = coords + DT * vels
    jb, pb = mt.cubic(side, dtype=jnp.float64), pt.cubic(
        side, dtype=torch.float64, device=CPU)
    xj, vj = jax.jit(lambda a, b, v: jc.apply_position_constraints(
        a, b, v, jnp.asarray(masses), jb, DT))(
        jnp.asarray(coords), jnp.asarray(new), jnp.asarray(vels))
    xp, vp = pc.apply_position_constraints(
        torch.as_tensor(coords), torch.as_tensor(new), torch.as_tensor(vels),
        torch.as_tensor(masses), pb, DT)
    np.testing.assert_allclose(xp.numpy(), np64(xj), atol=TOL)
    np.testing.assert_allclose(vp.numpy(), np64(vj), atol=1e-9)
    assert float(pc.max_violation(xp, pb)) < 1e-10


def test_velocity_projection_matches_jax(case):
    coords, masses, side, jc, pc = case
    rng = np.random.default_rng(10)
    vels = rng.normal(scale=1.5, size=coords.shape)
    jb, pb = mt.cubic(side, dtype=jnp.float64), pt.cubic(
        side, dtype=torch.float64, device=CPU)
    vj = jax.jit(lambda x, v: jc.apply_velocity_constraints(
        x, v, jnp.asarray(masses), jb))(jnp.asarray(coords),
                                         jnp.asarray(vels))
    vp = pc.apply_velocity_constraints(torch.as_tensor(coords),
                                       torch.as_tensor(vels),
                                       torch.as_tensor(masses), pb)
    np.testing.assert_allclose(vp.numpy(), np64(vj), atol=1e-10)
    # no relative velocity along any constrained bond remains
    x, v = torch.as_tensor(coords), vp
    dr = pb.displacement(x[pc.idx_j], x[pc.idx_i])
    rel = ((v[pc.idx_i] - v[pc.idx_j]) * dr).sum(dim=1)
    assert float(rel.abs().max()) < 1e-10


def test_unsupported_constraint_graph_raises():
    """A graph with a component of no cluster shape (a chain of five bonds)
    no longer raises: it goes to the global sweeps, as in the JAX package
    (tests/test_torch_constraints_global.py holds them against JAX)."""
    chain = [(i, i + 1) for i in range(5)]
    pc = SHAKERattle.build(chain, [0.1] * 5, device=CPU)
    jc = JaxSHAKE.build(chain, jnp.asarray([0.1] * 5), n_atoms=6)
    assert pc.clusters == () and jc.clusters == ()
    assert (pc.n_iters, pc.vel_iters, pc.omega) == (
        jc.n_iters, jc.vel_iters, jc.omega)
