"""LINCS of mollytpu_torch against the JAX package's (ops/lincs.py):
positions, velocities and the constraint virial on the CH3 chains of
tests/test_lincs.py; the split of setup's constraint_algorithm="lincs"
(closed triangles on SHAKE, the rest on LINCS) on the water box with and
without rigid water; 20 Langevin steps of the flexible-water box on
LINCS, fed JAX's noise.

The JAX package keeps its LINCS tables in float32 whatever the system's
dtype; the port's follow the system's. Built with float32 tables the port
is JAX's to rounding (1e-12 nm in float64 coordinates); with float64
tables it meets the constraint lengths themselves, where JAX's float64
result misses them by the float32 rounding of the lengths (~1e-9 nm).
The trajectory runs on JAX's tables carried by the bridge, against JAX's
dense engine with the exact erfc: the bounds of tests/test_torch_slice.py
(1e-7 nm, 1e-4 nm/ps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.ops.lincs import LINCS as JaxLINCS

import mollytpu_torch as pt
from mollytpu_torch.bridge import system_from_arrays
from mollytpu_torch.ops.lincs import LINCS
from test_lincs import chain_system
from torch_parity import (CADENCE, CPU, LIST_RADIUS, box_path,
                          jax_dense_steps,
                          jax_exact_system,
                          jax_fresh_start, jax_noise_sequence, jax_system,
                          np64, port_system, seeded_velocities)
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DT, TEMP, FRICTION = 0.002, 300.0, 1.0
N_STEPS = CADENCE
TOL = 1e-12


@pytest.fixture(scope="module", params=[(6, 0, 6, 3), (3, 3, 8, 2)],
                ids=["chain6", "chain3"])
def chain(request):
    n_heavy, key, order, n_iters = request.param
    coords, masses, pairs, dists = chain_system(n_heavy=n_heavy, key=key)
    rng = np.random.default_rng(key)
    new = coords + 0.004 * rng.normal(size=coords.shape)
    vels = rng.normal(size=coords.shape)
    jl = JaxLINCS.build(pairs, dists, jnp.asarray(masses), order=order,
                        n_iters=n_iters)
    kw = dict(order=order, n_iters=n_iters, device=CPU)
    return dict(coords=coords, new=new, vels=vels, masses=masses,
                pairs=pairs, dists=dists, jax=jl,
                f32=LINCS.build(pairs, dists, masses, dtype=torch.float32,
                                **kw),
                f64=LINCS.build(pairs, dists, torch.as_tensor(masses),
                                dtype=torch.float64, **kw))


def _boxes():
    return (mt.cubic(10.0, dtype=jnp.float64),
            pt.cubic(10.0, dtype=torch.float64, device=CPU))


def test_tables_match_jax(chain):
    jl, pl = chain["jax"], chain["f32"]
    for f in ("idx_i", "idx_j", "nbr"):
        np.testing.assert_array_equal(getattr(pl, f).numpy(),
                                      np.asarray(getattr(jl, f)))
    for f in ("dists", "sdiag", "inv_m_i", "inv_m_j", "coef"):
        assert getattr(pl, f).dtype == torch.float32
        np.testing.assert_array_equal(getattr(pl, f).numpy(),
                                      np.asarray(getattr(jl, f)))


def test_positions_and_virial_match_jax(chain):
    jb, pb = _boxes()
    x0, x1, v, m = (chain[k] for k in ("coords", "new", "vels", "masses"))
    jl = chain["jax"]
    xj, vj = jax.jit(lambda a, b, u: jl.apply_position_constraints(
        a, b, u, jnp.asarray(m), jb, DT))(jnp.asarray(x0), jnp.asarray(x1),
                                           jnp.asarray(v))
    wj = jl.constraint_virial(jnp.asarray(x0), jnp.asarray(x1), xj,
                              jnp.asarray(m), jb, DT)
    t = [torch.as_tensor(a) for a in (x0, x1, v, m)]
    xp, vp = chain["f32"].apply_position_constraints(t[0], t[1], t[2], t[3],
                                                     pb, DT)
    wp = chain["f32"].constraint_virial(t[0], t[1], xp, t[3], pb, DT)
    np.testing.assert_allclose(xp.numpy(), np64(xj), rtol=0, atol=TOL)
    np.testing.assert_allclose(vp.numpy(), np64(vj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(wp.numpy(), np64(wj), rtol=1e-10, atol=1e-8)
    # the float64 tables aim at the lengths themselves, JAX's at their
    # float32 roundings; the series' truncation (~1e-8 nm here) hides
    # the difference in the result
    exact = np.asarray(chain["dists"])
    np.testing.assert_array_equal(chain["f64"].dists.numpy(), exact)
    assert np.abs(np64(jl.dists) - exact).max() > 1e-10
    x64, _ = chain["f64"].apply_position_constraints(t[0], t[1], t[2], t[3],
                                                     pb, DT)
    np.testing.assert_allclose(x64.numpy(), xp.numpy(), rtol=0, atol=1e-8)


def test_velocities_match_jax(chain):
    jb, pb = _boxes()
    x, v, m = (chain[k] for k in ("new", "vels", "masses"))
    vj = jax.jit(lambda a, u: chain["jax"].apply_velocity_constraints(
        a, u, jnp.asarray(m), jb))(jnp.asarray(x), jnp.asarray(v))
    vp = chain["f32"].apply_velocity_constraints(
        torch.as_tensor(x), torch.as_tensor(v), torch.as_tensor(m), pb)
    np.testing.assert_allclose(vp.numpy(), np64(vj), rtol=0, atol=TOL)


def test_shake_constraint_virial_matches_jax():
    js, ps = jax_system("tiny64"), port_system("tiny64")
    (jc,), (pc,) = js.constraints, ps.constraints
    x0 = np64(js.coords)
    x1 = x0 + 0.002 * np.random.default_rng(3).normal(size=x0.shape)
    m = np64(js.atoms.mass)
    jb = js.boundary
    xj, _ = jc.apply_position_constraints(jnp.asarray(x0), jnp.asarray(x1),
                                          None, jnp.asarray(m), jb, DT)
    wj = jc.constraint_virial(jnp.asarray(x0), jnp.asarray(x1), xj,
                              jnp.asarray(m), jb, DT)
    t = [torch.as_tensor(a) for a in (x0, x1, m)]
    xp, _ = pc.apply_position_constraints(t[0], t[1], None, t[2],
                                          ps.boundary, DT)
    wp = pc.constraint_virial(t[0], t[1], xp, t[2], ps.boundary, DT)
    np.testing.assert_allclose(wp.numpy(), np64(wj), rtol=1e-9, atol=1e-6)


@pytest.mark.parametrize("rigid", [True, False], ids=["rigid", "flexible"])
def test_setup_split_matches_jax(rigid):
    """Rigid water's triangles stay on SHAKE, flexible water's O-H bonds
    all go to LINCS, as in the JAX package."""
    js = jax_system("tiny64", rigid=rigid, algorithm="lincs")
    ps = port_system("tiny64", rigid=rigid, algorithm="lincs")
    kinds = [type(c).__name__ for c in ps.constraints]
    assert kinds == [type(c).__name__ for c in js.constraints]
    assert kinds == (["SHAKERattle"] if rigid else ["LINCS"])
    for jc, pc in zip(js.constraints, ps.constraints):
        assert pc.n_constraints == jc.n_constraints == (192 if rigid
                                                        else 128)
        np.testing.assert_array_equal(pc.idx_i.numpy(), np.asarray(jc.idx_i))
        np.testing.assert_array_equal(pc.idx_j.numpy(), np.asarray(jc.idx_j))
    assert ps.n_dof == js.n_dof
    if not rigid:
        (jl,), (pl,) = js.constraints, ps.constraints
        assert pl.dists.dtype == torch.float64
        np.testing.assert_array_equal(pl.nbr.numpy(), np.asarray(jl.nbr))
        # the port's float64 table against JAX's float32 one
        np.testing.assert_allclose(pl.coef.numpy(), np64(jl.coef),
                                   rtol=1e-7)


def test_unknown_algorithm_raises():
    with pytest.raises(ValueError, match="constraint_algorithm="):
        pt.system_from_pdb(box_path("tiny64"), pt.ForceField(pt.TIP3P_XML),
                           device=CPU, constraints="hbonds",
                           constraint_algorithm="settle")


def test_flexible_water_trajectory_matches_jax():
    js = seeded_velocities(jax_exact_system("tiny64", rigid=False,
                                            algorithm="lincs"), temp=TEMP)
    ps = system_from_arrays(jax.device_get(js), device=CPU,
                            dist_neighbors=LIST_RADIUS, n_steps=CADENCE)
    assert [type(c).__name__ for c in ps.constraints] == ["LINCS"]
    sim_j = mt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)
    key = jax.random.PRNGKey(11)
    out_j, _ = jax_dense_steps(sim_j, jax_fresh_start(js, sim_j), key,
                               N_STEPS)
    noise = jax_noise_sequence(key, N_STEPS, (js.n_atoms, 3))
    sim_p = pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)
    out_p, _, _ = pt.simulate(ps, sim_p, N_STEPS,
                              noise=noise.__getitem__)
    np.testing.assert_allclose(np64(out_p.coords), np64(out_j.coords),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(np64(out_p.velocities),
                               np64(out_j.velocities), rtol=0, atol=1e-4)
    (pl,) = out_p.constraints
    # LINCS at order 4 with 2 corrections: ~1e-6 nm, as the JAX tests hold
    assert float(pl.max_violation(out_p.coords, out_p.boundary)) < 2e-5
