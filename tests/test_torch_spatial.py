"""Boundary and spatial helpers of mollytpu_torch against the JAX package,
on inputs drawn with numpy from a seed. Both sides compute in float64 with
the same formulas, so results agree to 1e-12 (summation order only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
import mollytpu_torch as pt
from mollytpu_torch.units import KB
from torch_parity import CPU
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-12
N = 97


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _both(sides):
    return (mt.rectangular(jnp.asarray(sides), dtype=jnp.float64),
            pt.rectangular(sides, dtype=torch.float64, device=CPU))


@pytest.mark.parametrize("sides", [[2.6, 2.6, 2.6], [3.1, 2.4, 5.0],
                                   [2.0, float("inf"), 3.0]])
def test_wrap_and_displacement(rng, sides):
    jb, pb = _both(sides)
    x = rng.uniform(-7.0, 9.0, (N, 3))
    y = rng.uniform(-7.0, 9.0, (N, 3))
    np.testing.assert_allclose(pb.wrap(torch.as_tensor(x)).numpy(),
                               np.asarray(jb.wrap(jnp.asarray(x))), atol=TOL)
    np.testing.assert_allclose(
        pb.displacement(torch.as_tensor(x), torch.as_tensor(y)).numpy(),
        np.asarray(jb.displacement(jnp.asarray(x), jnp.asarray(y))),
        atol=TOL)
    fin = [s for s in sides if np.isfinite(s)]
    if len(fin) == 3:
        assert float(pb.volume()) == pytest.approx(float(jb.volume()),
                                                   rel=TOL)


def test_kinetic_energy_tensor_and_temperature(rng):
    m = rng.uniform(1.0, 16.0, N)
    v = rng.normal(size=(N, 3))
    mj, vj = jnp.asarray(m), jnp.asarray(v)
    mp, vp = torch.as_tensor(m), torch.as_tensor(v)
    assert float(pt.kinetic_energy(mp, vp)) == pytest.approx(
        float(mt.kinetic_energy(mj, vj)), rel=TOL)
    np.testing.assert_allclose(pt.kinetic_energy_tensor(mp, vp).numpy(),
                               np.asarray(mt.kinetic_energy_tensor(mj, vj)),
                               rtol=TOL, atol=TOL)
    dof = pt.n_dof(N, 30)
    assert dof == mt.n_dof(N, 30)
    assert float(pt.temperature(mp, vp, dof)) == pytest.approx(
        float(mt.temperature(mj, vj, dof)), rel=TOL)


def test_remove_cm_motion(rng):
    m = rng.uniform(1.0, 16.0, N)
    m[5] = 0.0   # a massless site keeps zero velocity
    v = rng.normal(size=(N, 3))
    out = pt.remove_cm_motion(torch.as_tensor(m), torch.as_tensor(v))
    ref = mt.remove_cm_motion(jnp.asarray(m), jnp.asarray(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)
    assert np.all(out.numpy()[5] == 0.0)


@pytest.mark.parametrize("n_atoms, n_constraints, remove_cm", [
    (192, 192, True), (10, 0, False), (1536, 1536, True)])
def test_n_dof(n_atoms, n_constraints, remove_cm):
    assert pt.n_dof(n_atoms, n_constraints, 3, remove_cm) == mt.n_dof(
        n_atoms, n_constraints, 3, remove_cm)


def test_random_velocities_distribution():
    """The Generator's stream is not jax.random's: compare the mean kinetic
    energy per degree of freedom with kT/2, within 3 standard errors."""
    n, temp = 20000, 300.0
    masses = torch.full((n,), 15.99943, dtype=torch.float64)
    masses[::3] = 1.007947
    gen = torch.Generator().manual_seed(5)
    v = pt.random_velocities(masses, temp, gen)
    ke_dof = (0.5 * masses[:, None] * v * v).flatten()
    mean, sem = float(ke_dof.mean()), float(ke_dof.std() / ke_dof.numel()
                                            ** 0.5)
    assert abs(mean - 0.5 * KB * temp) < 3.0 * sem
    zero_mass = pt.random_velocities(torch.zeros(4, dtype=torch.float64),
                                     temp, gen)
    assert torch.all(zero_mass == 0)
