"""The replica mesh of mollytpu_torch (parallel/replicas.py) against the
JAX package's sharded ensembles, float64 on the CPU: simulate_ensemble,
T-REMD and H-REMD on explicit 2- and 4-entry CPU meshes against JAX's on
replica_mesh(2) and replica_mesh(4) (the test conftest gives JAX 8 host
devices), JAX's noise replayed as in tests/test_torch_remd.py and held to
its TOL; each mesh run equal to the mesh=None run bit for bit; the REMD
drivers' gcd rule; and the errors for an indivisible replica count and
an object that is not a mesh."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.parallel.replicas import replica_mesh as jax_replica_mesh

import mollytpu_torch as pt
from mollytpu_torch.bridge import system_from_arrays
from mollytpu_torch.parallel.replicas import (ReplicaMesh, mesh_size_for,
                                              shard_ensemble)
from test_torch_remd import TOL, _hremd, _soft_core_fluid, jax_schedule
from torch_parity import CPU, jax_noise_sequence, np64
from torch_parity import one_torch_thread  # noqa: F401
from tests.test_simulation import lj_fluid

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZES = (2, 4)


def cpu_mesh(n):
    return ReplicaMesh((CPU,) * n)


def assert_same(a, b):
    """Bit for bit."""
    assert torch.equal(a.coords, b.coords)
    assert torch.equal(a.velocities, b.velocities)


@pytest.mark.parametrize("n_dev", SIZES)
def test_simulate_ensemble_on_a_mesh_matches_sharded_jax(n_dev):
    js = lj_fluid(n_atoms=12, box=2.0, temp=80.0)
    ps = system_from_arrays(jax.device_get(js), device=CPU)
    key = jax.random.PRNGKey(9)
    out_j = mt.parallel.replicas.simulate_ensemble(
        js, mt.Langevin(dt=0.002, temperature=80.0, friction=2.0), 4, 20,
        key=key, mesh=jax_replica_mesh(n_dev), chunk=10)
    assert len(out_j.coords.sharding.device_set) == n_dev
    noise = {}
    for c in range(2):
        key, sub = jax.random.split(key)
        for r, rk in enumerate(jax.random.split(sub, 4)):
            for s, z in enumerate(jax_noise_sequence(rk, 10, (12, 3))):
                noise[c, r, s] = z
    sim = pt.Langevin(dt=0.002, temperature=80.0, friction=2.0)
    runs = [pt.simulate_ensemble(ps, sim, 4, 20, mesh=mesh, chunk=10,
                                 noise=lambda c, r, s: noise[c, r, s])
            for mesh in (cpu_mesh(n_dev), None)]
    np.testing.assert_allclose(np64(runs[0].coords), np64(out_j.coords),
                               atol=TOL)
    np.testing.assert_allclose(np64(runs[0].velocities),
                               np64(out_j.velocities), atol=TOL)
    assert_same(*runs)


@pytest.mark.parametrize("n_dev", SIZES)
def test_temperature_remd_on_a_mesh_matches_sharded_jax(n_dev):
    js = lj_fluid(n_atoms=16, box=1.8, temp=100.0,
                  cutoff=mt.ShiftedForceCutoff(0.8))
    ps = system_from_arrays(jax.device_get(js), device=CPU)
    temps = [100.0, 140.0, 196.0, 274.0]
    n_cycles, length = 4, 10
    key = jax.random.PRNGKey(47)
    ens_j, info_j = mt.ReplicaExchangeMD(
        temperatures=jnp.asarray(temps, jnp.float64),
        simulator=mt.Langevin(dt=0.002, temperature=100.0, friction=5.0),
        cycle_length=length).simulate(js, n_cycles, key=key, jitter=0.01,
                                      mesh=jax_replica_mesh(n_dev))
    jitter, noise, uniforms = jax_schedule(key, n_cycles, 4, length, 16)
    remd = pt.ReplicaExchangeMD(
        temperatures=temps,
        simulator=pt.Langevin(dt=0.002, temperature=100.0, friction=5.0),
        cycle_length=length)
    runs = [remd.simulate(ps, n_cycles, jitter=0.01, noise=noise,
                          uniforms=uniforms, jitter_noise=jitter, mesh=mesh)
            for mesh in (cpu_mesh(n_dev), None)]
    (ens, info), (ens0, info0) = runs
    np.testing.assert_allclose(np64(info["pes"]), np64(info_j["pes"]),
                               rtol=TOL)
    assert info["exchange_rate"] == info_j["exchange_rate"] > 0
    np.testing.assert_allclose(np64(ens.coords), np64(ens_j.coords),
                               atol=TOL)
    np.testing.assert_allclose(np64(ens.velocities),
                               np64(ens_j.velocities), atol=TOL)
    assert_same(ens, ens0)
    assert torch.equal(info["pes"], info0["pes"])


@pytest.mark.parametrize("n_dev", SIZES)
def test_hamiltonian_remd_on_a_mesh_matches_sharded_jax(n_dev):
    js = _soft_core_fluid()
    ps = system_from_arrays(jax.device_get(js), device=CPU)
    mask = np.arange(24) < 4
    lams = (1.0, 0.8, 0.6, 0.4)
    n_cycles, length = 3, 10
    key = jax.random.PRNGKey(2)
    ens_j, info_j = _hremd(mt, lams, length, mask).simulate(
        js, n_cycles, key=key, mesh=jax_replica_mesh(n_dev))
    _, noise, uniforms = jax_schedule(key, n_cycles, 4, length, 24)
    remd = _hremd(pt, list(lams), length, mask)
    runs = [remd.simulate(ps, n_cycles, noise=noise, uniforms=uniforms,
                          mesh=mesh) for mesh in (cpu_mesh(n_dev), None)]
    (ens, info), (ens0, info0) = runs
    np.testing.assert_allclose(np64(info["energies"]),
                               np64(info_j["energies"]), rtol=TOL)
    assert info["exchange_rate"] == info_j["exchange_rate"]
    np.testing.assert_allclose(np64(ens.coords), np64(ens_j.coords),
                               atol=TOL)
    np.testing.assert_allclose(np64(ens.velocities),
                               np64(ens_j.velocities), atol=TOL)
    assert_same(ens, ens0)
    assert torch.equal(info["energies"], info0["energies"])


@pytest.mark.parametrize("n_devices,n_replicas", [(1, 4), (8, 4), (8, 3),
                                                  (4, 6), (2, 2), (4, 8)])
def test_the_gcd_rule_is_jax_s(n_devices, n_replicas):
    """mollytpu/sim/remd.py:98-104: more than one device, and a gcd of the
    device and replica counts above 1."""
    want = None
    if n_devices > 1 and math.gcd(n_devices, n_replicas) > 1:
        want = math.gcd(n_devices, n_replicas)
    assert mesh_size_for(n_devices, n_replicas) == want


def test_shard_ensemble_blocks_and_errors():
    js = lj_fluid(n_atoms=8, box=2.0)
    ps = system_from_arrays(jax.device_get(js), device=CPU)
    ens = pt.make_ensemble(ps, 4, generator=torch.Generator().manual_seed(1),
                           jitter=0.01)
    sharded = shard_ensemble(ens, cpu_mesh(2))
    assert [b.shape[0] for b in sharded.coord_blocks] == [2, 2]
    assert sharded.n_replicas == 4
    assert torch.equal(sharded.coords, ens.coords)
    assert torch.equal(sharded.replica(3).coords, ens.coords[3])
    assert torch.equal(sharded.velocities, ens.velocities)
    with pytest.raises(ValueError, match="split evenly"):
        shard_ensemble(ens, cpu_mesh(3))
    with pytest.raises(ValueError, match="axis"):
        shard_ensemble(ens, cpu_mesh(2), axis_name="batch")
    with pytest.raises(TypeError):
        shard_ensemble(ens, object())
    with pytest.raises(ValueError, match="split evenly"):
        pt.simulate_ensemble(ps, pt.Langevin(dt=0.002, temperature=80.0,
                                             friction=2.0), 3, 2,
                             mesh=cpu_mesh(2), chunk=2)
