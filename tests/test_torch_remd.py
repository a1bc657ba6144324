"""Replica exchange and replica ensembles of mollytpu_torch (sim/remd.py,
parallel/replicas.py) against the JAX package, float64 on the CPU.

The JAX package's keys are replayed into the port: the start's jitter
(``k0, key = split(key)``, normal(k0)), then per cycle ``key, k1, k2 =
split(key, 3)``, one key per replica from split(k1, R), per step ``key,
sub = split(key)`` and normal(sub) for Langevin, and uniform(k2, (R,))
for the exchange. On the dense engine T-REMD (tests/test_simulators.py:
98-111) and H-REMD (tests/test_free_energy.py:389-418) make the same
exchange decisions, give the same energy history to 1e-9 relative and the
same final coordinates and velocities to 1e-9 nm (nm/ps). H-REMD on the
small alchemical water box runs through the cluster-pair list and the
pair kernel's plain twin (JAX: its Pallas kernel in interpret mode), held
at the FEP slice's tolerances. simulate_ensemble matches the JAX
package's on a one-device mesh; an object that is not a mesh raises
TypeError.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.parallel.replicas import replica_mesh

import mollytpu_torch as pt
from mollytpu_torch.bridge import system_from_arrays
from mollytpu_torch.sim.remd import exchange_pairs
from tests.test_simulation import lj_fluid
from torch_parity import (CADENCE, CPU, LIST_RADIUS, alchemical, jax_system,
                          jax_noise_sequence, np64, solute_atoms)
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-9


def jax_schedule(key, n_cycles, n_replicas, n_steps, n_atoms):
    """(jitter normals (R, N, 3), noise(cycle, replica, step), uniforms
    (cycle) -> (R,)) of the JAX package's REMD from ``key``."""
    k0, key = jax.random.split(key)
    jitter = torch.as_tensor(np64(jax.random.normal(
        k0, (n_replicas, n_atoms, 3), jnp.float64)))
    noise, uniforms = {}, []
    for c in range(n_cycles):
        key, k1, k2 = jax.random.split(key, 3)
        for i, rk in enumerate(jax.random.split(k1, n_replicas)):
            for s, z in enumerate(jax_noise_sequence(rk, n_steps,
                                                     (n_atoms, 3))):
                noise[c, i, s] = z
        uniforms.append(torch.as_tensor(np64(jax.random.uniform(
            k2, (n_replicas,), jnp.float64))))
    return jitter, (lambda c, i, s: noise[c, i, s]), (lambda c: uniforms[c])


def jax_decisions(delta, u, cycle_n):
    """JAX's accept rule (remd.py:62-89) in numpy: the swapped slots."""
    partner, lower, valid = exchange_pairs(len(u), cycle_n)
    u_pair = np.where(lower, u, u[partner])
    return valid & (u_pair < np.exp(np.minimum(-delta, 0.0)))


def recording(cls):
    """``cls`` with each exchange's permutation recorded (from the rows
    it moved, which a gather copies exactly), and H-REMD's self and cross
    energies."""

    @dataclasses.dataclass(frozen=True)
    class Recording(cls):
        perms: list = dataclasses.field(default_factory=list)
        cross: list = dataclasses.field(default_factory=list)

        def exchange(self, *args):
            coords = args[0] if cls is pt.ReplicaExchangeMD else args[1]
            out = super().exchange(*args)
            self.perms.append([
                next(j for j in range(coords.shape[0])
                     if torch.equal(out[0][i], coords[j]))
                for i in range(coords.shape[0])])
            return out

        def energies(self, *args):
            out = super().energies(*args)
            self.cross.append(tuple(np64(e) for e in out))
            return out

    return Recording


def assert_swaps(perms, accepted):
    for c, (perm, acc) in enumerate(zip(perms, accepted)):
        partner, _, _ = exchange_pairs(len(perm), c)
        expect = [partner[i] if acc[i] else i for i in range(len(perm))]
        assert perm == expect, (c, perm, expect)


def test_temperature_remd_matches_jax():
    js = lj_fluid(n_atoms=16, box=1.8, temp=100.0,
                  cutoff=mt.ShiftedForceCutoff(0.8))
    ps = system_from_arrays(jax.device_get(js), device=CPU)
    temps = [100.0, 140.0, 196.0, 274.0]
    n_cycles, length = 8, 25
    remd_j = mt.ReplicaExchangeMD(
        temperatures=jnp.asarray(temps, jnp.float64),
        simulator=mt.Langevin(dt=0.002, temperature=100.0, friction=5.0),
        cycle_length=length)
    key = jax.random.PRNGKey(47)
    ens_j, info_j = remd_j.simulate(js, n_cycles, key=key, jitter=0.01)
    jitter, noise, uniforms = jax_schedule(key, n_cycles, 4, length, 16)
    remd = recording(pt.ReplicaExchangeMD)(
        temperatures=temps,
        simulator=pt.Langevin(dt=0.002, temperature=100.0, friction=5.0),
        cycle_length=length)
    ens, info = remd.simulate(ps, n_cycles, jitter=0.01, noise=noise,
                              uniforms=uniforms, jitter_noise=jitter)
    pes_j = np64(info_j["pes"])
    np.testing.assert_allclose(np64(info["pes"]), pes_j, rtol=TOL)
    betas = 1.0 / (pt.units.KB * np.asarray(temps))
    accepted = []
    for c in range(n_cycles):
        partner, _, _ = exchange_pairs(4, c)
        delta = (betas - betas[partner]) * (pes_j[c][partner] - pes_j[c])
        accepted.append(jax_decisions(delta, np64(uniforms(c)), c))
    assert_swaps(remd.perms, accepted)
    assert any(a.any() for a in accepted)
    assert info["exchange_rate"] == info_j["exchange_rate"]
    assert ens.coords.shape == (4, 16, 3)
    np.testing.assert_allclose(np64(ens.coords), np64(ens_j.coords),
                               atol=TOL)
    np.testing.assert_allclose(np64(ens.velocities),
                               np64(ens_j.velocities), atol=TOL)


def _soft_core_fluid():
    """tests/test_free_energy.py:389-418's soft-core LJ fluid in float64."""
    n = 24
    boundary = mt.cubic(2.2, dtype=jnp.float64)
    coords = mt.place_atoms(jax.random.PRNGKey(0), boundary, n, min_dist=0.3,
                            dtype=jnp.float64)
    atoms = mt.make_atoms(n=n, mass=10.0, sigma=0.3, epsilon=0.5,
                          lam=jnp.ones(n), dtype=jnp.float64)
    vels = mt.random_velocities(jax.random.PRNGKey(1), atoms.mass, 120.0,
                                dtype=jnp.float64)
    return mt.System(
        atoms=atoms, coords=coords, boundary=boundary, velocities=vels,
        pairwise_inters=(mt.LennardJonesSoftCoreBeutler(
            alpha=0.5, cutoff=mt.DistanceCutoff(1.0)),))


def _hremd(mod, lams, length, mask, temp=120.0, friction=2.0, cls=None):
    cls = cls or mod.HamiltonianReplicaExchangeMD
    return cls(lambdas=(jnp.asarray(lams) if mod is mt else lams),
               simulator=mod.Langevin(dt=0.002, temperature=temp,
                                      friction=friction),
               cycle_length=length,
               atom_mask=(jnp.asarray(mask) if mod is mt
                          else torch.as_tensor(mask)))


def _hremd_both(js, ps, lams, n_cycles, length, mask, key, **kw):
    ens_j, info_j = _hremd(mt, lams, length, mask, **kw).simulate(
        js, n_cycles, key=key)
    _, noise, uniforms = jax_schedule(key, n_cycles, len(lams), length,
                                      js.n_atoms)
    remd = _hremd(pt, list(lams), length, mask,
                  cls=recording(pt.HamiltonianReplicaExchangeMD), **kw)
    ens, info = remd.simulate(ps, n_cycles, noise=noise, uniforms=uniforms)
    return ens_j, info_j, ens, info, remd, uniforms


def test_hamiltonian_remd_matches_jax():
    js = _soft_core_fluid()
    ps = system_from_arrays(jax.device_get(js), device=CPU)
    mask = np.arange(24) < 4
    lams = (1.0, 0.8, 0.6, 0.4)
    ens_j, info_j, ens, info, remd, uniforms = _hremd_both(
        js, ps, lams, 6, 20, mask, jax.random.PRNGKey(2))
    e_j = np64(info_j["energies"])
    assert info["energies"].shape == (6, 4)
    np.testing.assert_allclose(np64(info["energies"]), e_j, rtol=TOL)
    assert info["exchange_rate"] == info_j["exchange_rate"]
    np.testing.assert_allclose(np64(ens.coords), np64(ens_j.coords),
                               atol=TOL)
    np.testing.assert_allclose(np64(ens.velocities),
                               np64(ens_j.velocities), atol=TOL)
    # the swaps are JAX's rule on the cross energies, which match JAX's
    # self energies on the diagonal
    beta = 1.0 / (pt.units.KB * 120.0)
    accepted = []
    for c, (es, ec) in enumerate(remd.cross):
        np.testing.assert_allclose(es, e_j[c], rtol=TOL)
        partner, _, _ = exchange_pairs(4, c)
        delta = beta * (ec + ec[partner] - es - es[partner])
        accepted.append(jax_decisions(delta, np64(uniforms(c)), c))
    assert_swaps(remd.perms, accepted)


def test_hamiltonian_remd_on_the_block_list_matches_jax():
    """Two cycles of H-REMD on the 64-water box with one water inserted,
    through the cluster-pair list (the port's kernel twin, JAX's Pallas
    kernel in interpret mode): energies to 1e-9 relative, coordinates to
    1e-6 nm and velocities to 1e-4 nm/ps, as the FEP slice holds its
    trajectory."""
    base = jax_system("tiny64")
    coords = np64(base.coords)
    mask = np.zeros(coords.shape[0], dtype=bool)
    mask[solute_atoms(coords, np64(base.boundary.side_lengths))] = True
    js = alchemical(mt, base, mask, 1.0)
    ps = system_from_arrays(jax.device_get(js), device=CPU,
                            dist_neighbors=LIST_RADIUS, n_steps=CADENCE)
    assert isinstance(ps.neighbor_finder, pt.BlockPairFinder)
    ens_j, info_j, ens, info, _, _ = _hremd_both(
        js, ps, (1.0, 0.5), 2, 10, mask, jax.random.PRNGKey(5),
        temp=300.0, friction=1.0)
    np.testing.assert_allclose(np64(info["energies"]),
                               np64(info_j["energies"]), rtol=TOL)
    assert info["exchange_rate"] == info_j["exchange_rate"]
    np.testing.assert_allclose(np64(ens.coords), np64(ens_j.coords),
                               atol=1e-6)
    np.testing.assert_allclose(np64(ens.velocities),
                               np64(ens_j.velocities), atol=1e-4)


def test_simulate_ensemble_matches_unsharded_jax():
    js = lj_fluid(n_atoms=12, box=2.0, temp=80.0)
    ps = system_from_arrays(jax.device_get(js), device=CPU)
    key = jax.random.PRNGKey(9)
    sim_j = mt.Langevin(dt=0.002, temperature=80.0, friction=2.0)
    out_j = mt.parallel.replicas.simulate_ensemble(
        js, sim_j, 3, 20, key=key, mesh=replica_mesh(1), chunk=10)
    noise = {}
    for c in range(2):
        key, sub = jax.random.split(key)
        for r, rk in enumerate(jax.random.split(sub, 3)):
            for s, z in enumerate(jax_noise_sequence(rk, 10, (12, 3))):
                noise[c, r, s] = z
    out = pt.simulate_ensemble(
        ps, pt.Langevin(dt=0.002, temperature=80.0, friction=2.0), 3, 20,
        chunk=10, noise=lambda c, r, s: noise[c, r, s])
    assert out.n_replicas == 3
    np.testing.assert_allclose(np64(out.coords), np64(out_j.coords),
                               atol=TOL)
    np.testing.assert_allclose(np64(out.velocities),
                               np64(out_j.velocities), atol=TOL)
    np.testing.assert_allclose(np64(out.replica(1).coords),
                               np64(out_j.coords[1]), atol=TOL)


def test_mesh_raises_and_jitter_uses_the_generator():
    js = lj_fluid(n_atoms=8, box=2.0)
    ps = system_from_arrays(jax.device_get(js), device=CPU)
    remd = pt.ReplicaExchangeMD(
        temperatures=[100.0, 120.0],
        simulator=pt.Langevin(dt=0.002, temperature=100.0, friction=1.0),
        cycle_length=2)
    # a mesh is a ReplicaMesh (tests/test_torch_replica_mesh.py runs them)
    with pytest.raises(TypeError):
        remd.simulate(ps, 1, mesh=object())
    with pytest.raises(TypeError):
        pt.simulate_ensemble(ps, remd.simulator, 2, 2, mesh=object())
    g = torch.Generator().manual_seed(3)
    a = pt.make_ensemble(ps, 2, generator=g, jitter=0.01)
    b = pt.make_ensemble(ps, 2, generator=torch.Generator().manual_seed(3),
                         jitter=0.01)
    assert torch.equal(a.coords, b.coords)
    assert not torch.equal(a.coords[0], a.coords[1])
    assert torch.equal(pt.make_ensemble(ps, 2).coords[1], ps.coords)
