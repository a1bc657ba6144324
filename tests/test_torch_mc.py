"""Metropolis Monte Carlo of mollytpu_torch (sim/mc.py) against the JAX
package, float64 on the CPU, on tests/test_simulators.py:24-31's LJ
fluid. JAX's moves are replayed into the port: per move ``key, k1, k2 =
split(key, 3)``, the trial's atom randint(k1a) and displacement from
``k1a, k1b = split(k1)``, and the acceptance uniform(k2). The accepted
moves are the same, the running energies agree to 1e-9 relative and the
final coordinates to 1e-9 nm. On a neighbor table the run checks the
table at its end and raises when it went stale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt

import mollytpu_torch as pt
from mollytpu_torch.bridge import system_from_arrays
from tests.test_simulation import lj_fluid
from torch_parity import CPU, np64
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-9
N_MOVES = 200


def jax_moves(key, n_moves, n_atoms, shift, kind):
    """(step -> (atom index, displacement), step -> uniform) of the JAX
    package's MetropolisMonteCarlo from ``key``."""
    moves, uniforms = [], []
    for _ in range(n_moves):
        key, k1, k2 = jax.random.split(key, 3)
        ka, kb = jax.random.split(k1)
        i = jax.random.randint(ka, (), 0, n_atoms)
        if kind == "normal":
            d = shift * jax.random.normal(kb, (3,), jnp.float64)
        else:
            d = jax.random.uniform(kb, (3,), jnp.float64, minval=-shift,
                                   maxval=shift)
        moves.append((torch.as_tensor(int(i)), torch.as_tensor(np64(d))))
        uniforms.append(torch.as_tensor(float(jax.random.uniform(
            k2, (), jnp.float64)), dtype=torch.float64))
    return (lambda k: moves[k]), (lambda k: uniforms[k])


def accepted(energies):
    e = np.asarray(energies)
    return e[1:] != e[:-1]


@pytest.mark.parametrize("kind,shift", [("normal", 0.02), ("uniform", 0.03)])
def test_metropolis_mc_matches_jax(kind, shift):
    js = lj_fluid(n_atoms=16, box=2.0)
    ps = system_from_arrays(jax.device_get(js), device=CPU)
    key = jax.random.PRNGKey(40)
    jmove = (mt.random_normal_translation if kind == "normal"
             else mt.random_uniform_translation)(shift)
    out_j, info_j = mt.MetropolisMonteCarlo(
        temperature=120.0, trial_move=jmove).simulate(js, N_MOVES, key=key)
    moves, uniforms = jax_moves(key, N_MOVES, 16, shift, kind)
    pmove = (pt.random_normal_translation if kind == "normal"
             else pt.random_uniform_translation)(shift)
    out, info = pt.MetropolisMonteCarlo(
        temperature=120.0, trial_move=pmove).simulate(
        ps, N_MOVES, moves=moves, uniforms=uniforms)
    e, e_j = np64(info["energies"]), np64(info_j["energies"])
    np.testing.assert_array_equal(accepted(e), accepted(e_j))
    np.testing.assert_allclose(e, e_j, rtol=TOL)
    assert int(info["accepted"]) == int(info_j["accepted"])
    assert 0.05 < float(info["acceptance_rate"]) <= 1.0
    np.testing.assert_allclose(np64(out.coords), np64(out_j.coords),
                               atol=TOL)
    # the running energy is the final state's
    assert float(pt.potential_energy(out)) == pytest.approx(e[-1], rel=1e-12)


def test_generator_moves_and_stale_table():
    js = lj_fluid(n_atoms=16, box=2.0, use_neighbors=True,
                  neighbor_finder=mt.DistanceNeighborFinder(
                      dist_cutoff=0.99, max_neighbors=16))
    ps = system_from_arrays(jax.device_get(js), device=CPU)
    nbs = pt.find_neighbors(ps.neighbor_finder, ps.coords, ps.boundary,
                            ps.exclusions)
    mc = pt.MetropolisMonteCarlo(temperature=120.0,
                                 trial_move=pt.random_normal_translation(0.02))
    runs = [mc.simulate(ps, 30, generator=torch.Generator().manual_seed(1),
                        neighbors=nbs) for _ in range(2)]
    assert torch.equal(runs[0][0].coords, runs[1][0].coords)
    assert torch.equal(runs[0][1]["energies"], runs[1][1]["energies"])
    # moves large enough to carry pairs into the cutoff stale the table
    wild = pt.MetropolisMonteCarlo(
        temperature=1e6, trial_move=pt.random_uniform_translation(0.9))
    with pytest.raises(pt.StaleNeighborList):
        wild.simulate(ps, 200, generator=torch.Generator().manual_seed(2),
                      neighbors=nbs)
