"""The multiple-time-step integrators of mollytpu_torch against the JAX
package on the 64-water PME box with flexible H-O-H angles (float64, CPU):
MTSLangevinIntegrator (BAOAB-RESPA) with three levels, PME and the
corrections once, the pair kernel twice and the bonded lists four times
per outer step, over 6 outer steps with a rebuild every 3, fed JAX's
per-substep noise; MTSIntegrator's classic split (no fractions: the bonded
lists n_substeps times, the rest once); the errors of the fraction check
and the classic fast / slow split.

Tolerances: as tests/test_torch_slice.py (the JAX pair kernel's
polynomial erfc moves a trajectory of this length by far less than
1e-7 nm and 1e-4 nm/ps)."""

import dataclasses
from functools import partial

import jax
import numpy as np
import pytest

import mollytpu as mt
from mollytpu.sim import integrators as jax_integrators
from mollytpu.sim.simulate import _make_chunk_fn

import mollytpu_torch as pt
from mollytpu_torch.bridge import system_from_arrays
from mollytpu_torch.sim import integrators
from torch_parity import (CPU, LIST_RADIUS, jax_neighbors,
                          jax_noise_sequence, jax_system, np64,
                          port_neighbors, seeded_velocities)
from torch_parity import jax_fresh_start
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OUTER_DT, TEMP, FRICTION = 0.004, 300.0, 1.0
REBUILD, N_OUTER = 3, 6
#: pair interactions (LJ, Ewald real space), bonded lists (bonds: empty,
#: angles), general interactions (PME, exclusion and dispersion
#: corrections)
FRACTIONS = dict(pi_fractions=(2, 2), si_fractions=(4, 4),
                 gi_fractions=(1, 1, 1))


@pytest.fixture(scope="module")
def start():
    js = seeded_velocities(jax_system("tiny64", rigid=False), seed=2)
    js = js.update(neighbor_finder=dataclasses.replace(
        js.neighbor_finder, n_steps=REBUILD))
    ps = system_from_arrays(jax.device_get(js), device=CPU,
                            dist_neighbors=LIST_RADIUS, n_steps=REBUILD)
    return js, ps


def test_mts_langevin_matches_jax(start):
    js, ps = start
    kw = dict(dt=OUTER_DT, temperature=TEMP, friction=FRICTION, **FRACTIONS)
    sim_j, sim_p = mt.MTSLangevinIntegrator(**kw), \
        pt.MTSLangevinIntegrator(**kw)
    nbs = jax_neighbors(js)
    key = jax.random.PRNGKey(5)
    run = jax.jit(partial(_make_chunk_fn(sim_j, False, js.neighbor_finder,
                                         align=0), n=N_OUTER))
    out_j, _, aux_j, _ = run(jax_fresh_start(js, sim_j), nbs,
                             sim_j.init_aux(js, nbs), key, 0)

    noise = jax_noise_sequence(key, N_OUTER, (js.n_atoms, 3), n_sub=4)
    out_p, nb, aux_p = pt.simulate(ps, sim_p, N_OUTER,
                                   noise=lambda k: noise[k])
    # the rebuild cadence counts outer steps
    assert nb.step_built == N_OUTER
    np.testing.assert_allclose(np64(out_p.coords), np64(out_j.coords),
                               atol=1e-7)
    np.testing.assert_allclose(np64(out_p.velocities),
                               np64(out_j.velocities), atol=1e-4)
    for i in range(3):
        f_j = np64(aux_j[f"f_lvl{i}"])
        assert np.abs(np64(aux_p[f"f_lvl{i}"]) - f_j).max() < 1e-5 * max(
            1.0, np.abs(f_j).max())
    assert float(out_p.constraints[0].max_violation(
        out_p.coords, out_p.boundary)) < 1e-9


def test_mts_classic_split_matches_jax(start):
    """No fractions: the bonded lists at n_substeps, everything else once
    per outer step; two outer steps on one list."""
    js, ps = start
    sim_j = mt.MTSIntegrator(dt=OUTER_DT, n_substeps=4)
    sim_p = pt.MTSIntegrator(dt=OUTER_DT, n_substeps=4)
    nbs = jax_neighbors(js)

    @jax.jit
    def run(s, nbs):
        aux = sim_j.init_aux(s, nbs)
        for k in range(2):
            s, aux = sim_j.step(s, nbs, aux, k, jax.random.PRNGKey(k))
        return s

    out_j = run(js, nbs)
    nb = port_neighbors(ps)
    aux = sim_p.init_aux(ps, nb)
    out_p = ps
    for k in range(2):
        out_p, aux = sim_p.step(out_p, nb, aux, k)
    np.testing.assert_allclose(np64(out_p.coords), np64(out_j.coords),
                               atol=1e-7)
    np.testing.assert_allclose(np64(out_p.velocities),
                               np64(out_j.velocities), atol=1e-4)


@pytest.mark.parametrize("fractions", [
    dict(pi_fractions=(2,), si_fractions=(2, 2), gi_fractions=(1, 1, 1)),
    dict(pi_fractions=(2, 2), si_fractions=(2,), gi_fractions=(1, 1, 1)),
    dict(pi_fractions=(2, 2), si_fractions=(2, 2), gi_fractions=(1,)),
    dict(pi_fractions=(2, 2), si_fractions=(2, 2), gi_fractions=(2, 2, 2)),
    dict(pi_fractions=(2, 2), si_fractions=(0, 0), gi_fractions=(1, 1, 1)),
    dict(pi_fractions=(2, 2), si_fractions=(3, 3), gi_fractions=(1, 1, 1)),
])
def test_mts_fraction_errors_match_jax(start, fractions):
    js, ps = start
    with pytest.raises(ValueError) as err_j:
        jax_integrators._mts_fractions(
            mt.MTSIntegrator(dt=OUTER_DT, **fractions), js)
    with pytest.raises(ValueError) as err_p:
        integrators._mts_fractions(
            pt.MTSIntegrator(dt=OUTER_DT, **fractions), ps)
    assert str(err_p.value) == str(err_j.value)


def test_mts_levels_and_classic_split(start):
    """The levels group the interactions by fraction, and the classic
    fast / slow split puts the bonded lists alone in the fast group."""
    js, ps = start
    fr, groups = integrators._mts_fractions(
        pt.MTSIntegrator(dt=OUTER_DT, **FRACTIONS), ps)
    fr_j, groups_j = jax_integrators._mts_fractions(
        mt.MTSIntegrator(dt=OUTER_DT, **FRACTIONS), js)
    assert fr == fr_j == (1, 2, 4)
    shape = lambda g: (len(g.pairwise_inters), len(g.specific_lists),  # noqa
                       len(g.general_inters))
    assert [shape(g) for g in groups] == [shape(g) for g in groups_j] == [
        (0, 0, 3), (2, 0, 0), (0, 2, 0)]
    fast, slow = integrators._split_fast_slow(ps)
    fast_j, slow_j = jax_integrators._split_fast_slow(js)
    assert (shape(fast), shape(slow)) == (shape(fast_j), shape(slow_j)) == (
        (0, 2, 0), (2, 0, 3))
    with pytest.raises(ValueError, match="at least one interaction"):
        integrators._mts_fractions(pt.MTSIntegrator(dt=OUTER_DT),
                                   ps.update(pairwise_inters=(),
                                             specific_lists=(),
                                             general_inters=()))
