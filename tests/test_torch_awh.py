"""AWH of mollytpu_torch (free_energy/awh.py) against the JAX package,
float64 on the CPU.

The estimator (reweighting, Gibbs sampling of the next window, the
log-ratio update with well-tempered target and the covering stage) is the
JAX package's NumPy code: fed the same energies and the same numpy seed
it gives the same windows, f, rho, stage and visits, to 1e-12. The drivers
run on the harmonic dimer of tests/test_free_energy.py (two atoms, one
bond, dense engine, no list) with the JAX package's own Langevin noise
replayed into the port (its key schedule: per iteration or update
``key, sub = split(key)``, then one split of ``sub`` per step,
torch_parity.jax_noise_sequence): AWHSimulation over three umbrella
windows, with and without AWHPMFBackend, draws the same windows and ends
at the same f (1e-9) and coordinates (1e-9 nm) after 20 iterations;
GridAWH ends with the same f_est and histogram.
"""

import jax
import numpy as np
import pytest

import mollytpu as mt

import mollytpu_torch as pt
from mollytpu_torch.bridge import free_energy_from_arrays, system_from_arrays
from tests.test_free_energy import _dimer_system
from torch_parity import CPU, jax_noise_sequence, np64
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-9
TEMP, DT, FRICTION = 120.0, 0.002, 5.0
CENTERS = (0.40, 0.50, 0.60)


def _estimator_space(mod):
    """Four states at different temperatures, two with a pressure."""
    return mod.ExtendedStateSpace(tuple(
        mod.ThermoState(lam=1.0, temperature=t, pressure=p)
        for t, p in ((300.0, None), (310.0, 0.05), (320.0, None),
                     (330.0, 0.08))))


def _feed(mod, energies, volumes):
    st = mod.AWHState.create(_estimator_space(mod), first_state=2,
                             n_bias=4.0)
    awh = mod.AWHSimulation(state=st, simulator=None, update_freq=2,
                            well_tempered_factor=5.0, log_freq=3)
    rng = np.random.default_rng(4)
    pe = []
    for i, (e, v) in enumerate(zip(energies, volumes)):
        pe.append(awh._process_sample(e, volume=v))
        st.active_idx = awh._gibbs_sample_window(rng)
        awh._update_bias(i + 1)
    s = st.stats
    return dict(f=st.f, rho=st.rho, log_rho=st.log_rho,
                seg_weights=st.seg_weights, gibbs=st.gibbs_weights,
                n=st.n_samples_total, ref=st.ref_size,
                covering=st.covering_stage, visited=sorted(st.visited),
                active=st.active_idx, pe=pe, steps=s.step_indices,
                states=s.active_state, f_hist=s.f_history,
                n_eff=s.n_effective_history, stage=s.stage_history,
                max_df=s.max_delta_f_history)


def test_estimator_matches_jax():
    rng = np.random.default_rng(3)
    energies = rng.normal(0.0, 4.0, (80, 4)) + np.array([0, 2.0, 5.0, 9.0])
    volumes = rng.uniform(20.0, 30.0, 80)
    ours, ref = _feed(pt, energies, volumes), _feed(mt, energies, volumes)
    assert ours.keys() == ref.keys()
    for k in ours:
        if k in ("stage", "visited", "covering", "active", "states",
                 "steps"):
            assert ours[k] == ref[k], k
        else:
            np.testing.assert_allclose(np.asarray(ours[k], float),
                                       np.asarray(ref[k], float),
                                       rtol=1e-12, atol=1e-12, err_msg=k)
    # the covering stage ended and the stage history shows it
    assert not ours["covering"] and ours["stage"][-1] == "linear"


@pytest.fixture(scope="module")
def dimer():
    js = _dimer_system(500.0, 0.5, TEMP)
    return js, system_from_arrays(jax.device_get(js), device=CPU)


def _windows(mod):
    cv = mod.CalcSingleDist(0, 1)
    return cv, mod.ExtendedStateSpace.umbrella_windows(
        [mod.BiasPotential(bias=mod.SquareBias(k=400.0, cv0=c), cv=cv)
         for c in CENTERS], temperature=TEMP)


def _awh_run(mod, sys, with_pmf, **run):
    cv, space = _windows(mod)
    st = mod.AWHState.create(space, first_state=1, n_bias=5.0)
    pmf = (mod.AWHPMFBackend(st, grid=(0.35, 0.65, 12), cv=cv)
           if with_pmf else None)
    awh = mod.AWHSimulation(
        state=st, simulator=mod.Langevin(dt=DT, temperature=TEMP,
                                         friction=FRICTION),
        n_md_steps=10, update_freq=1, log_freq=1, pmf=pmf)
    out = awh.simulate(sys, 10 * 20, seed=2, **run)
    return awh, out


@pytest.mark.parametrize("with_pmf", [False, True], ids=["plain", "pmf"])
def test_awh_simulation_matches_jax(dimer, with_pmf):
    js, ps = dimer
    key = jax.random.PRNGKey(21)
    awh_j, out_j = _awh_run(mt, js, with_pmf, key=key)
    noise = {}
    for it in range(20):
        key, sub = jax.random.split(key)
        for k, z in enumerate(jax_noise_sequence(sub, 10, (2, 3))):
            noise[10 * it + k] = z
    awh, out = _awh_run(pt, ps, with_pmf, noise=lambda step_n: noise[step_n])
    st, st_j = awh.state, awh_j.state
    assert st.stats.active_state == st_j.stats.active_state
    assert len(set(st.stats.active_state)) > 1       # windows were switched
    np.testing.assert_allclose(awh.free_energies(), awh_j.free_energies(),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(st.rho, st_j.rho, rtol=TOL)
    assert (st.ref_size, st.covering_stage, awh.current_step) == (
        st_j.ref_size, st_j.covering_stage, awh_j.current_step)
    np.testing.assert_allclose(np64(out.coords), np64(out_j.coords),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(np64(out.velocities), np64(out_j.velocities),
                               rtol=0, atol=1e-7)
    # the returned system is the unbiased input's, bias stripped
    assert out.general_inters == ps.general_inters
    if with_pmf:
        np.testing.assert_allclose(awh.pmf.cv_history,
                                   awh_j.pmf.cv_history, rtol=TOL)
        assert awh.pmf.active_idx_history == awh_j.pmf.active_idx_history
        np.testing.assert_array_equal(awh.pmf.acc.counts,
                                      awh_j.pmf.acc.counts)
        np.testing.assert_allclose(awh.pmf.acc.log_num,
                                   awh_j.pmf.acc.log_num, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(awh.pmf.log_coupling,
                                   awh_j.pmf.log_coupling, rtol=1e-14)
        res, res_j = awh.pmf.pmf(), awh_j.pmf.pmf()
        np.testing.assert_allclose(res.values(), res_j.values(), rtol=TOL,
                                   atol=TOL)


def test_grid_awh_matches_jax(dimer):
    """GridAWH: 8 updates of 25 steps; each update's simulate removes the
    centre-of-mass motion first on both sides."""
    js, ps = dimer
    n_up, n_steps = 8, 25
    key = jax.random.PRNGKey(23)
    args = dict(temperature=TEMP, lo=0.45, hi=0.55, n_bins=10,
                n_steps_per_update=n_steps, initial_update=2.0)
    jcv = mt.CalcSingleDist(0, 1)
    awh_j = mt.GridAWH(cv=jcv, simulator=mt.Langevin(
        dt=DT, temperature=TEMP, friction=FRICTION), **args)
    out_j, st_j = awh_j.simulate(js, n_up, key=key)
    noise = []
    for _ in range(n_up):
        key, sub = jax.random.split(key)
        noise.append(jax_noise_sequence(sub, n_steps, (2, 3)))
    awh = pt.GridAWH(cv=free_energy_from_arrays(jcv, device=CPU),
                     simulator=pt.Langevin(dt=DT, temperature=TEMP,
                                           friction=FRICTION), **args)
    out, st = awh.simulate(ps, n_up, noise=lambda u, k: noise[u][k])
    np.testing.assert_allclose(st.f_est, st_j.f_est, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(st.hist, st_j.hist)
    assert (st.update_size, st.n_updates, st.covering_stage) == (
        st_j.update_size, st_j.n_updates, st_j.covering_stage)
    assert np.count_nonzero(st.f_est) > 1
    np.testing.assert_allclose(np64(out.coords), np64(out_j.coords),
                               rtol=0, atol=TOL)
    c, f = awh.pmf(st)
    np.testing.assert_allclose(f, awh_j.pmf(st_j)[1], atol=1e-12)
    assert np.allclose(c, st.centers)
