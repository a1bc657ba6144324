"""The PMF half of MBAR (free_energy/mbar.py: mbar_pmf,
pmf_with_uncertainty) and the PMF estimators (free_energy/pmf.py,
free_energy/reweighting.py) of mollytpu_torch against the JAX package.

MBAR PMFs run on seeded harmonic-oscillator reduced potentials, the
inputs of tests/test_free_energy.py's MBAR checks at smaller sample
counts: three oscillators reweighted to a uniform target, one state
reweighted to itself (the singular augmented matrix) and two umbrella
windows. Both sides solve MBAR to 1e-12 in f on these well-overlapping
states (the port's damped Newton and the JAX package's full steps meet
there), so the PMF values agree to 1e-9 kJ/mol. The error bars come from
two pseudo-inverses of (K + 2)^2 matrices whose conditioning grows as a
bin empties: in bins of one or two samples LAPACK's SVD and eigh in the
two packages round apart by 6e-9 relative (1e-11 in the others), so they
are held to 1e-7 relative. Empty bins are NaN in both.

pmf.py and reweighting.py are the same NumPy code in both packages: every
public function on the same inputs, 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.free_energy import pmf as jax_pmf
from mollytpu.free_energy import reweighting as jax_rw

import mollytpu_torch as pt
from mollytpu_torch.free_energy import pmf, reweighting
from mollytpu_torch.units import KB
from torch_parity import np64
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL, TOL_SIGMA = 1e-9, 1e-7
#: kT = 1 in internal units
TEMP = 1.0 / KB


def _case(name):
    """(u_kn, n_k, cv samples, bin edges, target u or None)."""
    rng = np.random.default_rng({"oscillators": 0, "self": 7,
                                 "umbrellas": 8}[name])
    if name == "oscillators":
        ks = np.array([1.0, 2.0, 4.0])
        x = np.concatenate([rng.normal(0.0, np.sqrt(1.0 / k), 1500)
                            for k in ks])
        u_kn = 0.5 * ks[:, None] * x[None, :] ** 2
        # wider than the samples: the outer bins stay empty
        return u_kn, [1500] * 3, x, np.linspace(-6.0, 6.0, 25), None
    if name == "self":
        x = rng.normal(0.0, 1.0, 3000)
        u_kn = (0.5 * x ** 2)[None, :]
        return u_kn, [3000], x, np.linspace(-2.5, 2.5, 11), u_kn[0]
    ks, centers = np.array([1.0, 4.0]), np.array([0.0, 1.0])
    x = np.concatenate([rng.normal(c, np.sqrt(1.0 / k), 1500)
                        for k, c in zip(ks, centers)])
    u_kn = 0.5 * ks[:, None] * (x[None, :] - centers[:, None]) ** 2
    return u_kn, [1500] * 2, x, np.linspace(-1.0, 2.0, 13), None


CASES = ("oscillators", "self", "umbrellas")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fn", ["mbar_pmf", "pmf_with_uncertainty"])
def test_mbar_pmf_matches_jax(case, fn):
    u_kn, n_k, x, edges, target = _case(case)
    jinp = mt.MBARInput(u_kn=jnp.asarray(u_kn), n_k=jnp.asarray(n_k))
    inp = pt.MBARInput(u_kn=torch.as_tensor(u_kn),
                       n_k=torch.as_tensor(n_k))
    j = getattr(mt, fn)(jinp, jnp.asarray(x), edges, TEMP,
                        target_state_u=None if target is None
                        else jnp.asarray(target))
    p = getattr(pt, fn)(inp, torch.as_tensor(x), edges, TEMP,
                        target_state_u=None if target is None
                        else torch.as_tensor(target))
    assert isinstance(p, pt.PMF)
    np.testing.assert_allclose(np64(p.centers), np64(j.centers), rtol=0,
                               atol=1e-15)
    vals, vals_j = np64(p.values), np64(j.values)
    np.testing.assert_array_equal(np.isnan(vals), np.isnan(vals_j))
    np.testing.assert_allclose(vals, vals_j, rtol=0, atol=TOL)
    if fn == "mbar_pmf":
        assert p.uncertainties is None and j.uncertainties is None
        return
    unc, unc_j = np64(p.uncertainties), np64(j.uncertainties)
    np.testing.assert_array_equal(np.isnan(unc), np.isnan(unc_j))
    np.testing.assert_allclose(unc, unc_j, rtol=TOL_SIGMA, atol=1e-12)
    if case == "oscillators":
        assert np.isnan(vals[[0, -1]]).all() and np.isnan(unc[[0, -1]]).all()
    else:
        assert np.isfinite(unc).all()


# -- pmf.py and reweighting.py --------------------------------------------


def _deconvolution(mod, spec, biases):
    """A seeded run through every public function of ``mod``'s pmf module
    on the grid ``spec`` with per-state ``biases``; returns the outputs."""
    rng = np.random.default_rng(11)
    grid = mod.PMFGrid.create(spec)
    n_states = 3
    betas = np.array([0.4, 0.5, 0.6])
    out = {"shape": grid.shape, "ndim": grid.ndim,
           "volumes": grid.volumes, "centers": grid.centers}
    if grid.ndim == 1:
        out["coupling_b"] = mod.build_log_coupling_matrix(
            grid, n_states, biases=biases, betas=betas)
    out["coupling_c"] = coupling = mod.build_log_coupling_matrix(
        grid, n_states, coupling=lambda xi, k: 0.3 * (k + 1) * float(
            np.sum(np.square(xi))))
    log_w = rng.normal(size=n_states)
    out["log_w"] = lw = mod.pmf_log_bin_weights(coupling, log_w,
                                                log_weight_factor=-0.2)
    acc = mod.SampledPMFDeconvolutionAccumulator(grid=grid)
    other = mod.SampledPMFDeconvolutionAccumulator(grid=grid)
    lo = [e[0] - 0.2 for e in grid.edges]
    hi = [e[-1] + 0.2 for e in grid.edges]
    for s in range(200):
        value = tuple(rng.uniform(lo, hi))
        target = acc if s % 3 else other
        target.accumulate(value if grid.ndim > 1 else value[0], lw,
                          log_reweight=0.1 * rng.normal())
    out["bin_index"] = [grid.bin_index(tuple(e[-1] for e in grid.edges)),
                        grid.bin_index(tuple(e[0] - 1.0
                                             for e in grid.edges))]
    out["bin_center"] = grid.bin_center((1,) * grid.ndim)
    acc.merge(other)
    for name in ("log_num", "log_num_sq", "max_log_w", "counts"):
        out[name] = getattr(acc, name)
    out["samples"] = (acc.total_samples, acc.accepted_samples,
                      acc.out_of_grid_samples)
    out["ess"] = acc.effective_samples()
    out["maxfrac"] = acc.max_weight_fraction()
    out["probability"] = p = acc.probability()
    q = mod.pmf_bin_quality(acc, min_count=5, min_ess=2.0)
    out["quality"] = (q.counts, q.ess, q.maxfrac, q.reliable)
    for zero in ("min", "last", "none"):
        r = mod.pmf_result_from_sampled_deconvolution(
            acc, zero=zero, kBT=2.5, quality=q, gauge_reliable_only=True,
            mask_unreliable=True)
        out[f"result_{zero}"] = (r.F, r.probability, r.values(), r.centers)
    raw = mod.pmf_raw_free_energy_from_probability(grid, p)
    out["raw"] = raw
    out["from_raw"] = mod.pmf_probability_from_raw_free_energy(grid, raw)
    out["ref"] = mod.pmf_reference_index(raw, "min")
    r = mod.pmf_result_from_probability(grid, p, zero="last", kBT=1.5,
                                        sigma_F=np.ones(grid.shape))
    out["result_p"] = (r.F, r.sigma_F)
    return out


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif a is None:
        assert b is None
    else:
        np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                                   np.asarray(b, dtype=np.float64),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("spec", [(0.2, 0.8, 12),
                                  [(0.0, 1.0, 5), (-1.0, 1.0, 4)]],
                         ids=["1d", "2d"])
def test_pmf_module_matches_jax(spec):
    centers = (0.3, 0.5, 0.7)
    biases_j = [mt.SquareBias(k=200.0, cv0=c) for c in centers]
    biases = [pt.SquareBias(k=200.0, cv0=c) for c in centers]
    _assert_same(_deconvolution(pmf, spec, biases),
                 _deconvolution(jax_pmf, spec, biases_j))
    assert pt.PMFGridND is pmf.PMFGrid


def test_reweighting_matches_jax():
    """OnlinePMFAccumulator under an umbrella bias, its grid and
    pmf_deconvolution."""
    rng = np.random.default_rng(12)
    samples = rng.normal(0.45, 0.08, 300)
    outs = []
    for mod, bias in ((reweighting, pt.SquareBias(k=500.0, cv0=0.45)),
                      (jax_rw, mt.SquareBias(k=500.0, cv0=0.45))):
        acc = mod.OnlinePMFAccumulator(grid=mod.PMFGrid(0.2, 0.7, 10),
                                       temperature=300.0, bias=bias)
        for k, x in enumerate(samples):
            acc.add(float(x), extra_log_weight=0.01 * k)
        centers, vals = acc.pmf()
        dec = mod.pmf_deconvolution(centers, np.nan_to_num(vals, posinf=50),
                                    lambda c: float(bias(c)), 300.0)
        outs.append((acc.grid.bin_of(samples), acc.grid.log_w,
                     acc.grid.counts, centers, vals, dec))
    _assert_same(outs[0], outs[1])
