"""The free-energy modules of mollytpu_torch against the JAX package:
the lambda schedulers and the per-pair / per-atom scales of
free_energy/alchemy.py, MBAR (free_energy/mbar.py) and the time-series
statistics (free_energy/stats.py), float64 throughout.

Tolerances: the schedules are the same piecewise formulas, 1e-15
absolute; MBAR's self-consistent sweeps are the JAX package's, 1e-12 in
f (in units of kT), and its solution is held to the JAX sweeps run to
convergence, 1e-10 absolute in f and in the weights, 1e-9 where the
windows barely overlap; the statistics are the same numpy code, 1e-12.
The JAX package's NAMD and EleScaled instances cannot call the schedule
they share with the default scheduler (alchemy.py:62 and :84 bind a plain
function as a method), so its scheduler classes are called instead.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.free_energy import alchemy as jax_alchemy
from mollytpu.free_energy import mbar as jax_mbar
from mollytpu.free_energy import stats as jax_stats

import mollytpu_torch as pt
from mollytpu_torch.free_energy import alchemy, mbar, stats
from torch_parity import CPU, np64
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SCHEDULERS = ("DefaultLambdaScheduler", "NAMDLambdaScheduler",
              "QuartersLambdaScheduler", "EleScaledLambdaScheduler")
#: a lambda grid through every breakpoint of the four schedules
GRID = np.unique(np.concatenate([np.linspace(0.0, 1.0, 97),
                                 [0.25, 1 / 3, 0.5, 2 / 3, 0.75]]))
ROLES = (pt.ALCH_CORE, pt.ALCH_INSERT, pt.ALCH_DELETE)


def _pairs():
    """Every (lambda, role_i, role_j) of the grid."""
    lam, ri, rj = np.meshgrid(GRID, ROLES, ROLES, indexing="ij")
    return lam.ravel(), ri.ravel().astype(np.int32), \
        rj.ravel().astype(np.int32)


@pytest.mark.parametrize("name", SCHEDULERS)
@pytest.mark.parametrize("fn", ["scale_sterics", "scale_elec"])
def test_scheduler_matches_jax(name, fn):
    lam, role, _ = _pairs()
    ours = getattr(getattr(alchemy, name)(), fn)(torch.as_tensor(lam),
                                                 torch.as_tensor(role))
    ref = getattr(getattr(jax_alchemy, name), fn)(jnp.asarray(lam),
                                                  jnp.asarray(role))
    np.testing.assert_allclose(np64(ours), np64(ref), rtol=0, atol=1e-15)


@pytest.mark.parametrize("name", SCHEDULERS)
def test_pair_and_atom_scales_match_jax(name):
    """sterics_lambda and elec_lambda over every role pair (same non-core
    roles fully on), mix_roles, and scaled_charge."""
    lam, ri, rj = _pairs()
    tl, ti, tj = map(torch.as_tensor, (lam, ri, rj))
    jl, ji, jj = map(jnp.asarray, (lam, ri, rj))
    sched, jsched = getattr(alchemy, name)(), getattr(jax_alchemy, name)
    for fn in ("sterics_lambda", "elec_lambda"):
        np.testing.assert_allclose(
            np64(getattr(alchemy, fn)(sched, tl, ti, tj)),
            np64(getattr(jax_alchemy, fn)(jsched, jl, ji, jj)),
            rtol=0, atol=1e-15)
    np.testing.assert_array_equal(np64(alchemy.mix_roles(ti, tj)),
                                  np64(jax_alchemy.mix_roles(ji, jj)))
    q = np.random.default_rng(3).uniform(-1.0, 1.0, lam.shape)
    np.testing.assert_allclose(
        np64(alchemy.scaled_charge(sched, torch.as_tensor(q), tl, ti)),
        np64(jax_alchemy.scaled_charge(jsched, jnp.asarray(q), jl, ji)),
        rtol=0, atol=1e-15)


def test_pair_lambdas_are_the_kernel_block():
    """The kernel's lambda block (pair_kernel.pair_lambdas, roles as floats)
    equals the dense path's per-pair scales, with LJ off where either
    atom's lambda is exactly 0."""
    from mollytpu_torch.ops.pair_kernel import FusedSpec, pair_lambdas
    rng = np.random.default_rng(4)
    k = 3000
    li = np.where(rng.uniform(size=k) < 0.2, 0.0, rng.uniform(size=k))
    lj = np.where(rng.uniform(size=k) < 0.2, 0.0, rng.uniform(size=k))
    ri, rj = rng.integers(0, 3, k), rng.integers(0, 3, k)
    for name in SCHEDULERS:
        sched = getattr(alchemy, name)()
        lam_s, lam_e = pair_lambdas(
            FusedSpec(scheduler=sched),
            *(torch.as_tensor(a, dtype=torch.float64)
              for a in (li, lj, ri, rj)))
        mix = torch.as_tensor(np.minimum(li, lj))
        ti, tj = torch.as_tensor(ri), torch.as_tensor(rj)
        ref_s = alchemy.sterics_lambda(sched, mix, ti, tj)
        ref_s = torch.where(torch.as_tensor((li != 0) & (lj != 0)), ref_s,
                            0.0)
        assert torch.equal(lam_s, ref_s)
        assert torch.equal(lam_e, alchemy.elec_lambda(sched, mix, ti, tj))


def _u_kn(seed, k=5, s=2000):
    """Reduced potentials of a harmonic oscillator family: samples of
    state k from N(mu_k, 1), evaluated in every state."""
    rng = np.random.default_rng(seed)
    mu = np.linspace(0.0, 2.0, k)
    kappa = np.linspace(1.0, 1.6, k)
    x = np.concatenate([rng.normal(m, 1.0 / np.sqrt(c), s)
                        for m, c in zip(mu, kappa)])
    u = 0.5 * kappa[:, None] * (x[None, :] - mu[:, None]) ** 2
    return u, np.full(k, s)


@pytest.mark.parametrize("seed", [0, 1])
def test_mbar_matches_jax(seed):
    """The self-consistent sweeps alone against the JAX package's (1e-12);
    the solution with the damped Newton steps against the JAX sweeps run to
    convergence (2,000 sweeps, 1e-10) and against the MBAR equations
    themselves; weights and differences against the JAX functions at the
    same f. The JAX package's own Newton polish steps away from the
    solution (iterate_mbar's docstring), so its default result is not the
    reference."""
    u, n_k = _u_kn(seed)
    jinp = jax_mbar.MBARInput(u_kn=jnp.asarray(u), n_k=jnp.asarray(n_k))
    inp = mbar.MBARInput(u_kn=torch.as_tensor(u), n_k=torch.as_tensor(n_k))
    np.testing.assert_allclose(
        np64(mbar.iterate_mbar(inp, newton_iters=0)),
        np64(jax_mbar.iterate_mbar(jinp, newton_iters=0)), rtol=0, atol=1e-12)
    f = mbar.iterate_mbar(inp)
    f_j = jax_mbar.iterate_mbar(jinp, n_iters=2000, newton_iters=0)
    np.testing.assert_allclose(np64(f), np64(f_j), rtol=0, atol=1e-10)
    assert float(f[0]) == 0.0
    # sum_n W_kn = N_k at the solution
    log_d = torch.logsumexp(torch.log(inp.n_k.double())[:, None]
                            + f[:, None] - inp.u_kn, dim=0)
    w_sum = (torch.log(inp.n_k.double())[:, None] + f[:, None] - inp.u_kn
             - log_d).exp().sum(dim=1)
    np.testing.assert_allclose(np64(w_sum), n_k, rtol=1e-12)
    np.testing.assert_allclose(np64(mbar.mbar_weights(inp, f)),
                               np64(jax_mbar.mbar_weights(jinp, f_j)),
                               rtol=0, atol=1e-10)
    df = mbar.free_energy_differences(inp, temperature=300.0)
    kt = pt.units.KB * 300.0
    np.testing.assert_allclose(np64(df), (np64(f_j)[None, :]
                                          - np64(f_j)[:, None]) * kt,
                               rtol=0, atol=1e-10 * kt)
    # the harmonic family's exact answer: f_k = -log sqrt(2 pi / kappa_k)
    kappa = np.linspace(1.0, 1.6, 5)
    exact = 0.5 * np.log(kappa / kappa[0])
    np.testing.assert_allclose(np64(f), exact, atol=0.1)


def _mbar_residual(u, n_k, f):
    """max_k |sum_n exp(f_k - u_kn) / sum_l N_l exp(f_l - u_ln) - 1|."""
    log_d = np.logaddexp.reduce(np.log(n_k)[:, None] + f[:, None] - u,
                                axis=0)
    return float(np.abs(np.exp(f[:, None] - u - log_d).sum(axis=1)
                        - 1.0).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_mbar_poor_overlap_matches_converged_sweeps(seed):
    """Windows with a gap in their coupling (linear response, u_k = c_k x,
    x ~ N(-c_k, 1), ten samples each) as alchemical windows have: 200
    sweeps stop far from the solution, and the damped Newton steps must
    finish the job without overshooting. The port's f solves the MBAR
    equations to 1e-12 and equals the JAX package's sweeps run 100,000
    times (its own Newton polish diverges) to 1e-9 kT."""
    rng = np.random.default_rng(seed)
    c = np.array([0.0, 0.5, 1.0, 5.0, 10.0])
    x = np.concatenate([rng.normal(-ck, 1.0, 10) for ck in c])
    u, n_k = c[:, None] * x[None, :], np.full(5, 10)
    jinp = jax_mbar.MBARInput(u_kn=jnp.asarray(u), n_k=jnp.asarray(n_k))
    f_200 = np64(jax_mbar.iterate_mbar(jinp, newton_iters=0))
    assert _mbar_residual(u, n_k, f_200) > 1e-3
    f = np64(mbar.iterate_mbar(mbar.MBARInput(u_kn=torch.as_tensor(u),
                                              n_k=torch.as_tensor(n_k))))
    f_ref = np64(jax_mbar.iterate_mbar(jinp, n_iters=100000,
                                       newton_iters=0))
    assert _mbar_residual(u, n_k, f) < 1e-12
    np.testing.assert_allclose(f, f_ref, rtol=0, atol=1e-9)


def test_assemble_mbar_inputs_matches_jax():
    rng = np.random.default_rng(8)
    e = rng.normal(size=(4, 4, 7)) * 10.0
    temps = np.array([300.0, 310.0, 320.0, 330.0])
    ours = mbar.assemble_mbar_inputs(torch.as_tensor(e), temperature=temps)
    ref = jax_mbar.assemble_mbar_inputs(jnp.asarray(e),
                                        temperature=jnp.asarray(temps))
    np.testing.assert_allclose(np64(ours.u_kn), np64(ref.u_kn), rtol=1e-15)
    np.testing.assert_array_equal(np64(ours.n_k), np64(ref.n_k))
    betas = 1.0 / (pt.units.KB * temps)
    by_beta = mbar.assemble_mbar_inputs(e, betas=betas)
    np.testing.assert_allclose(np64(by_beta.u_kn), np64(ref.u_kn),
                               rtol=1e-15)


@pytest.mark.parametrize("kind", ["ar1", "white", "constant", "short"])
def test_statistics_match_jax(kind):
    rng = np.random.default_rng(11)
    if kind == "ar1":
        x = np.zeros(500)
        for t in range(1, 500):
            x[t] = 0.9 * x[t - 1] + rng.normal()
    elif kind == "white":
        x = rng.normal(size=400)
    elif kind == "constant":
        x = np.full(50, 2.0)
    else:
        x = rng.normal(size=2)
    for series in (x, torch.as_tensor(x)):
        g = stats.statistical_inefficiency(series)
        assert g == pytest.approx(jax_stats.statistical_inefficiency(x),
                                  rel=1e-12, abs=1e-12)
        np.testing.assert_array_equal(stats.subsample_indices(series),
                                      jax_stats.subsample_indices(x))
        assert stats.effective_sample_size(series) == pytest.approx(
            jax_stats.effective_sample_size(x), rel=1e-12)
    if kind == "ar1":
        assert g > 5.0


def test_thermo_state_and_set_lambda():
    """beta = 1 / (KB T) as the JAX package's; set_lambda everywhere or on
    a mask, leaving the other fields alone."""
    assert pt.ThermoState(temperature=310.0).beta == pytest.approx(
        float(mt.ThermoState(temperature=310.0).beta), rel=1e-15)
    atoms = pt.make_atoms(n=6, mass=1.0, lam=0.4, dtype=torch.float64,
                          device=CPU)
    sys = pt.System(atoms=atoms, coords=torch.zeros((6, 3),
                                                    dtype=torch.float64),
                    boundary=pt.cubic(2.0, dtype=torch.float64, device=CPU))
    mask = torch.tensor([True, False, True, False, False, False])
    out = pt.set_lambda(sys, 0.9, atom_mask=mask)
    assert out.atoms.lam.tolist() == [0.9, 0.4, 0.9, 0.4, 0.4, 0.4]
    assert pt.set_lambda(sys, 0.1).atoms.lam.tolist() == [0.1] * 6
    assert out.atoms.charge is sys.atoms.charge
    assert sys.atoms.lam.tolist() == [0.4] * 6
    assert dataclasses.replace(out.atoms, lam=atoms.lam) == atoms
