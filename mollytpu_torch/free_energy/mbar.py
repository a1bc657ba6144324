"""MBAR, the multistate Bennett acceptance ratio, and PMFs along a CV
(counterpart of mollytpu/free_energy/mbar.py).

The reduced potentials u_kn stay on their device, in float64; the
self-consistent sweeps and the damped Newton steps are Python loops over
logsumexp reductions. The PMF's error bars come from the asymptotic
covariance of the augmented weight matrix, one (K + 2)^2 pseudo-inverse
pair per bin, batched over the bins.
"""

from __future__ import annotations

import dataclasses

import torch

from ..units import KB


@dataclasses.dataclass(frozen=True)
class MBARInput:
    """u_kn: (K, N) reduced potentials of every sample n in every state k
    (u = beta_k U_k(x_n)); n_k: (K,) samples drawn from each state."""

    u_kn: torch.Tensor
    n_k: torch.Tensor


def assemble_mbar_inputs(energies_per_state, betas=None, temperature=None):
    """MBARInput from a (K, K, S) array: energies[k, l, s] = U_l of sample s
    drawn in state k, reduced with the evaluating state's beta (``betas``,
    or 1 / (KB T) for the per-state ``temperature``)."""
    e = torch.as_tensor(energies_per_state, dtype=torch.float64)
    k, l, s = e.shape
    if k != l:
        raise ValueError(f"energies must be (K, K, S), got {tuple(e.shape)}")
    if betas is None:
        betas = 1.0 / (KB * torch.as_tensor(temperature, dtype=e.dtype,
                                            device=e.device))
    betas = torch.as_tensor(betas, dtype=e.dtype, device=e.device)
    u = e * betas.expand(l)[None, :, None]
    u_kn = u.permute(1, 0, 2).reshape(l, k * s)
    n_k = torch.full((k,), s, dtype=torch.int64, device=e.device)
    return MBARInput(u_kn=u_kn, n_k=n_k)


def _log_denominators(u_kn, log_n, f):
    """log sum_k N_k exp(f_k - u_kn) per sample, (N,)."""
    return torch.logsumexp(log_n[:, None] + f[:, None] - u_kn, dim=0)


def _sweep(u_kn, log_n, f):
    """One self-consistent update of f, in the gauge f_0 = 0."""
    ld = _log_denominators(u_kn, log_n, f)
    f = -torch.logsumexp(-u_kn - ld[None, :], dim=1)
    return f - f[0]


def _weights_residual(u_kn, log_n, n_k, f):
    """W (K, N) = N_k exp(f_k - u_kn) / sum_l N_l exp(f_l - u_ln), and the
    residual N_k - sum_n W_kn of the MBAR equations."""
    ld = _log_denominators(u_kn, log_n, f)
    w = torch.exp(log_n[:, None] + f[:, None] - u_kn - ld[None, :])
    return w, n_k - w.sum(dim=1)


def _objective(u_kn, log_n, n_k, f):
    """The convex function that the MBAR solution minimises,
    sum_n log sum_k N_k exp(f_k - u_kn) - sum_k N_k f_k; its gradient is
    -(N_k - sum_n W_kn)."""
    return _log_denominators(u_kn, log_n, f).sum() - (n_k * f).sum()


def iterate_mbar(inp, n_iters=200, newton_iters=20, tol=1e-10):
    """Solve the MBAR equations sum_n W_kn = N_k: free energies f_k
    (dimensionless, gauge f_0 = 0), by ``n_iters`` self-consistent sweeps
    and then ``newton_iters`` damped Newton steps. ``tol`` is kept for the
    JAX signature; as there, the iteration counts are fixed.

    The Newton direction is J^-1 g with g = N - sum_n W and
    J = d(sum_n W)/df = diag(sum_n W) - W W^T. Where windows overlap
    poorly the sweeps converge slowly and a full step from where they stop
    can overshoot by far (by 1e11 kT on chip_smoke.py's alchemical water
    windows), so the step is halved until the objective does not rise or
    the residual |g| falls (near the solution the objective's change is
    below its rounding). The JAX package takes full steps to f - J^-1 g
    (mollytpu/free_energy/mbar.py:81), which double the distance to the
    solution at every step; this port steps towards it."""
    u_kn = inp.u_kn
    n_k = inp.n_k.to(u_kn.dtype)
    k = u_kn.shape[0]
    log_n = torch.log(n_k)
    f = torch.zeros(k, dtype=u_kn.dtype, device=u_kn.device)
    for _ in range(n_iters):
        f = _sweep(u_kn, log_n, f)
    eye = torch.eye(k - 1, dtype=f.dtype, device=f.device)
    for _ in range(newton_iters):
        w, g = _weights_residual(u_kn, log_n, n_k, f)
        jac = torch.diag(w.sum(dim=1)) - w @ w.T
        # gauge f_0 = 0: solve the reduced system
        df = torch.linalg.solve(jac[1:, 1:] + 1e-10 * eye, g[1:])
        step = torch.cat([torch.zeros_like(f[:1]), df])
        obj, res = _objective(u_kn, log_n, n_k, f), g.abs().max()
        t = 1.0
        for _ in range(60):
            trial = f + t * step
            if bool(_objective(u_kn, log_n, n_k, trial) <= obj) or bool(
                    _weights_residual(u_kn, log_n, n_k, trial)[1].abs()
                    .max() < res):
                f = trial
                break
            t *= 0.5
    return f


def mbar_weights(inp, f=None):
    """Normalized sample weights of each state, (K, N), rows summing to 1."""
    if f is None:
        f = iterate_mbar(inp)
    log_n = torch.log(inp.n_k.to(inp.u_kn.dtype))
    logw = -inp.u_kn - _log_denominators(inp.u_kn, log_n, f)[None, :]
    logw = logw - torch.logsumexp(logw, dim=1, keepdim=True)
    return torch.exp(logw)


def free_energy_differences(inp, temperature=None):
    """(K, K) matrix of f_l - f_k; in kJ/mol when ``temperature`` is
    given."""
    f = iterate_mbar(inp)
    df = f[None, :] - f[:, None]
    if temperature is not None:
        df = df * KB * temperature
    return df


@dataclasses.dataclass
class PMF:
    """Potential of mean force on a CV grid: bin centres, values in kJ/mol
    shifted to a minimum of 0, and their uncertainties (kJ/mol) or None."""

    centers: torch.Tensor
    values: torch.Tensor
    uncertainties: torch.Tensor = None


def _bins(u_kn, cv_samples, bin_edges):
    """The edges as a tensor beside u_kn and each sample's bin, clipped
    into the first and last (jnp.searchsorted's left side)."""
    edges = torch.as_tensor(bin_edges, dtype=u_kn.dtype, device=u_kn.device)
    cv = torch.as_tensor(cv_samples, dtype=u_kn.dtype, device=u_kn.device)
    nbins = edges.shape[0] - 1
    which = torch.clamp(torch.searchsorted(edges, cv) - 1, 0, nbins - 1)
    return edges, which, nbins


def _target(u_kn, target_state_u):
    """The target state's reduced potential per sample, (N,): zeros (a
    uniform target) when None."""
    if target_state_u is None:
        return torch.zeros(u_kn.shape[1], dtype=u_kn.dtype,
                           device=u_kn.device)
    return torch.as_tensor(target_state_u, dtype=u_kn.dtype,
                           device=u_kn.device)


def mbar_pmf(inp, cv_samples, bin_edges, temperature, target_state_u=None):
    """PMF along a CV from the MBAR weights of the target state.
    cv_samples: (N,) CV value per sample, ordered as u_kn's columns;
    target_state_u: (N,) reduced potential of the target (unbiased) state
    per sample (zeros: a uniform target). Empty bins get a large finite
    value (-kT log 1e-300), as in the JAX package; pmf_with_uncertainty
    gives them NaN and error bars."""
    f = iterate_mbar(inp)
    u_kn = inp.u_kn
    ld = _log_denominators(u_kn, torch.log(inp.n_k.to(u_kn.dtype)), f)
    v = -_target(u_kn, target_state_u) - ld
    w = torch.exp(v - torch.logsumexp(v, dim=0))
    edges, which, nbins = _bins(u_kn, cv_samples, bin_edges)
    p = torch.zeros(nbins, dtype=w.dtype, device=w.device).index_add_(
        0, which, w)
    kt = KB * temperature
    vals = -kt * torch.log(torch.clamp(p, min=1e-300))
    vals = vals - vals.min()
    return PMF(centers=0.5 * (edges[:-1] + edges[1:]), values=vals)


def _pmf_cov(u_kn, n_k, f, target_state_u, which, nbins):
    """Bin probabilities p (nbins,) and their variances (NaN in empty
    bins) by the asymptotic covariance of the augmented weights
    (pymbar eq. D6): for every bin A, the K sampled states' weights are
    augmented by the bin's normalised indicator weights and the target's,
    G = W_aug W_aug^T, Sigma = pinv(pinv(G) - diag(N, 0, 0)), and
    var(p_A) = p_A^2 (Sigma_AA + Sigma_aa - 2 Sigma_Aa). The K x K block
    and the target's borders are the same for every bin; the per-bin
    matrices are stacked and pseudo-inverted as one batch."""
    dt = u_kn.dtype
    log_n = torch.log(n_k.to(dt))
    ld = _log_denominators(u_kn, log_n, f)
    w_samp = torch.exp(f[:, None] - u_kn - ld[None, :])      # (K, N)
    v = -target_state_u - ld
    w_na = torch.exp(v - torch.logsumexp(v, dim=0))          # (N,)
    a = torch.nn.functional.one_hot(which, nbins).to(dt).T    # (nbins, N)
    p = a @ w_na
    log_cab = torch.logsumexp(torch.where(a > 0, v[None, :], -torch.inf),
                              dim=1)
    w_nab = a * torch.exp(v[None, :] - log_cab[:, None])
    w_nab = torch.where(torch.isfinite(log_cab)[:, None], w_nab, 0.0)

    k = u_kn.shape[0]
    g = torch.zeros((nbins, k + 2, k + 2), dtype=dt, device=u_kn.device)
    g[:, :k, :k] = w_samp @ w_samp.T
    g_kb = (w_samp @ w_nab.T).T                              # (nbins, K)
    g[:, :k, k] = g_kb
    g[:, k, :k] = g_kb
    g_ka = w_samp @ w_na
    g[:, :k, k + 1] = g_ka
    g[:, k + 1, :k] = g_ka
    g[:, k, k] = torch.sum(w_nab * w_nab, dim=1)
    g_ab = w_nab @ w_na
    g[:, k, k + 1] = g_ab
    g[:, k + 1, k] = g_ab
    g[:, k + 1, k + 1] = w_na @ w_na
    n_aug = torch.diag(torch.cat([n_k.to(dt), torch.zeros(
        2, dtype=dt, device=u_kn.device)]))
    # jnp.linalg.pinv's default cutoff, 10 max(M, N) eps of the largest
    # singular value (torch's is a tenth of it); G is singular wherever the
    # target's weights lie in the span of the states' rows
    rtol = 10.0 * (k + 2) * torch.finfo(dt).eps
    sig = torch.linalg.pinv(torch.linalg.pinv(g, rtol=rtol) - n_aug,
                            rtol=rtol, hermitian=True)
    var_p = p * p * (sig[:, k, k] + sig[:, k + 1, k + 1]
                     - 2.0 * sig[:, k, k + 1])
    var_p = torch.where(p > 0, torch.clamp(var_p, min=0.0), torch.nan)
    return p, var_p


def pmf_with_uncertainty(inp, cv_samples, bin_edges, temperature,
                         target_state_u=None):
    """PMF along a CV with asymptotic-covariance error bars. Same
    arguments as mbar_pmf. Uncertainties are kT sigma_F with sigma_F =
    sqrt(var p_A) / p_A, the delta-method deviation of -log p_A; empty
    bins get NaN in both values and uncertainties."""
    f = iterate_mbar(inp)
    u_kn = inp.u_kn
    edges, which, nbins = _bins(u_kn, cv_samples, bin_edges)
    p, var_p = _pmf_cov(u_kn, inp.n_k, f, _target(u_kn, target_state_u),
                        which, nbins)
    kt = KB * temperature
    vals = torch.where(p > 0, -kt * torch.log(torch.clamp(p, min=1e-300)),
                       torch.nan)
    vals = vals - torch.nan_to_num(vals, nan=torch.inf).min()
    sigma = kt * torch.sqrt(var_p) / torch.clamp(p, min=1e-300)
    return PMF(centers=0.5 * (edges[:-1] + edges[1:]), values=vals,
               uncertainties=sigma)
