"""MBAR, the multistate Bennett acceptance ratio (counterpart of
mollytpu/free_energy/mbar.py:24-108; the PMF functions are not ported).

The reduced potentials u_kn stay on their device, in float64; the
self-consistent sweeps and the damped Newton steps are Python loops over
logsumexp reductions.
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
