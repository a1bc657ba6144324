"""N-dimensional PMF grids and sampled PMF deconvolution (counterpart of
mollytpu/free_energy/pmf.py, copied: host NumPy, no torch).

PMFGrid, the log coupling matrix of the states' biases on the grid, the
sampled deconvolution accumulator, bin quality and the PMF result: the
estimator backend that AWH and TSS share. Each sampled CV point enters a
self-normalized weighted histogram with the inverse time-dependent
effective bias at the observed bin (Lindahl et al. 2014, eq. 9). The work
per sample is O(n_bins x n_states) log-space arithmetic on the host; the
MD segments and the K-state energy sweeps that feed it run on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def _as_edge_spec(spec):
    """Normalize a grid spec: (lo, hi, n) | [(lo, hi, n), ...] | explicit
    edge arrays -> tuple of per-dimension edge arrays."""
    if isinstance(spec, PMFGrid):
        return spec.edges
    if (isinstance(spec, (tuple, list)) and len(spec) == 3
            and np.isscalar(spec[0]) and np.isscalar(spec[1])):
        lo, hi, n = spec
        return (np.linspace(float(lo), float(hi), int(n) + 1),)
    out = []
    for d in spec:
        if (isinstance(d, (tuple, list)) and len(d) == 3
                and np.isscalar(d[0]) and np.isscalar(d[1])):
            lo, hi, n = d
            out.append(np.linspace(float(lo), float(hi), int(n) + 1))
        else:
            e = np.asarray(d, dtype=np.float64)
            if e.ndim != 1 or len(e) < 2 or np.any(np.diff(e) <= 0):
                raise ValueError("PMF grid edges must be increasing 1-D arrays")
            out.append(e)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class PMFGrid:
    """Uniform-or-explicit N-D CV grid (pmf_deconvolution.jl:5-27)."""

    edges: Tuple[np.ndarray, ...]

    @classmethod
    def create(cls, spec):
        return cls(edges=_as_edge_spec(spec))

    @property
    def ndim(self):
        return len(self.edges)

    @property
    def shape(self):
        return tuple(len(e) - 1 for e in self.edges)

    @property
    def centers(self):
        return tuple(0.5 * (e[:-1] + e[1:]) for e in self.edges)

    @property
    def widths(self):
        return tuple(np.diff(e) for e in self.edges)

    @property
    def volumes(self):
        """(shape) array of bin volumes (product of per-dim widths)."""
        w = self.widths
        out = w[0].reshape([-1] + [1] * (self.ndim - 1)).copy()
        for d in range(1, self.ndim):
            out = out * w[d].reshape([1] * d + [-1] + [1] * (self.ndim - 1 - d))
        return out

    def bin_index(self, value):
        """Per-dim bin indices for a CV tuple; -1 marks out-of-grid
        (reference: online_pmf_bin_index, 0 there)."""
        vals = np.atleast_1d(np.asarray(value, dtype=np.float64))
        if vals.shape[-1] != self.ndim and self.ndim == 1:
            vals = vals.reshape(-1, 1)
        idx = []
        for d in range(self.ndim):
            e = self.edges[d]
            i = int(np.searchsorted(e, float(vals.reshape(-1)[d]),
                                    side="right")) - 1
            if i < 0 or i >= len(e) - 1:
                # right edge belongs to the last bin
                if float(vals.reshape(-1)[d]) == e[-1]:
                    i = len(e) - 2
                else:
                    return None
            idx.append(i)
        return tuple(idx)

    def bin_center(self, idx):
        return tuple(c[i] for c, i in zip(self.centers, idx))


@dataclasses.dataclass
class PMFResult:
    """PMF over a grid: free energies (kBT or energy units), probability,
    and optional per-bin uncertainty (pmf_result_from_raw_free_energy)."""

    grid: PMFGrid
    F: np.ndarray
    probability: np.ndarray
    sigma_F: np.ndarray = None

    @property
    def centers(self):
        c = self.grid.centers
        return c[0] if self.grid.ndim == 1 else c

    def values(self):
        return self.F.reshape(-1) if self.grid.ndim == 1 else self.F


def pmf_reference_index(F, zero="min", reference_mask=None):
    """Gauge-bin selection (pmf_deconvolution.jl:42-67)."""
    if zero not in ("min", "last", "none"):
        raise ValueError("zero must be one of 'min', 'last', 'none'")
    if zero == "none":
        return None
    finite = np.isfinite(F)
    if reference_mask is not None:
        finite = finite & np.asarray(reference_mask, bool)
    if not finite.any():
        raise ValueError("cannot gauge a PMF without finite bins")
    flat = np.where(finite.reshape(-1))[0]
    if zero == "min":
        return np.unravel_index(flat[np.argmin(F.reshape(-1)[flat])], F.shape)
    return np.unravel_index(flat[-1], F.shape)


def pmf_probability_from_raw_free_energy(grid, F):
    p = np.where(np.isfinite(F), np.exp(-np.where(np.isfinite(F), F, 0.0))
                 * grid.volumes, 0.0)
    total = p.sum()
    if total <= 0:
        raise ValueError("PMF probabilities cannot be normalized")
    return p / total


def pmf_raw_free_energy_from_probability(grid, probability):
    p = np.asarray(probability, dtype=np.float64)
    if p.shape != grid.shape:
        raise ValueError("probability shape does not match grid shape")
    if (p < 0).any():
        raise ValueError("PMF probabilities must be non-negative")
    F = np.full(grid.shape, np.inf)
    pos = p > 0
    F[pos] = -np.log(p[pos] / grid.volumes[pos])
    return F


def pmf_result_from_probability(grid, probability, zero="min", kBT=None,
                                sigma_F=None, reference_mask=None,
                                report_mask=None):
    F = pmf_raw_free_energy_from_probability(grid, probability)
    ref = pmf_reference_index(F, zero, reference_mask)
    if ref is not None:
        F = F - F[ref]
    if report_mask is not None:
        F = np.where(np.asarray(report_mask, bool), F, np.inf)
    if kBT is not None:
        F = F * float(kBT)
        if sigma_F is not None:
            sigma_F = np.asarray(sigma_F) * float(kBT)
    return PMFResult(grid=grid, F=F, probability=np.asarray(probability),
                     sigma_F=sigma_F)


def build_log_coupling_matrix(grid, n_states, coupling=None, biases=None,
                              betas=None):
    """(n_bins, n_states) matrix of -dimensionless bias energies
    (pmf_build_log_coupling_matrix, :164-210).

    coupling(xi, state_i) returns the dimensionless bias at PMF coordinate
    xi in state i; alternatively pass per-state `biases` (callables on the
    CV value, energy units) plus per-state `betas`.
    """
    shape = grid.shape
    n_bins = int(np.prod(shape))
    mat = np.zeros((n_bins, n_states))
    centers_nd = np.meshgrid(*grid.centers, indexing="ij")
    flat_centers = [c.reshape(-1) for c in centers_nd]
    for s in range(n_states):
        for b in range(n_bins):
            xi = tuple(fc[b] for fc in flat_centers)
            if coupling is not None:
                v = float(coupling(xi if grid.ndim > 1 else xi[0], s))
            else:
                if biases is None or betas is None:
                    raise ValueError("provide coupling, or biases + betas")
                bias = biases[s]
                e = 0.0 if bias is None else float(
                    bias(xi if grid.ndim > 1 else xi[0]))
                v = float(betas[s]) * e
            if not np.isfinite(v):
                raise ValueError(
                    f"PMF coupling non-finite for bin {b}, state {s}")
            mat[b, s] = -v
    return mat


def pmf_log_bin_weights(log_coupling_matrix, log_state_weights,
                        log_weight_factor=0.0):
    """dest[bin] = lwf - logsumexp_s(log_w[s] + log_coupling[bin, s])
    (pmf_log_bin_weights!, :465-495) — the inverse effective bias."""
    lw = np.asarray(log_state_weights, dtype=np.float64)
    m = np.asarray(log_coupling_matrix, dtype=np.float64) + lw[None, :]
    mx = m.max(axis=1)
    safe = np.isfinite(mx)
    log_den = np.full(m.shape[0], -np.inf)
    log_den[safe] = mx[safe] + np.log(
        np.exp(m[safe] - mx[safe, None]).sum(axis=1))
    out = np.where(np.isfinite(log_den), log_weight_factor - log_den, -np.inf)
    return out


@dataclasses.dataclass
class SampledPMFDeconvolutionAccumulator:
    """Log-space weighted histogram over the PMF grid
    (pmf_deconvolution.jl:246-330)."""

    grid: PMFGrid
    log_num: np.ndarray = None
    log_num_sq: np.ndarray = None
    max_log_w: np.ndarray = None
    counts: np.ndarray = None
    total_samples: int = 0
    accepted_samples: int = 0
    out_of_grid_samples: int = 0

    def __post_init__(self):
        shape = self.grid.shape
        if self.log_num is None:
            self.log_num = np.full(shape, -np.inf)
        if self.log_num_sq is None:
            self.log_num_sq = np.full(shape, -np.inf)
        if self.max_log_w is None:
            self.max_log_w = np.full(shape, -np.inf)
        if self.counts is None:
            self.counts = np.zeros(shape, dtype=np.int64)

    def accumulate(self, value, log_bin_weights, log_reweight=0.0):
        if not np.isfinite(log_reweight) or np.isnan(log_reweight):
            raise ValueError("non-finite reweighting factor")
        self.total_samples += 1
        idx = self.grid.bin_index(value)
        if idx is None:
            self.out_of_grid_samples += 1
            return self
        flat = np.ravel_multi_index(idx, self.grid.shape)
        ln = float(np.asarray(log_bin_weights).reshape(-1)[flat]) + log_reweight
        if not np.isfinite(ln):
            raise ValueError(
                f"zero support for the observed bin {idx}")
        self.log_num[idx] = np.logaddexp(self.log_num[idx], ln)
        self.log_num_sq[idx] = np.logaddexp(self.log_num_sq[idx], 2.0 * ln)
        self.max_log_w[idx] = max(self.max_log_w[idx], ln)
        self.counts[idx] += 1
        self.accepted_samples += 1
        return self

    def merge(self, other):
        if self.grid.shape != other.grid.shape:
            raise ValueError("accumulator shapes do not match")
        self.log_num = np.logaddexp(self.log_num, other.log_num)
        self.log_num_sq = np.logaddexp(self.log_num_sq, other.log_num_sq)
        self.max_log_w = np.maximum(self.max_log_w, other.max_log_w)
        self.counts += other.counts
        self.total_samples += other.total_samples
        self.accepted_samples += other.accepted_samples
        self.out_of_grid_samples += other.out_of_grid_samples
        return self

    def effective_samples(self):
        ok = np.isfinite(self.log_num) & np.isfinite(self.log_num_sq)
        out = np.zeros(self.grid.shape)
        out[ok] = np.exp(2.0 * self.log_num[ok] - self.log_num_sq[ok])
        return out

    def max_weight_fraction(self):
        ok = np.isfinite(self.log_num) & np.isfinite(self.max_log_w)
        out = np.zeros(self.grid.shape)
        out[ok] = np.exp(self.max_log_w[ok] - self.log_num[ok])
        return out

    def probability(self):
        finite = self.log_num[np.isfinite(self.log_num)]
        if finite.size == 0:
            raise ValueError("no in-grid weighted samples yet")
        mx = finite.max()
        log_total = mx + np.log(np.exp(finite - mx).sum())
        p = np.zeros(self.grid.shape)
        ok = np.isfinite(self.log_num)
        p[ok] = np.exp(self.log_num[ok] - log_total)
        return p


@dataclasses.dataclass
class PMFBinQuality:
    counts: np.ndarray
    ess: np.ndarray
    maxfrac: np.ndarray
    reliable: np.ndarray


def pmf_bin_quality(acc, min_count=20, min_ess=5.0, max_weight_fraction=0.5):
    """Per-bin reliability (pmf_deconvolution.jl:392-420)."""
    if min_count < 0:
        raise ValueError("min_count must be non-negative")
    if not (np.isfinite(min_ess) and min_ess >= 0):
        raise ValueError("min_ess must be finite and non-negative")
    if not (0.0 <= max_weight_fraction <= 1.0):
        raise ValueError("max_weight_fraction must be in [0, 1]")
    ess = acc.effective_samples()
    maxfrac = acc.max_weight_fraction()
    reliable = ((acc.counts >= min_count) & np.isfinite(acc.log_num)
                & (ess >= min_ess) & (maxfrac <= max_weight_fraction))
    return PMFBinQuality(counts=acc.counts.copy(), ess=ess, maxfrac=maxfrac,
                         reliable=reliable)


def pmf_result_from_sampled_deconvolution(acc, zero="min", kBT=None,
                                          quality=None,
                                          gauge_reliable_only=False,
                                          mask_unreliable=False):
    probability = acc.probability()
    if quality is None and (gauge_reliable_only or mask_unreliable):
        quality = pmf_bin_quality(acc)
    reliable = quality.reliable if quality is not None else None
    return pmf_result_from_probability(
        acc.grid, probability, zero=zero, kBT=kBT,
        reference_mask=reliable if gauge_reliable_only else None,
        report_mask=reliable if mask_unreliable else None)
