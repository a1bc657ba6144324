"""Online reweighting accumulators and PMF grids (counterpart of
mollytpu/free_energy/reweighting.py, copied: host NumPy, no torch).

Streaming accumulation of biased samples into an unbiased PMF estimate,
and deconvolution of an umbrella or AWH bias from a sampled histogram.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..units import KB


@dataclasses.dataclass
class PMFGrid:
    """Uniform CV grid with log-weight accumulation."""

    lo: float
    hi: float
    n_bins: int
    log_w: np.ndarray = None
    counts: np.ndarray = None

    def __post_init__(self):
        if self.log_w is None:
            self.log_w = np.full(self.n_bins, -np.inf)
        if self.counts is None:
            self.counts = np.zeros(self.n_bins)

    @property
    def centers(self):
        edges = np.linspace(self.lo, self.hi, self.n_bins + 1)
        return 0.5 * (edges[:-1] + edges[1:])

    def bin_of(self, cv):
        x = (np.asarray(cv) - self.lo) / (self.hi - self.lo) * self.n_bins
        return np.clip(np.floor(x).astype(int), 0, self.n_bins - 1)


@dataclasses.dataclass
class OnlinePMFAccumulator:
    """Streaming PMF from biased sampling: each observed CV sample enters
    with weight exp(+beta * bias(cv)) to undo the applied bias
    (reweighting.jl:88)."""

    grid: PMFGrid
    temperature: float
    bias: object = None  # callable cv -> bias energy (kJ/mol), or None

    def add(self, cv_value, extra_log_weight=0.0):
        b = self.grid.bin_of(cv_value)
        beta = 1.0 / (KB * self.temperature)
        logw = extra_log_weight
        if self.bias is not None:
            logw = logw + beta * float(self.bias(cv_value))
        self.grid.log_w[b] = np.logaddexp(self.grid.log_w[b], logw)
        self.grid.counts[b] += 1

    def pmf(self):
        kt = KB * self.temperature
        vals = -kt * self.grid.log_w
        vals = vals - np.nanmin(vals[np.isfinite(vals)])
        return self.grid.centers, vals


def pmf_deconvolution(centers, biased_pmf, bias_fn, temperature):
    """Remove a known bias from a PMF: F(cv) = F_biased(cv) - bias(cv)
    (pmf_deconvolution.jl pmf)."""
    vals = np.asarray(biased_pmf) - np.asarray([bias_fn(c) for c in centers])
    return vals - vals.min()
