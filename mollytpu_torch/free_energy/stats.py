"""Statistical inefficiency and decorrelated subsampling of a time series
(counterpart of mollytpu/free_energy/stats.py:15-43), in float64 on the
host."""

from __future__ import annotations

import numpy as np
import torch


def _host64(series):
    if isinstance(series, torch.Tensor):
        series = series.detach().cpu()
    return np.asarray(series, dtype=np.float64)


def statistical_inefficiency(series, mintime=1):
    """g = 1 + 2 sum_t (1 - t/T) C(t), truncated at the first non-positive
    autocorrelation after ``mintime``."""
    x = _host64(series)
    t_len = x.shape[0]
    x = x - x.mean()
    var = np.mean(x * x)
    if var == 0 or t_len < 3:
        return 1.0
    g = 1.0
    for t in range(1, t_len - 1):
        c = np.mean(x[: t_len - t] * x[t:]) / var
        if c <= 0.0 and t > mintime:
            break
        g += 2.0 * c * (1.0 - t / t_len)
    return max(g, 1.0)


def subsample_indices(series, g=None):
    """Indices of approximately uncorrelated samples."""
    x = _host64(series)
    if g is None:
        g = statistical_inefficiency(x)
    return np.arange(0, x.shape[0], max(int(np.ceil(g)), 1))


def effective_sample_size(series):
    return len(_host64(series)) / statistical_inefficiency(series)
