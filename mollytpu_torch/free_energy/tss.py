"""TSS: windowed expanded-ensemble sampling with stitched global estimates
(counterpart of mollytpu/free_energy/tss.py).

The whole subsystem: per-window local estimators with visit control,
geometric epoch history forgetting, window graphs with two-window rung
coverage (tss_graph.py), the global visit-control coupling (window
occupancy eigenvector, window-offset fixed point, stitched global free
energies), the CovDet adaptive target density, the windowed simulation
driver with replicas, sampled PMF deconvolution and delete-one-epoch
jackknife uncertainties.

The estimator and coupling code is the JAX package's host NumPy, copied as
it is: O(K) to O(W^2) arithmetic on vectors of at most dozens of entries.
The device work is the MD segments (run_chunk) and the per-cycle sweep of
a window's reduced potentials (ExtendedStateSpace.reduced_potentials),
read to the host once per sample.

All indices are 0-based.
"""

from __future__ import annotations

import dataclasses
import math
from bisect import bisect_left
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.neighbors import find_neighbors
from ..sim.simulate import run_chunk
from ..units import KB
from .extended_ensemble import ExtendedStateSpace
from .pmf import (PMFGrid, SampledPMFDeconvolutionAccumulator,
                  build_log_coupling_matrix, pmf_log_bin_weights,
                  pmf_result_from_sampled_deconvolution)
from .tss_graph import (TSSGraph, TSSWindow, single_window_tss_graph,
                        tss_swap_window, validate_window_coverage)

__all__ = [
    "TSSHistoryForgetting", "TSSLocalEstimator", "TSSState", "TSSSimulation",
    "TSSJackknifeResult", "TSSPMFDeconvolution", "tss_free_energies",
    "tss_free_energy_uncertainties",
]


def _logaddexp(a, b):
    if a == -np.inf:
        return b
    if b == -np.inf:
        return a
    m = max(a, b)
    return m + math.log(math.exp(a - m) + math.exp(b - m))


def _logsumexp(v):
    v = np.asarray(v, dtype=np.float64)
    m = v.max() if v.size else -np.inf
    if not np.isfinite(m):
        return m
    return m + math.log(np.exp(v - m).sum())


def _log_update_arg(log_ratio, gain):
    """log((1-gain) + gain * exp(log_ratio)) (common.jl tss_log_update_arg)."""
    if gain == 1.0:
        return log_ratio
    return _logaddexp(math.log1p(-gain), math.log(gain) + log_ratio)


_TILT_FLOOR = math.sqrt(np.finfo(np.float64).tiny)
TSS_COVDET_GAMMA_EPSILON = 0.01


def _check_finite(values, name):
    if not np.all(np.isfinite(values)):
        raise ValueError(f"TSS {name} contains non-finite values")
    return values


def _check_probabilities(w, name):
    _check_finite(w, name)
    if np.any(np.asarray(w) < 0):
        raise ValueError(f"TSS {name} contains negative values")
    s = float(np.sum(w))
    if not np.isfinite(s) or s <= 0:
        raise ValueError(f"TSS {name} has invalid total weight {s}")
    return w


def conditional_state_weights(log_state_bias, reduced_pot):
    """w_k proportional to exp(f_k + log_dens_k - u_k), normalized."""
    s = np.asarray(log_state_bias, dtype=np.float64) - np.asarray(
        reduced_pot, dtype=np.float64)
    return np.exp(s - _logsumexp(s))


def sample_state(rng, weights):
    w = np.asarray(weights, dtype=np.float64)
    return int(rng.choice(len(w), p=w / w.sum()))


# -- history forgetting ------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TSSHistoryForgetting:
    """Geometric epoch history forgetting (history.jl:1-35): retain epochs
    covering the most recent (1-alpha) fraction of history time, with epoch
    boundaries growing by factor phi so ~n_epochs are live at once."""

    alpha: float = 0.19
    n_epochs: int = 16
    phi: float = None

    def __post_init__(self):
        if not (np.isfinite(self.alpha) and 0 <= self.alpha < 1):
            raise ValueError("alpha must be finite and in [0, 1)")
        if self.n_epochs <= 0:
            raise ValueError("n_epochs must be positive")
        if self.phi is None:
            phi = 1.2 if self.alpha == 0 else self.alpha ** (
                -1.0 / self.n_epochs)
            object.__setattr__(self, "phi", phi)
        if not (np.isfinite(self.phi) and self.phi > 1):
            raise ValueError("phi must be finite and greater than 1")


@dataclasses.dataclass
class TSSEpoch:
    index: int
    count: int
    f: np.ndarray
    tilts: np.ndarray
    adaptive_moments: Optional[np.ndarray] = None

    @classmethod
    def create(cls, index, n_states, n_adaptive_moments=0):
        return cls(index=int(index), count=0,
                   f=np.zeros(n_states), tilts=np.zeros(n_states),
                   adaptive_moments=(None if n_adaptive_moments == 0 else
                                     np.zeros((n_states,
                                               n_adaptive_moments))))


@dataclasses.dataclass
class TSSEpochHistory:
    """Epoch boundaries `taus` with per-epoch running estimates; epoch e
    covers history times (taus[e-1], taus[e]] (history.jl:59-110)."""

    config: TSSHistoryForgetting
    taus: List[int]
    epochs: List[TSSEpoch]

    @classmethod
    def create(cls, config, n_states):
        if n_states <= 0:
            raise ValueError("history n_states must be positive")
        return cls(config=config, taus=[0, 1], epochs=[])

    def ensure_bounds(self, t):
        while t > self.taus[-1]:
            prev = self.taus[-1]
            self.taus.append(max(prev + 1,
                                 int(math.ceil(self.config.phi * prev))))
        return self.taus

    def epoch_index(self, t):
        if t <= 0:
            return 1
        t = int(math.ceil(t))
        self.ensure_bounds(t)
        # first epoch e with taus[e] >= t  (epoch e covers (taus[e-1], taus[e]])
        return max(1, bisect_left(self.taus, t))

    def epoch_for_update(self, t, n_states, n_adaptive_moments=0):
        idx = self.epoch_index(t)
        for e in self.epochs:
            if e.index == idx:
                return e
        self.epochs.append(TSSEpoch.create(idx, n_states,
                                           n_adaptive_moments))
        return self.epochs[-1]

    def first_retained_epoch_index(self, t):
        return self.epoch_index(int(math.ceil(self.config.alpha * t)))

    def drop_old_epochs(self, t):
        first = self.first_retained_epoch_index(t)
        self.epochs = [e for e in self.epochs if e.index >= first]
        return self

    def retained_epoch_indices(self, t):
        if t <= 0:
            raise ValueError("TSS jackknife requires a positive history time")
        self.ensure_bounds(t)
        first = max(1, self.first_retained_epoch_index(t))
        current = self.epoch_index(t)
        if current < first:
            raise ValueError("TSS jackknife could not identify retained "
                             f"epochs at time {t}")
        return list(range(first, current + 1))

    def epoch_weights(self, epoch_indices, t):
        if not epoch_indices:
            return np.zeros(0)
        self.ensure_bounds(t)
        first = epoch_indices[0]
        if first < 1:
            raise ValueError("TSS epoch indices must be at least 1")
        denom = float(t - self.taus[first - 1])
        if denom <= 0:
            raise ValueError(
                "TSS jackknife retained-history duration must be positive")
        weights = []
        for e in epoch_indices:
            if e >= len(self.taus):
                raise ValueError(f"TSS epoch index {e} has no stored "
                                 "boundary")
            dur = min(self.taus[e], t) - self.taus[e - 1]
            if dur <= 0:
                raise ValueError(f"TSS epoch {e} has non-positive duration")
            weights.append(dur / denom)
        return np.asarray(weights)

    def sample_count(self, omit_epoch_index=None, epoch_indices=None):
        retained = None if epoch_indices is None else set(epoch_indices)
        total = 0
        for e in self.epochs:
            if e.count <= 0:
                continue
            if retained is not None and e.index not in retained:
                continue
            if omit_epoch_index is not None and e.index == omit_epoch_index:
                continue
            total += e.count
        return total


# -- CovDet adaptive gamma ---------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TSSCovDetAdaptiveGamma:
    """Target density proportional to sqrt(det cov(dU/dlambda)) x rung volume
    (observables.jl TSSCovDetAdaptiveGamma :3)."""

    epsilon_gamma: float
    rung_neighbors: Tuple
    rung_volumes: np.ndarray
    dimension: int


def _covdet_moment_count(dim):
    return dim + dim * dim


def _covdet_outer_col(dim, i, j):
    return dim + j * dim + i


# -- local estimator ---------------------------------------------------------

class TSSLocalEstimator:
    """Per-window TSS estimator (single_window.jl TSSLocalEstimator).

    Owns the window's running free energies f, target density gamma, visit
    tilts, and sampling density; consumes one reduced-potential vector per
    cycle and applies the log-space stochastic-approximation update.
    """

    def __init__(self, n_global_states, state_indices=None,
                 evaluation_state_indices=None, gamma=None, initial_f=None,
                 ETA=2.0, dens_reg=1e-6, history_forgetting=None,
                 adaptive_gamma=None):
        K = int(n_global_states)
        if K < 1:
            raise ValueError("number of states must be >= 1")
        if state_indices is None:
            state_indices = list(range(K))
        else:
            state_indices = [int(s) for s in state_indices]
            if not state_indices or len(state_indices) > K:
                raise ValueError(f"state_indices must be non-empty and at "
                                 f"most {K} long")
            if any(not 0 <= s < K for s in state_indices):
                raise ValueError(f"state_indices entries must be in 0..{K-1}")
            if len(set(state_indices)) != len(state_indices):
                raise ValueError("state_indices entries must be unique")
        self.n_global_states = K
        self.state_indices = list(state_indices)
        self.local_index_by_state = np.full(K, -1, dtype=np.int64)
        for li, gi in enumerate(state_indices):
            self.local_index_by_state[gi] = li

        if evaluation_state_indices is None:
            ev = list(state_indices)
        else:
            ev = list(dict.fromkeys(
                state_indices + [int(s) for s in evaluation_state_indices]))
            if any(not 0 <= s < K for s in ev):
                raise ValueError("evaluation_state_indices entries must be "
                                 f"in 0..{K-1}")
        self.evaluation_state_indices = ev
        self.evaluation_local_index_by_state = np.full(K, -1, dtype=np.int64)
        for ei, gi in enumerate(ev):
            self.evaluation_local_index_by_state[gi] = ei

        if ETA < 0:
            raise ValueError("ETA must be >= 0")
        if not 0 < dens_reg < 1:
            raise ValueError("dens_reg must be in (0, 1)")
        local_K = len(state_indices)

        if gamma is None:
            gamma = np.full(local_K, 1.0 / local_K)
        else:
            gamma = np.asarray(gamma, dtype=np.float64)
            if gamma.shape != (local_K,):
                raise ValueError(f"gamma must have length {local_K}")
            if not np.all(np.isfinite(gamma)) or np.any(gamma <= 0):
                raise ValueError("gamma values must be finite and positive")
            gamma = gamma / gamma.sum()

        if initial_f is None:
            initial_f = np.zeros(local_K)
        else:
            initial_f = np.asarray(initial_f, dtype=np.float64).copy()
            if initial_f.shape != (local_K,):
                raise ValueError(f"initial_f must have length {local_K}")
            _check_finite(initial_f, "initial_f")
            initial_f -= initial_f[0]

        self.f = initial_f
        self.gamma = gamma
        self.log_gamma = np.log(gamma)
        self.tilts = np.ones(local_K)
        self.density = gamma.copy()
        self.log_dens = np.log(self.density)
        self.weights = np.zeros(local_K)
        self.reduced_pot = np.zeros(local_K)
        self.evaluation_reduced_pot = np.zeros(len(ev))
        self.iteration = 0
        self.ETA = float(ETA)
        self.dens_reg = float(dens_reg)
        self.history = (None if history_forgetting is None else
                        TSSEpochHistory.create(history_forgetting, local_K))
        self.adaptive_gamma = adaptive_gamma
        self.adaptive_moments = None
        self.stats = {"iterations": [], "active_state": [],
                      "sampled_next_state": [], "max_abs_delta_f": [],
                      "f_history": [], "dens_history": [], "tilt_history": []}

    # -- index maps ----------------------------------------------------------

    @property
    def n_local(self):
        return len(self.state_indices)

    def local_index(self, global_state):
        if not 0 <= global_state < self.n_global_states:
            raise ValueError(f"global_state {global_state} out of bounds")
        li = int(self.local_index_by_state[global_state])
        if li < 0:
            raise ValueError(f"{global_state} does not map to any local "
                             "state")
        return li

    def global_index(self, local_state):
        return self.state_indices[local_state]

    # -- per-cycle sample processing ----------------------------------------

    def set_evaluation_reduced_potentials(self, u_eval):
        """Record u_k(x) for the evaluation states; project onto the window's
        own states (single_window.jl process_tss_sample! :231-276)."""
        u_eval = np.asarray(u_eval, dtype=np.float64)
        if u_eval.shape != (len(self.evaluation_state_indices),):
            raise ValueError("evaluation reduced potentials have wrong shape")
        _check_finite(u_eval, "evaluation reduced potentials")
        self.evaluation_reduced_pot = u_eval.copy()
        for li, gi in enumerate(self.state_indices):
            ei = int(self.evaluation_local_index_by_state[gi])
            self.reduced_pot[li] = u_eval[ei]

    def process_sample(self, u_eval=None):
        """Conditional state weights for Gibbs window sampling."""
        if u_eval is not None:
            self.set_evaluation_reduced_potentials(u_eval)
        log_state_bias = self.f + self.log_dens
        _check_finite(log_state_bias, "log state bias")
        self.weights = conditional_state_weights(log_state_bias,
                                                 self.reduced_pot)
        _check_probabilities(self.weights, "conditional weights")
        return self.weights

    def log_den(self):
        s = self.f + self.log_dens - self.reduced_pot
        out = _logsumexp(s)
        if not np.isfinite(out):
            raise ValueError("TSS log normalization is non-finite at "
                             f"iteration {self.iteration}")
        return out

    # -- updates -------------------------------------------------------------

    def update_sampling_distribution(self):
        """density proportional to gamma * tilts^-ETA, floored and regularized
        towards gamma (single_window.jl :297-339)."""
        _check_finite(self.tilts, "visit tilts")
        if np.any(self.tilts < 0):
            raise ValueError("TSS visit tilts contain negative values")
        if self.ETA == 0:
            scratch = self.log_gamma.copy()
        else:
            scratch = self.log_gamma - self.ETA * np.log(
                np.maximum(self.tilts, _TILT_FLOOR))
        log_norm = _logsumexp(scratch)
        if not np.isfinite(log_norm):
            raise ValueError("TSS sampling density normalization non-finite")
        dens = np.exp(scratch - log_norm)
        dens = (1.0 - self.dens_reg) * dens + self.dens_reg * self.gamma
        s = dens.sum()
        if not np.isfinite(s) or s <= 0:
            raise ValueError(f"TSS sampling density has invalid total {s}")
        self.density = dens / s
        self.log_dens = np.log(self.density)

    def covdet_moment_values(self, evaluation_reduced_pot=None):
        """(n_local, dim + dim^2) matrix of dU/dlambda central-difference
        derivative moments (observables.jl tss_covdet_moment_values :148)."""
        ag = self.adaptive_gamma
        if not isinstance(ag, TSSCovDetAdaptiveGamma):
            return None
        u_eval = (self.evaluation_reduced_pot
                  if evaluation_reduced_pot is None
                  else np.asarray(evaluation_reduced_pot, dtype=np.float64))
        dim = ag.dimension
        values = np.zeros((self.n_local, _covdet_moment_count(dim)))
        for li, gi in enumerate(self.state_indices):
            neighbors = ag.rung_neighbors[gi]
            if len(neighbors) != dim:
                raise ValueError(f"TSS CovDet rung {gi} has "
                                 f"{len(neighbors)} derivative dimensions, "
                                 f"expected {dim}")
            deriv = np.zeros(dim)
            for d, (rev, fwd, denom) in enumerate(neighbors):
                if denom == 0:
                    continue
                re = int(self.evaluation_local_index_by_state[rev])
                fe = int(self.evaluation_local_index_by_state[fwd])
                if re < 0 or fe < 0:
                    raise ValueError(
                        f"TSS CovDet derivative for rung {gi} requires "
                        f"states {rev} and {fwd} in the evaluation set")
                deriv[d] = (u_eval[fe] - u_eval[re]) / denom
                values[li, d] = deriv[d]
            for j in range(dim):
                for i in range(dim):
                    values[li, _covdet_outer_col(dim, i, j)] = (
                        deriv[i] * deriv[j])
        _check_finite(values, "CovDet adaptive-gamma moments")
        return values

    def _ensure_adaptive_moments(self, n_moments):
        if self.adaptive_moments is None:
            self.adaptive_moments = np.zeros((self.n_local, n_moments))
        elif self.adaptive_moments.shape != (self.n_local, n_moments):
            raise ValueError("TSS adaptive-gamma moment dimension changed")
        return self.adaptive_moments

    @staticmethod
    def _update_moment_matrix(moments, old_f, reduced_pot, log_den, gain,
                              adaptive_values):
        """Z-weighted running mean of the derivative moments
        (observables.jl update_tss_adaptive_moments! :45)."""
        log_gain = math.log(gain)
        log_keep = -np.inf if gain == 1.0 else math.log1p(-gain)
        for k in range(moments.shape[0]):
            log_old_z = -old_f[k]
            log_sample_z = -reduced_pot[k] - log_den
            log_new_z = _logaddexp(log_keep + log_old_z,
                                   log_gain + log_sample_z)
            ow = math.exp(log_keep + log_old_z - log_new_z)
            sw = math.exp(log_gain + log_sample_z - log_new_z)
            moments[k] = ow * moments[k] + sw * adaptive_values[k]
        _check_finite(moments, "adaptive-gamma moments")
        return moments

    def update_history(self, visited_local, log_den, history_time,
                       adaptive_values=None, aggregate=True):
        """Per-epoch running estimates + optional re-aggregation into f/tilts
        (history.jl update_tss_history! :300-357)."""
        if history_time <= 0:
            raise ValueError("history_time must be positive")
        n_mom = 0 if adaptive_values is None else adaptive_values.shape[1]
        epoch = self.history.epoch_for_update(history_time, self.n_local,
                                              n_mom)
        epoch.count += 1
        gain = 1.0 / epoch.count
        old_epoch_f = epoch.f.copy() if adaptive_values is not None else None
        if adaptive_values is not None:
            if epoch.adaptive_moments is None:
                epoch.adaptive_moments = np.zeros((self.n_local, n_mom))
            self._update_moment_matrix(epoch.adaptive_moments, old_epoch_f,
                                       self.reduced_pot, log_den, gain,
                                       adaptive_values)
        for k in range(self.n_local):
            log_ratio = epoch.f[k] - self.reduced_pot[k] - log_den
            epoch.f[k] -= _log_update_arg(log_ratio, gain)
        _check_finite(epoch.f, "epoch free energies")
        for k in range(self.n_local):
            target = (1.0 if k == visited_local else 0.0) / self.gamma[k]
            epoch.tilts[k] += gain * (target - epoch.tilts[k])
        self.history.drop_old_epochs(history_time)
        if aggregate:
            self.aggregate_history()
        return self

    def recent_count(self):
        if self.history is None:
            return self.iteration
        return sum(e.count for e in self.history.epochs)

    def aggregate_history(self):
        """f/tilts from the count-weighted combination of retained epochs
        (history.jl aggregate_tss_history! :286)."""
        total = self.recent_count()
        if total <= 0:
            return self
        for k in range(self.n_local):
            log_z = -np.inf
            tilt_sum = 0.0
            for e in self.history.epochs:
                if e.count <= 0:
                    continue
                log_z = _logaddexp(log_z, math.log(e.count) - e.f[k])
                tilt_sum += e.count * e.tilts[k]
            self.f[k] = -(log_z - math.log(total))
            self.tilts[k] = tilt_sum / total
        self.f -= self.f[0]
        _check_finite(self.f, "history-aggregated free energies")
        _check_finite(self.tilts, "history-aggregated visit tilts")
        self._aggregate_history_adaptive_moments()
        return self

    def _aggregate_history_adaptive_moments(self):
        if self.adaptive_gamma is None or self.history is None:
            return self
        n_mom = 0
        for e in self.history.epochs:
            if e.count > 0 and e.adaptive_moments is not None:
                n_mom = e.adaptive_moments.shape[1]
                break
        if n_mom == 0:
            return self
        moments = self._ensure_adaptive_moments(n_mom)
        for k in range(self.n_local):
            log_weights, epochs = [], []
            log_norm = -np.inf
            for e in self.history.epochs:
                if e.count <= 0 or e.adaptive_moments is None:
                    continue
                lw = math.log(e.count) - e.f[k]
                log_weights.append(lw)
                epochs.append(e)
                log_norm = _logaddexp(log_norm, lw)
            if not epochs:
                continue
            for m in range(n_mom):
                moments[k, m] = sum(
                    math.exp(lw - log_norm) * e.adaptive_moments[k, m]
                    for lw, e in zip(log_weights, epochs))
        _check_finite(moments, "history-aggregated adaptive moments")
        return self

    def aggregate_history_free_energies(self, omit_epoch_index=None,
                                        epoch_indices=None):
        """Free energies from a subset of epochs (jackknife replicates,
        history.jl aggregate_tss_history_free_energies :255)."""
        if self.history is None:
            raise ValueError("TSS jackknife requires history forgetting")
        total = self.history.sample_count(omit_epoch_index=omit_epoch_index,
                                          epoch_indices=epoch_indices)
        if total <= 0:
            raise ValueError("TSS history aggregation has no samples in the "
                             "requested retained epochs")
        retained = None if epoch_indices is None else set(epoch_indices)
        f = np.zeros(self.n_local)
        for k in range(self.n_local):
            log_z = -np.inf
            for e in self.history.epochs:
                if e.count <= 0:
                    continue
                if retained is not None and e.index not in retained:
                    continue
                if omit_epoch_index is not None and \
                        e.index == omit_epoch_index:
                    continue
                log_z = _logaddexp(log_z, math.log(e.count) - e.f[k])
            f[k] = -(log_z - math.log(total))
        f -= f[0]
        _check_finite(f, "history-aggregated jackknife free energies")
        return f

    def update_adaptive_gamma(self):
        if self.adaptive_gamma is None:
            return self
        raw = self.covdet_raw_values()
        max_detcov = 0.0 if raw is None else float(np.max(raw))
        return self.apply_covdet_gamma(raw, max_detcov)

    def covdet_raw_values(self):
        """sqrt(det cov) per rung from the running moments
        (observables.jl tss_covdet_raw_values :197)."""
        ag = self.adaptive_gamma
        if not isinstance(ag, TSSCovDetAdaptiveGamma):
            return None
        if self.adaptive_moments is None:
            return None
        dim = ag.dimension
        if self.adaptive_moments.shape[1] != _covdet_moment_count(dim):
            raise ValueError("TSS CovDet adaptive moments have invalid "
                             "dimension")
        raw = np.zeros(self.n_local)
        for li in range(self.n_local):
            cov = np.zeros((dim, dim))
            for j in range(dim):
                for i in range(dim):
                    mo = self.adaptive_moments[li,
                                               _covdet_outer_col(dim, i, j)]
                    cov[i, j] = (mo - self.adaptive_moments[li, i]
                                 * self.adaptive_moments[li, j])
            cov = 0.5 * (cov + cov.T)
            det = cov[0, 0] if dim == 1 else float(np.linalg.det(cov))
            raw[li] = math.sqrt(max(det, 0.0))
        _check_finite(raw, "CovDet adaptive-gamma estimates")
        return raw

    def _volume_weighted_gamma(self):
        ag = self.adaptive_gamma
        w = np.asarray([ag.rung_volumes[li] for li in
                        range(self.n_local)], dtype=np.float64)
        total = w.sum()
        if not np.isfinite(total) or total <= 0:
            raise ValueError("TSS CovDet rung volumes have invalid total")
        self.gamma = w / total
        self.log_gamma = np.log(self.gamma)
        return self

    def apply_covdet_gamma(self, raw_values, max_detcov):
        ag = self.adaptive_gamma
        if not isinstance(ag, TSSCovDetAdaptiveGamma):
            return self
        raw = (np.zeros(self.n_local) if raw_values is None
               else np.asarray(raw_values, dtype=np.float64))
        if raw.shape != (self.n_local,):
            raise ValueError("TSS CovDet adaptive gamma has invalid length")
        _check_finite(raw, "CovDet raw values")
        if not np.isfinite(max_detcov) or max_detcov <= 0:
            return self._volume_weighted_gamma()
        eps = ag.epsilon_gamma
        vols = np.asarray([ag.rung_volumes[li]
                           for li in range(self.n_local)])
        g = ((1.0 - eps) * np.maximum(raw, 0.0) + eps * max_detcov) * vols
        total = g.sum()
        if not np.isfinite(total) or total <= 0:
            raise ValueError("TSS CovDet adaptive gamma has invalid total")
        self.gamma = g / total
        self.log_gamma = np.log(self.gamma)
        return self

    def update_estimates(self, visited_state, history_time=None,
                         adaptive_values=None, update_adaptive_gamma=True):
        """One stochastic-approximation update after a visit to
        `visited_state` (single_window.jl update_tss_estimates! :341-430).
        Returns max |delta f|."""
        visited_local = self.local_index(visited_state)
        _check_probabilities(self.weights, "conditional weights")
        _check_finite(self.f, "free energy estimates")
        _check_finite(self.reduced_pot, "reduced potentials")
        log_den = self.log_den()
        t_next = self.iteration + 1
        history_time = t_next if history_time is None else int(history_time)
        if history_time <= 0:
            raise ValueError("history_time must be positive")
        old_f = self.f.copy()
        if adaptive_values is None:
            adaptive_values = self.covdet_moment_values()
        use_standard = (self.history is None
                        or self.history.config.alpha == 0.0)
        if use_standard:
            gain = 1.0 / t_next
            delta = np.array([
                -_log_update_arg(self.f[k] - self.reduced_pot[k] - log_den,
                                 gain)
                for k in range(self.n_local)])
            _check_finite(delta, "free energy update")
            self.f += delta
            self.f -= self.f[0]
            _check_finite(self.f, "free energy estimates")
            if adaptive_values is not None:
                moments = self._ensure_adaptive_moments(
                    adaptive_values.shape[1])
                self._update_moment_matrix(moments, old_f, self.reduced_pot,
                                           log_den, gain, adaptive_values)
            for k in range(self.n_local):
                target = (1.0 if k == visited_local else 0.0) / self.gamma[k]
                self.tilts[k] += gain * (target - self.tilts[k])
            _check_finite(self.tilts, "visit tilts")
            if self.history is not None:
                self.update_history(visited_local, log_den, history_time,
                                    adaptive_values=adaptive_values,
                                    aggregate=False)
        else:
            self.update_history(visited_local, log_den, history_time,
                                adaptive_values=adaptive_values)
        self.iteration += 1
        if update_adaptive_gamma:
            self.update_adaptive_gamma()
        self.update_sampling_distribution()
        return float(np.max(np.abs(self.f - old_f)))

    def log_stats(self, visited_state, next_state, max_delta_f):
        st = self.stats
        st["iterations"].append(self.iteration)
        st["active_state"].append(visited_state)
        st["sampled_next_state"].append(next_state)
        st["max_abs_delta_f"].append(max_delta_f)
        st["f_history"].append(self.f.copy())
        st["dens_history"].append(self.density.copy())
        st["tilt_history"].append(self.tilts.copy())


# -- global visit-control coupling ------------------------------------------

@dataclasses.dataclass
class WindowedTSSCoupling:
    """Global visit-control state (windows.jl WindowedTSSCoupling :167):
    stitched free energies, window occupancies, offsets, residuals."""

    visit_control_f: np.ndarray
    window_probs: np.ndarray
    window_transition: np.ndarray
    global_rung_weights: np.ndarray
    window_offsets: np.ndarray
    lhs_marginal: np.ndarray
    rhs_marginal: np.ndarray
    residual: np.ndarray
    candidate_densities: List[np.ndarray]
    reported_window_probs: np.ndarray
    reported_gamma: np.ndarray
    reported_offsets: np.ndarray
    reported_f: np.ndarray
    iterations: int
    converged: bool
    max_abs_residual: float
    tolerance: float
    max_iterations: int
    damping: float
    pi_regularization: float


class TSSState:
    """Mutable state of a (windowed) TSS run over an ExtendedStateSpace
    (windows.jl TSSState :200-266, constructor :779-903).

    space        : ExtendedStateSpace defining the K global rungs.
    graph        : TSSGraph (None -> single window over all rungs).
    ETA          : visit-control strength (0 disables).
    history_forgetting : TSSHistoryForgetting or None.
    adaptive_gamma : None | 'covdet'.
    """

    def __init__(self, space, graph=None, first_state=0, first_window=None,
                 gamma=None, initial_f=None, ETA=2.0, dens_reg=1e-6,
                 history_forgetting=None, adaptive_gamma=None,
                 global_visit_control=True, visit_control_tolerance=1e-8,
                 visit_control_max_iterations=1000,
                 visit_control_damping=1.0, pi_regularization=1e-3):
        if not isinstance(space, ExtendedStateSpace):
            raise ValueError("space must be an ExtendedStateSpace")
        K = space.n_states
        explicit_graph = graph is not None
        if graph is None:
            graph = single_window_tss_graph(K)
        if not isinstance(graph, TSSGraph):
            raise ValueError("graph must be a TSSGraph; construct one with "
                             "tss_grid_graph or build_tss_graph")
        if graph.n_states != K:
            raise ValueError(f"TSS graph has {graph.n_states} states but the "
                             f"state space has {K}")
        if not 0 <= first_state < K:
            raise ValueError(f"first_state {first_state} out of range")
        self.space = space
        self.graph = graph
        self.windows = graph.windows
        self.state_to_windows = graph.state_to_windows
        validate_window_coverage(self.windows, self.state_to_windows, K)

        first_windows = self.state_to_windows[first_state]
        if first_window is None:
            self.active_window = first_windows[0]
        else:
            first_window = int(first_window)
            if first_window not in first_windows:
                raise ValueError("first_window must contain first_state")
            self.active_window = first_window
        self.active_state_index = int(first_state)

        def _subset(vec, idxs, name):
            if vec is None:
                return None
            vec = np.asarray(vec, dtype=np.float64)
            if vec.shape != (K,):
                raise ValueError(f"{name} must have length {K}")
            return vec[list(idxs)]

        adaptive_mode = None
        if adaptive_gamma is not None:
            if adaptive_gamma != "covdet":
                raise ValueError("adaptive_gamma accepts only None or "
                                 "'covdet'")
            if not explicit_graph:
                raise ValueError("adaptive_gamma='covdet' requires an "
                                 "explicit TSS graph")
            adaptive_mode = "covdet"

        self.estimators = []
        for w in self.windows:
            ag = None
            if adaptive_mode == "covdet":
                first = w.state_indices[0]
                dim = len(graph.rung_neighbors[first])
                for s in w.state_indices:
                    if len(graph.rung_neighbors[s]) != dim:
                        raise ValueError(
                            "TSS CovDet adaptive gamma requires all rungs in "
                            "a window to have the same lambda dimension")
                vols = np.asarray([graph.rung_volumes[s]
                                   for s in w.state_indices])
                if not (np.all(np.isfinite(vols)) and np.all(vols >= 0)
                        and vols.sum() > 0):
                    raise ValueError("TSS CovDet requires finite positive "
                                     "rung volumes")
                ag = TSSCovDetAdaptiveGamma(
                    epsilon_gamma=TSS_COVDET_GAMMA_EPSILON,
                    rung_neighbors=graph.rung_neighbors,
                    rung_volumes=vols, dimension=dim)
            self.estimators.append(TSSLocalEstimator(
                K, state_indices=w.state_indices,
                evaluation_state_indices=w.evaluation_state_indices,
                gamma=_subset(gamma, w.state_indices, "gamma"),
                initial_f=_subset(initial_f, w.state_indices, "initial_f"),
                ETA=ETA, dens_reg=dens_reg,
                history_forgetting=history_forgetting,
                adaptive_gamma=ag))
        self.window_update_counts = [0] * len(self.windows)
        self.iteration = 0
        self.stats = {"iterations": [], "update_window": [],
                      "visited_state": [], "sampled_next_state": [],
                      "max_abs_delta_f": [], "active_window_history": [],
                      "reported_f_history": [],
                      "visit_control_converged": [],
                      "visit_control_iterations": [],
                      "visit_control_max_abs_residual": [],
                      "window_prob_history": [],
                      "visit_control_f_history": [],
                      "replica_indices": [], "replica_update_windows": [],
                      "replica_visited_states": [],
                      "replica_sampled_next_states": []}
        self.coupling = None
        self.update_adaptive_gamma()
        if global_visit_control:
            self.coupling = self._init_coupling(
                tolerance=visit_control_tolerance,
                max_iterations=visit_control_max_iterations,
                damping=visit_control_damping,
                pi_regularization=pi_regularization)
            self.update_coupling()

    # -- simple accessors ----------------------------------------------------

    @property
    def n_states(self):
        return self.space.n_states

    def active_estimator(self):
        return self.estimators[self.active_window]

    def windows_for_state(self, global_state):
        if not 0 <= global_state < self.n_states:
            raise ValueError(f"global_state {global_state} out of bounds")
        return self.state_to_windows[global_state]

    def other_window_for_state(self, global_state, active_window=None):
        if active_window is None:
            active_window = self.active_window
        wins = self.windows_for_state(global_state)
        if len(wins) == 1:
            if active_window != wins[0]:
                raise ValueError(f"active window {active_window} does not "
                                 f"contain state {global_state}")
            return wins[0]
        return tss_swap_window(self.graph, active_window, global_state)

    def switch_active_window(self, current_state=None):
        if current_state is None:
            current_state = self.active_state_index
        self.active_window = self.other_window_for_state(current_state)
        return self

    def visited_mask(self):
        use_recent = any(e.history is not None for e in self.estimators)
        if use_recent:
            mask = [e.recent_count() > 0 for e in self.estimators]
        else:
            mask = [c > 0 for c in self.window_update_counts]
        if not any(mask):
            mask = [True] * len(mask)
        return mask

    def local_free_energies(self):
        return [e.f.copy() for e in self.estimators]

    def local_average_free_energies(self, local_f_by_window=None):
        """Per-rung mean of the (gauge-ambiguous) local estimates — the
        fallback global estimate (global_estimators.jl :104-132)."""
        if local_f_by_window is None:
            local_f_by_window = self.local_free_energies()
        K = self.n_states
        values = np.zeros(K)
        counts = np.zeros(K, dtype=np.int64)
        for wi, est in enumerate(self.estimators):
            for gi in self.windows[wi].state_indices:
                li = est.local_index(gi)
                values[gi] += local_f_by_window[wi][li]
                counts[gi] += 1
        if np.any(counts <= 0):
            raise ValueError("some states have no local TSS free-energy "
                             "estimates")
        values /= counts
        values -= values[0]
        return values

    # -- coupling ------------------------------------------------------------

    def _coupling(self):
        if self.coupling is None:
            raise ValueError("global TSS visit control is not enabled")
        return self.coupling

    def _init_coupling(self, tolerance, max_iterations, damping,
                       pi_regularization):
        if not (np.isfinite(tolerance) and tolerance > 0):
            raise ValueError("visit_control_tolerance must be positive")
        if max_iterations <= 0:
            raise ValueError("visit_control_max_iterations must be positive")
        if not (np.isfinite(damping) and 0 < damping <= 1):
            raise ValueError("visit_control_damping must be in (0, 1]")
        if not (np.isfinite(pi_regularization)
                and 0 < pi_regularization < 1):
            raise ValueError("pi_regularization must be in (0, 1)")
        K, W = self.n_states, len(self.windows)
        vcf = self.local_average_free_energies()
        vcf -= vcf[0]
        return WindowedTSSCoupling(
            visit_control_f=vcf,
            window_probs=np.full(W, 1.0 / W),
            window_transition=np.zeros((W, W)),
            global_rung_weights=np.zeros(K),
            window_offsets=np.zeros(W),
            lhs_marginal=np.zeros(K),
            rhs_marginal=np.zeros(K),
            residual=np.zeros(K),
            candidate_densities=[e.density.copy() for e in self.estimators],
            reported_window_probs=np.full(W, 1.0 / W),
            reported_gamma=np.zeros(K),
            reported_offsets=np.zeros(W),
            reported_f=vcf.copy(),
            iterations=0, converged=False, max_abs_residual=np.inf,
            tolerance=float(tolerance), max_iterations=int(max_iterations),
            damping=float(damping),
            pi_regularization=float(pi_regularization))

    def _local_weight(self, est, li, use_tilts):
        w = est.gamma[li]
        if use_tilts:
            w *= max(est.tilts[li], _TILT_FLOOR)
        return w

    def window_transition_matrix(self, use_tilts=True, visited_mask=None):
        """Column-stochastic window-swap chain Q (global_estimators.jl
        compute_window_transition_matrix! :190-234)."""
        if visited_mask is None:
            visited_mask = self.visited_mask()
        W = len(self.windows)
        Q = np.zeros((W, W))
        if not any(visited_mask):
            raise ValueError("at least one TSS window must be active")
        for wj, est in enumerate(self.estimators):
            if not visited_mask[wj]:
                continue
            denom = sum(self._local_weight(est, li, use_tilts)
                        for li in range(est.n_local))
            if not (np.isfinite(denom) and denom > 0):
                raise ValueError(f"TSS window {wj} has invalid transition "
                                 f"denominator {denom}")
            for li in range(est.n_local):
                gi = est.state_indices[li]
                contrib = 0.5 * self._local_weight(est, li, use_tilts) / denom
                for wi in self.state_to_windows[gi]:
                    if visited_mask[wi]:
                        Q[wi, wj] += contrib
                    else:
                        Q[wj, wj] += contrib
            col = Q[:, wj].sum()
            if not np.isfinite(col) or col <= 0:
                Q[wj, wj] = 1.0
            else:
                Q[:, wj] /= col
        return Q

    def solve_window_probabilities(self, use_tilts=True, visited_mask=None):
        """Stationary distribution of the window-swap chain via the
        pseudo-inverse of (Q - I) with the normalization row
        (global_estimators.jl solve_window_probability_eigenvector! :236)."""
        if visited_mask is None:
            visited_mask = self.visited_mask()
        Q = self.window_transition_matrix(use_tilts=use_tilts,
                                          visited_mask=visited_mask)
        visited = [i for i, v in enumerate(visited_mask) if v]
        out = np.zeros(len(self.windows))
        if len(visited) == 1:
            out[visited[0]] = 1.0
            return out, Q
        Qs = Q[np.ix_(visited, visited)]
        n = len(visited)
        A = Qs - np.eye(n)
        b = np.zeros(n)
        A[n - 1, :] = 1.0
        b[n - 1] = 1.0
        probs = np.linalg.pinv(A) @ b
        eps = math.sqrt(np.finfo(np.float64).eps)
        probs[(probs < 0) & (probs > -eps)] = 0.0
        if (np.any(probs < 0) or not np.all(np.isfinite(probs))
                or probs.sum() <= 0):
            probs = np.full(n, 1.0 / n)
        else:
            probs /= probs.sum()
        for li, wi in enumerate(visited):
            out[wi] = probs[li]
        _check_probabilities(out, "window probabilities")
        return out / out.sum(), Q

    def update_window_probabilities(self):
        c = self._coupling()
        c.window_probs, c.window_transition = self.solve_window_probabilities(
            use_tilts=True)
        return c.window_probs

    def _global_rung_weights(self):
        c = self._coupling()
        w = np.zeros(self.n_states)
        for wj, est in enumerate(self.estimators):
            pj = c.window_probs[wj]
            if pj <= 0:
                continue
            denom = sum(self._local_weight(est, li, True)
                        for li in range(est.n_local))
            if not (np.isfinite(denom) and denom > 0):
                raise ValueError(f"TSS window {wj} has invalid global-rung "
                                 f"denominator {denom}")
            for li in range(est.n_local):
                gi = est.state_indices[li]
                w[gi] += pj * self._local_weight(est, li, True) / denom
        total = w.sum()
        if not (np.isfinite(total) and total > 0):
            raise ValueError("TSS global rung weights have invalid total")
        c.global_rung_weights = w / total
        c.lhs_marginal = c.global_rung_weights.copy()
        return c.global_rung_weights

    def _window_state_tables(self):
        """Dense (W, G) views of the window-local estimator arrays: a
        membership mask plus log_gamma and f scattered to global state
        columns (-inf / 0 outside each window). Lets the visit-control math
        run as whole-matrix NumPy ops instead of per-(window, state) Python
        loops — O(10x) faster per cycle at realistic window counts."""
        n_w, n_g = len(self.windows), self.n_states
        member = np.zeros((n_w, n_g), dtype=bool)
        lgam = np.full((n_w, n_g), -np.inf)
        fmat = np.zeros((n_w, n_g))
        for wi, est in enumerate(self.estimators):
            idx = np.asarray(est.state_indices, dtype=np.intp)
            member[wi, idx] = True
            lgam[wi, idx] = est.log_gamma
            fmat[wi, idx] = est.f
        return member, lgam, fmat

    @staticmethod
    def _row_logsumexp(a, axis):
        """logsumexp along `axis`, mapping empty (all -inf) slices to -inf
        without warnings."""
        hi = np.max(a, axis=axis, keepdims=True)
        safe = np.where(np.isfinite(hi), hi, 0.0)
        with np.errstate(divide="ignore"):
            out = np.log(np.sum(np.exp(a - safe), axis=axis)) + np.squeeze(
                safe, axis=axis)
        return np.where(np.isfinite(np.squeeze(hi, axis=axis)), out, -np.inf)

    @staticmethod
    def _gauge_offsets(offsets, probs):
        weight = probs.sum()
        if weight <= 0:
            return offsets
        offsets -= (probs * offsets).sum() / weight
        return offsets

    def solve_visit_control(self):
        """Fixed-point solve for the window offsets that make the stitched
        sampling marginal self-consistent (the windowed visit-control
        equations of global_estimators.jl:353-412, re-expressed as dense
        (W, G) matrix updates: one masked logsumexp down the window axis for
        the per-state mixture denominators, one along the state axis for
        the per-window offset refresh)."""
        c = self._coupling()
        eta = self.estimators[0].ETA
        self._global_rung_weights()
        if eta == 0:
            c.window_offsets[:] = 0.0
            c.visit_control_f = self.local_average_free_energies()
            self._visit_control_residual()
            c.iterations = 0
            c.converged = True
            return c
        eta1 = eta + 1.0
        member, lgam, fmat = self._window_state_tables()
        live_w = c.window_probs > 0
        live_g = c.global_rung_weights > 0
        with np.errstate(divide="ignore"):
            log_pw = np.where(live_w, np.log(
                np.where(live_w, c.window_probs, 1.0)), -np.inf)
            log_qg = np.where(live_g, np.log(
                np.where(live_g, c.global_rung_weights, 1.0)), -np.inf)
        base = np.where(member, lgam + fmat / eta1, -np.inf)   # (W, G)
        mix_rows = log_pw[:, None] + base                       # (W, G)

        c.converged = False
        c.iterations = 0
        for it in range(1, c.max_iterations + 1):
            # per-state mixture denominator under the current offsets
            log_mix = self._row_logsumexp(
                mix_rows - c.window_offsets[:, None] / eta1, axis=0)  # (G,)
            if np.any(live_g & ~np.isfinite(log_mix)):
                bad = int(np.argmax(live_g & ~np.isfinite(log_mix)))
                raise ValueError(
                    "TSS visit control: state %d has zero mixture density "
                    "(no live window covers it)" % bad)
            # per-window refresh against the global rung weights (dead
            # states q == 0 contribute nothing, exactly as the per-state
            # loop skipped them — masking also avoids -inf - -inf = NaN)
            with np.errstate(invalid="ignore"):
                # dead states (q == 0) hit -inf - -inf before the mask
                refresh_rows = np.where(
                    member & live_g[None, :],
                    log_qg[None, :] + base - log_mix[None, :], -np.inf)
            refresh = self._row_logsumexp(refresh_rows, axis=1)  # (W,)
            if np.any(live_w & ~np.isfinite(refresh)):
                bad = int(np.argmax(live_w & ~np.isfinite(refresh)))
                raise ValueError(
                    "TSS visit control: window %d receives zero refresh "
                    "weight" % bad)
            trial = np.where(live_w, eta1 * refresh, 0.0)
            self._gauge_offsets(trial, c.window_probs)
            c.iterations = it
            delta = float(np.max(np.abs(trial - c.window_offsets)))
            c.window_offsets += c.damping * (trial - c.window_offsets)
            self._gauge_offsets(c.window_offsets, c.window_probs)
            if delta <= c.tolerance:
                c.converged = True
                break
        self._update_visit_control_free_energies()
        self._visit_control_residual()
        return c

    def _update_visit_control_free_energies(self):
        c = self._coupling()
        eta1 = self.estimators[0].ETA + 1.0
        fallback = self.local_average_free_energies()
        member, lgam, fmat = self._window_state_tables()
        live_w = c.window_probs > 0
        live_g = c.global_rung_weights > 0
        with np.errstate(divide="ignore"):
            log_pw = np.where(live_w, np.log(
                np.where(live_w, c.window_probs, 1.0)), -np.inf)
            log_qg = np.where(live_g, np.log(
                np.where(live_g, c.global_rung_weights, 1.0)), -np.inf)
        rows = np.where(member,
                        log_pw[:, None] + lgam
                        + (fmat - c.window_offsets[:, None]) / eta1,
                        -np.inf)
        log_mix = self._row_logsumexp(rows, axis=0)             # (G,)
        if np.any(live_g & ~np.isfinite(log_mix)):
            bad = int(np.argmax(live_g & ~np.isfinite(log_mix)))
            raise ValueError(
                "TSS visit control: stitched free energy has zero mixture "
                "density at state %d" % bad)
        with np.errstate(invalid="ignore"):
            c.visit_control_f = np.where(live_g, eta1 * (log_mix - log_qg),
                                         fallback)
        c.visit_control_f -= c.visit_control_f[0]
        _check_finite(c.visit_control_f, "visit-control free energies")
        return c.visit_control_f

    def _candidate_densities(self):
        """Per-window sampling densities pulled towards the global stitched f
        (global_estimators.jl compute_windowed_sampling_densities! :445)."""
        c = self._coupling()
        _check_finite(c.visit_control_f, "visit-control free energies")
        for wi, est in enumerate(self.estimators):
            strength = est.ETA / (est.ETA + 1.0)
            idx = np.asarray(est.state_indices, dtype=np.intp)
            scratch = est.log_gamma + strength * (
                c.visit_control_f[idx] - est.f)
            log_norm = _logsumexp(scratch)
            if not np.isfinite(log_norm):
                raise ValueError(f"TSS window {wi} candidate density "
                                 "normalization non-finite")
            cand = np.exp(scratch - log_norm)
            cand = ((1.0 - c.pi_regularization) * cand
                    + c.pi_regularization * est.gamma)
            cand /= cand.sum()
            _check_probabilities(cand, f"candidate density for window {wi}")
            c.candidate_densities[wi] = cand
        return c.candidate_densities

    def _visit_control_rhs(self):
        c = self._coupling()
        rhs = np.zeros(self.n_states)
        for wi, est in enumerate(self.estimators):
            if c.window_probs[wi] <= 0:
                continue
            scratch = np.array([
                est.log_gamma[li] + (est.f[li] - c.visit_control_f[
                    est.state_indices[li]]) / (est.ETA + 1.0)
                for li in range(est.n_local)])
            log_den = _logsumexp(scratch)
            if not np.isfinite(log_den):
                raise ValueError(f"TSS window {wi} has non-finite "
                                 "visit-control rhs denominator")
            for li in range(est.n_local):
                gi = est.state_indices[li]
                rhs[gi] += c.window_probs[wi] * math.exp(
                    scratch[li] - log_den)
        if rhs.sum() > 0:
            rhs /= rhs.sum()
        c.rhs_marginal = rhs
        return rhs

    def _visit_control_residual(self):
        c = self._coupling()
        self._visit_control_rhs()
        c.max_abs_residual = 0.0
        for gi in range(self.n_states):
            lhs = c.global_rung_weights[gi]
            rhs = c.rhs_marginal[gi]
            if lhs > 0:
                if not (np.isfinite(rhs) and rhs > 0):
                    raise ValueError("TSS visit-control rhs is invalid at "
                                     f"state {gi}: {rhs}")
                c.residual[gi] = math.log(rhs) - math.log(lhs)
                c.max_abs_residual = max(c.max_abs_residual,
                                         abs(c.residual[gi]))
            else:
                c.residual[gi] = 0.0
        _check_finite(c.residual, "visit-control residual")
        return c.residual

    def _apply_candidate_densities(self):
        c = self._coupling()
        for wi, est in enumerate(self.estimators):
            cand = c.candidate_densities[wi]
            _check_probabilities(cand, f"candidate density for window {wi}")
            est.density = cand / cand.sum()
            est.log_dens = np.log(est.density)
        return self

    def reported_components(self, local_f_by_window, visited_only=False):
        """Stitch local window estimates into one global free-energy vector:
        tilt-free window-occupancy solve, per-rung gamma-weighted means, and
        an offset linear solve removing the per-window gauges
        (global_estimators.jl compute_reported_tss_free_energy_components
        :551-673)."""
        if len(local_f_by_window) != len(self.estimators):
            raise ValueError("local_f_by_window must match the number of "
                             "TSS windows")
        for wi, est in enumerate(self.estimators):
            lf = local_f_by_window[wi]
            if len(lf) != est.n_local:
                raise ValueError(f"local f for window {wi} has wrong length")
            _check_finite(lf, f"local f for window {wi}")
        mask = (self.visited_mask() if visited_only
                else [True] * len(self.windows))
        probs, _ = self.solve_window_probabilities(use_tilts=False,
                                                   visited_mask=mask)
        K = self.n_states
        gamma_tss = np.zeros(K)
        for wj, est in enumerate(self.estimators):
            pj = probs[wj]
            if pj <= 0:
                continue
            for li in range(est.n_local):
                gamma_tss[est.state_indices[li]] += pj * est.gamma[li]
        total = gamma_tss.sum()
        if not (np.isfinite(total) and total > 0):
            raise ValueError("TSS reported rung density has invalid total")
        gamma_tss /= total

        active = [w for w in range(len(self.windows)) if probs[w] > 0]
        if not active:
            raise ValueError("no TSS windows available for reporting")
        n_active = len(active)
        gw_f = np.zeros(K)
        for gi in range(K):
            g = gamma_tss[gi]
            if g <= 0:
                continue
            for wj in self.state_to_windows[gi]:
                pj = probs[wj]
                if pj <= 0:
                    continue
                est = self.estimators[wj]
                li = est.local_index(gi)
                gw_f[gi] += pj * est.gamma[li] * \
                    local_f_by_window[wj][li] / g

        T = np.zeros((n_active, n_active))
        rhs = np.zeros(n_active)
        for ai, wi in enumerate(active):
            est_i = self.estimators[wi]
            for gi in self.windows[wi].state_indices:
                g = gamma_tss[gi]
                if g <= 0:
                    continue
                li_i = est_i.local_index(gi)
                gm_i = est_i.gamma[li_i]
                rhs[ai] += gm_i * (local_f_by_window[wi][li_i] - gw_f[gi])
                for aj, wj in enumerate(active):
                    if wj not in self.state_to_windows[gi]:
                        continue
                    est_j = self.estimators[wj]
                    li_j = est_j.local_index(gi)
                    T[ai, aj] += gm_i * probs[wj] * est_j.gamma[li_j] / g
        A = np.eye(n_active) - T
        b = rhs.copy()
        A[n_active - 1, :] = probs[active]
        b[n_active - 1] = 0.0
        offs = np.linalg.pinv(A) @ b
        reported_offsets = np.zeros(len(self.windows))
        for ai, wi in enumerate(active):
            reported_offsets[wi] = offs[ai]
        self._gauge_offsets(reported_offsets, probs)

        fallback = self.local_average_free_energies(local_f_by_window)
        reported_f = np.zeros(K)
        for gi in range(K):
            g = gamma_tss[gi]
            if g <= 0:
                reported_f[gi] = fallback[gi]
                continue
            value = 0.0
            for wj in self.state_to_windows[gi]:
                pj = probs[wj]
                if pj <= 0:
                    continue
                est = self.estimators[wj]
                li = est.local_index(gi)
                value += pj * est.gamma[li] * (
                    local_f_by_window[wj][li] - reported_offsets[wj])
            reported_f[gi] = value / g
        reported_f -= reported_f[0]
        _check_finite(reported_f, "reported free energies")
        _check_finite(reported_offsets, "reported window offsets")
        _check_probabilities(gamma_tss, "reported rung density")
        return dict(reported_f=reported_f, reported_gamma=gamma_tss,
                    reported_offsets=reported_offsets,
                    reported_window_probs=probs)

    def compute_reported_free_energies(self, visited_only=False):
        c = self._coupling()
        comp = self.reported_components(self.local_free_energies(),
                                        visited_only=visited_only)
        c.reported_window_probs = comp["reported_window_probs"]
        c.reported_gamma = comp["reported_gamma"]
        c.reported_offsets = comp["reported_offsets"]
        c.reported_f = comp["reported_f"]
        return c.reported_f

    def update_adaptive_gamma(self):
        """Shared-max CovDet gamma across windows (global_estimators.jl
        update_windowed_tss_adaptive_gamma! :712)."""
        if not any(isinstance(e.adaptive_gamma, TSSCovDetAdaptiveGamma)
                   for e in self.estimators):
            return self
        raws = [e.covdet_raw_values() for e in self.estimators]
        max_detcov = 0.0
        for raw in raws:
            if raw is not None and raw.size:
                max_detcov = max(max_detcov, float(np.max(raw)))
        for est, raw in zip(self.estimators, raws):
            est.apply_covdet_gamma(raw, max_detcov)
            if self.coupling is None:
                est.update_sampling_distribution()
        return self

    def update_coupling(self):
        if self.coupling is None:
            return None
        self.update_window_probabilities()
        self.solve_visit_control()
        self._candidate_densities()
        self._apply_candidate_densities()
        self.compute_reported_free_energies()
        return self.coupling

    # -- observations --------------------------------------------------------

    def drop_old_histories(self, history_time):
        for est in self.estimators:
            if est.history is None:
                continue
            est.history.drop_old_epochs(history_time)
            if est.recent_count() > 0:
                est.aggregate_history()
                est.update_sampling_distribution()
        return self

    def apply_observations(self, observations):
        """Fold a cycle's per-replica observations into the estimators and
        refresh the global coupling (windowed_simulation.jl
        apply_windowed_tss_observations! :673-710). Returns max |delta f|."""
        history_time = self.iteration + 1
        old_f = [e.f.copy() for e in self.estimators]
        if len(observations) == 1:
            obs = observations[0]
            est = self.estimators[obs.update_window]
            est.reduced_pot = np.asarray(obs.reduced_pot, dtype=np.float64)
            est.weights = np.asarray(obs.weights, dtype=np.float64)
            max_df = est.update_estimates(
                obs.visited_state, history_time=history_time,
                adaptive_values=obs.adaptive_values,
                update_adaptive_gamma=False)
            self.window_update_counts[obs.update_window] += 1
            self.iteration += 1
            self.drop_old_histories(self.iteration)
            self.update_adaptive_gamma()
            self.update_coupling()
            return max_df
        for obs in observations:
            est = self.estimators[obs.update_window]
            if est.history is None:
                raise ValueError("multireplica TSS observation updates "
                                 "require history forgetting")
            vis_local = est.local_index(obs.visited_state)
            est.reduced_pot = np.asarray(obs.reduced_pot, dtype=np.float64)
            est.update_history(vis_local, obs.log_den, history_time,
                               adaptive_values=obs.adaptive_values,
                               aggregate=False)
            est.iteration += 1
            self.window_update_counts[obs.update_window] += 1
        self.iteration += 1
        self.drop_old_histories(self.iteration)
        self.update_adaptive_gamma()
        self.update_coupling()
        max_df = 0.0
        for wi, est in enumerate(self.estimators):
            max_df = max(max_df, float(np.max(np.abs(est.f - old_f[wi]))))
        return max_df

    def apply_frozen_observations(self, observations):
        for obs in observations:
            self.window_update_counts[obs.update_window] += 1
        self.iteration += 1
        return 0.0

    def log_stats(self, update_window, visited_state, next_state,
                  max_delta_f, replica_records=None):
        st = self.stats
        st["iterations"].append(self.iteration)
        st["update_window"].append(update_window)
        st["visited_state"].append(visited_state)
        st["sampled_next_state"].append(next_state)
        st["max_abs_delta_f"].append(max_delta_f)
        st["active_window_history"].append(self.active_window)
        recs = replica_records or [(0, update_window, visited_state,
                                    next_state)]
        st["replica_indices"].append([r[0] for r in recs])
        st["replica_update_windows"].append([r[1] for r in recs])
        st["replica_visited_states"].append([r[2] for r in recs])
        st["replica_sampled_next_states"].append([r[3] for r in recs])
        if self.coupling is None:
            st["reported_f_history"].append(np.zeros(0))
            st["visit_control_converged"].append(False)
            st["visit_control_iterations"].append(0)
            st["visit_control_max_abs_residual"].append(np.nan)
            st["window_prob_history"].append(np.zeros(0))
            st["visit_control_f_history"].append(np.zeros(0))
        else:
            c = self.coupling
            st["reported_f_history"].append(tss_free_energies(self))
            st["visit_control_converged"].append(c.converged)
            st["visit_control_iterations"].append(c.iterations)
            st["visit_control_max_abs_residual"].append(c.max_abs_residual)
            st["window_prob_history"].append(c.window_probs.copy())
            st["visit_control_f_history"].append(c.visit_control_f.copy())


def tss_free_energies(state, reference_state=0, visited_only=False):
    """Reported (stitched) TSS free energies relative to `reference_state`
    (global_estimators.jl tss_free_energies :752)."""
    state._coupling()
    if not 0 <= reference_state < state.n_states:
        raise ValueError(f"reference_state {reference_state} out of bounds")
    state.compute_reported_free_energies(visited_only=visited_only)
    reported = state.coupling.reported_f.copy()
    reported -= reported[reference_state]
    return reported


# -- jackknife uncertainties -------------------------------------------------

@dataclasses.dataclass
class TSSJackknifeResult:
    free_energies: np.ndarray
    standard_errors: np.ndarray
    mse: np.ndarray
    reference_state: int
    epoch_indices: List[int]
    epoch_weights: np.ndarray
    replicates: np.ndarray


def tss_free_energy_uncertainties(state, reference_state=0):
    """Delete-one-epoch jackknife standard errors
    (global_estimators.jl tss_free_energy_uncertainties :883-964)."""
    state._coupling()
    K = state.n_states
    if not 0 <= reference_state < K:
        raise ValueError(f"reference_state {reference_state} out of bounds")
    if state.iteration <= 0:
        raise ValueError("TSS jackknife requires at least one windowed "
                         "update")
    histories = []
    for est in state.estimators:
        if est.history is None:
            raise ValueError("TSS jackknife requires history forgetting")
        histories.append(est.history)
    cfg = histories[0].config
    for wi, h in enumerate(histories):
        if (h.config.alpha, h.config.phi, h.config.n_epochs) != \
                (cfg.alpha, cfg.phi, cfg.n_epochs):
            raise ValueError("TSS jackknife requires matching "
                             "history-forgetting config in every window; "
                             f"window {wi} differs")
    epoch_indices = histories[0].retained_epoch_indices(state.iteration)
    for h in histories[1:]:
        if h.retained_epoch_indices(state.iteration) != epoch_indices:
            raise ValueError("TSS jackknife retained epoch boundaries "
                             "differ across windows")
    if len(epoch_indices) < 2:
        raise ValueError("TSS jackknife requires at least two retained "
                         f"epochs; got {len(epoch_indices)}")
    empty = [wi for wi, h in enumerate(histories)
             if h.sample_count(epoch_indices=epoch_indices) == 0]
    if empty:
        raise ValueError(f"TSS jackknife: windows {empty} have no samples "
                         "in the shared retained epochs")
    for e in epoch_indices:
        empty = [wi for wi, h in enumerate(histories)
                 if h.sample_count(omit_epoch_index=e,
                                   epoch_indices=epoch_indices) == 0]
        if empty:
            raise ValueError(f"TSS jackknife: deleting epoch {e} leaves "
                             f"windows {empty} with no retained samples")
    epoch_weights = histories[0].epoch_weights(epoch_indices,
                                               state.iteration)
    if np.any(epoch_weights <= 0):
        raise ValueError("TSS jackknife epoch weights must be positive")

    def local_f(omit=None):
        return [est.aggregate_history_free_energies(
            omit_epoch_index=omit, epoch_indices=epoch_indices)
            for est in state.estimators]

    full = state.reported_components(local_f())["reported_f"].copy()
    full -= full[reference_state]
    n_rep = len(epoch_indices)
    replicates = np.zeros((K, n_rep))
    for ri, e in enumerate(epoch_indices):
        rep = state.reported_components(local_f(omit=e))["reported_f"].copy()
        rep -= rep[reference_state]
        replicates[:, ri] = rep
    mse = np.zeros(K)
    for gi in range(K):
        acc = 0.0
        for ri in range(n_rep):
            w = epoch_weights[ri]
            d = replicates[gi, ri] - full[gi]
            acc += ((1.0 - w) ** 2 / w) * d * d
        mse[gi] = acc / (n_rep - 1)
    mse[reference_state] = 0.0
    _check_finite(mse, "jackknife mean-square errors")
    se = np.sqrt(np.maximum(mse, 0.0))
    se[reference_state] = 0.0
    return TSSJackknifeResult(free_energies=full, standard_errors=se,
                              mse=mse, reference_state=reference_state,
                              epoch_indices=epoch_indices,
                              epoch_weights=epoch_weights,
                              replicates=replicates)


# -- PMF deconvolution backend ----------------------------------------------

@dataclasses.dataclass
class _PMFSample:
    value: tuple
    log_bin_weights: np.ndarray
    log_reweight: float


class TSSPMFDeconvolution:
    """Sampled PMF deconvolution fed by TSS cycles (deconvolution.jl:1-257):
    each end-of-cycle CV sample enters a log-space weighted histogram with
    the inverse time-dependent effective bias at the observed bin, stored in
    per-epoch accumulators when history forgetting is active so forgotten
    epochs drop out of the PMF too.

    coupling(xi, k) must return the DIMENSIONLESS bias of global state k at
    PMF coordinate xi; cv(sys) returns the CV tuple. With neither given, the
    per-state bias potentials of the ExtendedStateSpace are used.
    """

    def __init__(self, state, grid, cv=None, coupling=None):
        if not isinstance(state, TSSState):
            raise ValueError("TSSPMFDeconvolution requires a TSSState")
        self.state = state
        self.grid = grid if isinstance(grid, PMFGrid) else PMFGrid.create(
            grid)
        if cv is not None and coupling is None:
            raise ValueError("provide coupling when using a custom cv")
        space = state.space
        if coupling is None:
            if space.biases is None:
                raise ValueError("automatic PMF deconvolution needs "
                                 "per-state bias potentials; provide cv and "
                                 "coupling otherwise")
            betas = space.betas()
            biases = space.biases
            if cv is None:
                def cv(sys, _b=biases):
                    b = next(x for x in _b if x is not None)
                    val = b.cv.value(sys.coords, sys.boundary)
                    return (float(val),)

            def coupling(xi, k, _biases=biases, _betas=betas):
                b = _biases[k]
                if b is None:
                    return 0.0
                x = xi if self.grid.ndim > 1 else (
                    xi if np.isscalar(xi) else xi[0])
                return float(_betas[k]) * float(b.bias(x))
        self.cv = cv
        self.log_coupling_matrix = build_log_coupling_matrix(
            self.grid, space.n_states, coupling=coupling)
        self.accumulator = SampledPMFDeconvolutionAccumulator(grid=self.grid)
        self.epoch_accumulators = {}

    def log_bin_weights(self, estimator, window_offset=0.0):
        lw_local = estimator.f + estimator.log_dens - window_offset
        cols = self.log_coupling_matrix[:, estimator.state_indices]
        return pmf_log_bin_weights(cols, lw_local)

    def collect_sample(self, estimator, sys, window_offset=0.0):
        value = self.cv(sys)
        value = tuple(np.atleast_1d(np.asarray(value,
                                               dtype=np.float64)).tolist())
        if len(value) != self.grid.ndim:
            raise ValueError(f"PMF CV returned {len(value)} dims, expected "
                             f"{self.grid.ndim}")
        return _PMFSample(value=value,
                          log_bin_weights=self.log_bin_weights(
                              estimator, window_offset),
                          log_reweight=0.0)

    def _uses_epoch_history(self, estimator):
        return (estimator.history is not None
                and estimator.history.config.alpha != 0.0)

    def accumulate(self, observations, history_time):
        if history_time <= 0:
            raise ValueError("history_time must be positive")
        for obs in observations:
            est = self.state.estimators[obs.update_window]
            if self._uses_epoch_history(est):
                ei = est.history.epoch_index(int(history_time))
                acc = self.epoch_accumulators.get(ei)
                if acc is None:
                    acc = SampledPMFDeconvolutionAccumulator(grid=self.grid)
                    self.epoch_accumulators[ei] = acc
            else:
                acc = self.accumulator
            for s in obs.pmf_samples:
                acc.accumulate(s.value, s.log_bin_weights, s.log_reweight)
        return self

    def drop_old_epochs(self, history_time):
        if not self.epoch_accumulators:
            return self
        retained = set()
        for est in self.state.estimators:
            if not self._uses_epoch_history(est):
                continue
            first = est.history.first_retained_epoch_index(int(history_time))
            current = est.history.epoch_index(int(history_time))
            retained.update(range(first, current + 1))
        if retained:
            self.epoch_accumulators = {
                k: v for k, v in self.epoch_accumulators.items()
                if k in retained}
        return self

    def retained_accumulator(self):
        if not self.epoch_accumulators:
            return self.accumulator
        acc = SampledPMFDeconvolutionAccumulator(grid=self.grid)
        for a in self.epoch_accumulators.values():
            acc.merge(a)
        return acc

    def pmf(self, zero="min", kBT=None, **kwargs):
        return pmf_result_from_sampled_deconvolution(
            self.retained_accumulator(), zero=zero, kBT=kBT, **kwargs)


# -- simulation driver -------------------------------------------------------

@dataclasses.dataclass
class _Observation:
    replica_index: int
    update_window: int
    visited_state: int
    sampled_next_state: int
    log_den: float
    reduced_pot: np.ndarray
    weights: np.ndarray
    adaptive_values: Optional[np.ndarray]
    pmf_samples: list

    @property
    def visited_state_(self):
        return self.visited_state


class _Replica:
    """One walker: a System plus its active rung and window
    (windowed_simulation.jl WindowedTSSReplica :45)."""

    def __init__(self, sys, state_index, window):
        self.sys = sys              # base system (no state applied)
        self.state_index = int(state_index)
        self.window = int(window)


class TSSSimulation:
    """Windowed TSS simulation driver.

    Each cycle, every replica: swaps to the OTHER window containing its rung,
    runs `self_adjustment_steps` blocks of `n_md_steps` MD steps at its rung,
    evaluates the window's reduced potentials (one K-state sweep),
    Gibbs-samples the next rung from the conditional window weights, then the
    shared TSSState folds all observations in and re-solves the global
    visit-control coupling.
    """

    def __init__(self, state, system, simulator, n_md_steps, n_cycles,
                 self_adjustment_steps=1, log_freq=1000, n_replicas=None,
                 first_states=None, first_windows=None, pmf=None,
                 frozen=False, initial_step=0):
        if n_md_steps <= 0:
            raise ValueError("n_md_steps must be positive")
        if n_cycles < 0:
            raise ValueError("n_cycles must be non-negative")
        if initial_step < 0:
            raise ValueError("initial_step must be non-negative")
        if self_adjustment_steps <= 0:
            raise ValueError("self_adjustment_steps must be positive")
        if log_freq <= 0:
            raise ValueError("log_freq must be positive")
        if pmf is not None:
            if not isinstance(pmf, TSSPMFDeconvolution):
                raise ValueError("pmf must be a TSSPMFDeconvolution")
            if pmf.state is not state:
                raise ValueError("pmf must be created from the same "
                                 "TSSState object")
        self.state = state
        self.simulator = simulator
        self.n_md_steps = int(n_md_steps)
        self.n_cycles = int(n_cycles)
        self.self_adjustment_steps = int(self_adjustment_steps)
        self.log_freq = int(log_freq)
        self.pmf = pmf
        self.frozen = bool(frozen)
        self.current_step = int(initial_step)

        n_rep = 1 if n_replicas is None else int(n_replicas)
        if n_rep <= 0:
            raise ValueError("n_replicas must be positive")
        if first_states is None:
            first_states = [state.active_state_index] * n_rep
        else:
            first_states = [int(s) for s in first_states]
            if len(first_states) != n_rep:
                raise ValueError(f"first_states must have length {n_rep}")
        if first_windows is None:
            if n_rep == 1 and first_states[0] == state.active_state_index:
                first_windows = [state.active_window]
            else:
                first_windows = [state.windows_for_state(s)[0]
                                 for s in first_states]
        else:
            first_windows = [int(w) for w in first_windows]
            if len(first_windows) != n_rep:
                raise ValueError(f"first_windows must have length {n_rep}")
        for ri in range(n_rep):
            s, w = first_states[ri], first_windows[ri]
            if not 0 <= w < len(state.windows):
                raise ValueError(f"first_windows[{ri}] out of range")
            if s not in state.windows[w]:
                raise ValueError(f"first_windows[{ri}] must contain "
                                 f"first_states[{ri}]")
        if n_rep > 1 and not self.frozen:
            if not all(e.history is not None for e in state.estimators):
                raise ValueError("multireplica TSSSimulation requires "
                                 "history_forgetting in TSSState")
        self.replicas = [_Replica(system, first_states[i], first_windows[i])
                         for i in range(n_rep)]

    # -- device work ---------------------------------------------------------

    def _md_segment(self, replica, init_step, generator=None, noise=None):
        """n_md_steps of MD at the replica's rung from a list built at
        init_step (run_chunk's schedule and stale-list checks)."""
        space = self.state.space
        idx = replica.state_index
        sys = space.apply_state(replica.sys, idx)
        integ = space.integrator_for(self.simulator, idx)
        nbs = find_neighbors(sys.neighbor_finder, sys.coords, sys.boundary,
                             sys.exclusions, init_step)
        aux = integ.init_aux(sys, nbs)
        out, _, _, _ = run_chunk(integ, sys, nbs, aux, init_step,
                                 self.n_md_steps, generator=generator,
                                 noise=noise)
        replica.sys = replica.sys.update(coords=out.coords,
                                         velocities=out.velocities,
                                         boundary=out.boundary)
        return replica

    def _reduced_potentials(self, replica, indices):
        """u_k(x) over the window's evaluation states, on a list built for
        the sweep at step 0 (as the JAX package builds it), read to the
        host in float64."""
        sys = replica.sys
        neighbors = find_neighbors(sys.neighbor_finder, sys.coords,
                                   sys.boundary, sys.exclusions, 0)
        u = self.state.space.reduced_potentials(sys, neighbors,
                                                indices=indices)
        return u.cpu().numpy()

    # -- per-cycle collection -----------------------------------------------

    def _collect_observation(self, replica_i, rng, generator, noise,
                             initial_step):
        state = self.state
        replica = self.replicas[replica_i]
        entry = replica.state_index
        replica.window = state.other_window_for_state(entry, replica.window)
        cycle_window = replica.window
        est = state.estimators[cycle_window]
        if entry not in state.windows[cycle_window]:
            raise ValueError("TSS cycle invariant failed: entry state "
                             f"{entry} not in window {cycle_window}")
        final_visited = entry
        final_next = entry
        final_log_den = 0.0
        final_u = None
        final_w = None
        pmf_samples = []
        for substep in range(self.self_adjustment_steps):
            visited = replica.state_index
            if visited not in state.windows[cycle_window]:
                raise ValueError("TSS cycle invariant failed: visited state "
                                 f"{visited} left window {cycle_window}")
            self._md_segment(replica,
                             initial_step + substep * self.n_md_steps,
                             generator, noise)
            u_eval = self._reduced_potentials(
                replica, est.evaluation_state_indices)
            local_u = np.array([
                u_eval[int(est.evaluation_local_index_by_state[gi])]
                for gi in est.state_indices])
            log_state_bias = est.f + est.log_dens
            weights = conditional_state_weights(log_state_bias, local_u)
            _check_probabilities(weights, "conditional weights")
            log_den = _logsumexp(log_state_bias - local_u)
            if self.pmf is not None and \
                    substep == self.self_adjustment_steps - 1:
                offset = (0.0 if state.coupling is None
                          else float(state.coupling.window_offsets[
                              cycle_window]))
                est_view = est
                # freeze reduced_pot view for the bin-weight evaluation
                pmf_samples.append(self.pmf.collect_sample(
                    est_view, state.space.apply_state(replica.sys,
                                                      replica.state_index),
                    window_offset=offset))
            nxt = est.global_index(sample_state(rng, weights))
            if nxt not in state.windows[cycle_window]:
                raise ValueError("TSS cycle invariant failed: sampled state "
                                 f"{nxt} not in window {cycle_window}")
            final_visited = visited
            final_next = nxt
            final_log_den = log_den
            final_u = local_u
            final_w = weights
            # covdet values need the full evaluation vector
            final_u_eval = u_eval
            replica.state_index = nxt
        adaptive = None
        if isinstance(est.adaptive_gamma, TSSCovDetAdaptiveGamma):
            est.evaluation_reduced_pot = final_u_eval
            adaptive = est.covdet_moment_values(final_u_eval)
        return _Observation(
            replica_index=replica_i, update_window=cycle_window,
            visited_state=final_visited, sampled_next_state=final_next,
            log_den=final_log_den, reduced_pot=final_u, weights=final_w,
            adaptive_values=adaptive, pmf_samples=pmf_samples)

    # -- run -----------------------------------------------------------------

    def run(self, seed=0, generators=None, noise=None):
        """Run n_cycles cycles. Returns the TSSState. Replica i samples its
        rungs with numpy.random.default_rng(seed + 7919 (i + 1)), as in the
        JAX package, and draws its MD noise from generators[i] (default: a
        torch.Generator on the replica's device seeded with the same
        number); ``noise``, a callable (replica index, step_n) -> the
        step's draws, replaces the generators (run_chunk)."""
        state = self.state
        n_rep = len(self.replicas)
        seeds = [seed + 7919 * (i + 1) for i in range(n_rep)]
        rngs = [np.random.default_rng(s) for s in seeds]
        if generators is None:
            generators = [torch.Generator(device=r.sys.device).manual_seed(s)
                          for r, s in zip(self.replicas, seeds)]
        for _ in range(self.n_cycles):
            cycle_start = self.current_step
            observations = []
            for ri in range(n_rep):
                step_noise = (None if noise is None else
                              lambda step_n, ri=ri: noise(ri, step_n))
                observations.append(self._collect_observation(
                    ri, rngs[ri], generators[ri], step_noise, cycle_start))
            history_time = state.iteration + 1
            if self.pmf is not None:
                self.pmf.accumulate(observations, history_time)
            if self.frozen:
                max_df = state.apply_frozen_observations(observations)
            else:
                max_df = state.apply_observations(observations)
                if self.pmf is not None:
                    self.pmf.drop_old_epochs(state.iteration)
            # keep the shared state's cursor in sync with replica 0
            state.active_window = self.replicas[0].window
            state.active_state_index = self.replicas[0].state_index
            if not self.frozen and (
                    state.iteration == 1
                    or state.iteration % self.log_freq == 0):
                for obs in observations:
                    state.estimators[obs.update_window].log_stats(
                        obs.visited_state, obs.sampled_next_state, max_df)
                first = observations[0]
                state.log_stats(
                    first.update_window, first.visited_state,
                    first.sampled_next_state, max_df,
                    replica_records=[
                        (o.replica_index, o.update_window, o.visited_state,
                         o.sampled_next_state) for o in observations])
            self.current_step += self.self_adjustment_steps * self.n_md_steps
        return state

    # alias matching the reference's simulate!
    simulate = run
