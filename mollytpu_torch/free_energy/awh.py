"""AWH, the accelerated weight histogram method (counterpart of
mollytpu/free_energy/awh.py).

AWHState holds the free-energy estimate f over an ExtendedStateSpace of K
windows, the target distribution rho, the weight accumulators and the
initial-stage doubling of the fictitious sample size; AWHSimulation drives
iterations of [MD segment at the active window -> the K-window energy
sweep and its reweighting -> Gibbs sampling of the next window -> the
log-ratio update of f with well-tempered target scaling and the
covering/exit stage control]; AWHPMFBackend deconvolves a CV histogram on
the fly (Lindahl et al. 2014, eq. 9). The estimator is host NumPy in
float64, the JAX package's code as it is; the MD segments and the energy
sweeps run on the system's device, and the energies, the volume and (with
a PMF backend) the CV are read to the host after each segment.

GridAWH is the compact single-walker variant on a CV grid: Wang-Landau
updates of a GridBias, the negative of the estimate interpolated linearly
on the grid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.general import GeneralInteraction
from ..ops.neighbors import find_neighbors
from ..sim.simulate import run_chunk, simulate
from ..units import KB
from .extended_ensemble import ExtendedStateSpace
from .pmf import (PMFGrid, SampledPMFDeconvolutionAccumulator,
                  build_log_coupling_matrix, pmf_log_bin_weights,
                  pmf_result_from_sampled_deconvolution)


@dataclasses.dataclass
class AWHStats:
    """Logged AWH trajectory statistics (AWH.jl AWHStats)."""

    step_indices: list = dataclasses.field(default_factory=list)
    active_state: list = dataclasses.field(default_factory=list)
    f_history: list = dataclasses.field(default_factory=list)
    n_effective_history: list = dataclasses.field(default_factory=list)
    stage_history: list = dataclasses.field(default_factory=list)
    max_delta_f_history: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class AWHState:
    """State of an AWH run over an ExtendedStateSpace of K windows
    (AWH.jl:51-170)."""

    space: ExtendedStateSpace
    active_idx: int = 0
    f: np.ndarray = None            # (K,) free-energy estimate (kBT units)
    rho: np.ndarray = None          # (K,) target distribution
    log_rho: np.ndarray = None
    seg_weights: np.ndarray = None        # accumulated weights since last update
    gibbs_weights: np.ndarray = None       # last sample's conditional weights
    n_samples_total: float = 0.0
    ref_size: float = 100.0           # fictitious sample size (initial stage)
    seg_samples: int = 0
    covering_stage: bool = True
    visited: set = dataclasses.field(default_factory=set)
    stats: AWHStats = dataclasses.field(default_factory=AWHStats)

    @classmethod
    def create(cls, space, first_state=0, n_bias=100.0, rho=None):
        k = space.n_states
        if not (0 <= first_state < k):
            raise ValueError("first_state out of range")
        rho = (np.full(k, 1.0 / k) if rho is None
               else np.asarray(rho, dtype=np.float64))
        if rho.shape != (k,) or (rho <= 0).any():
            raise ValueError("rho must be a positive length-K distribution")
        rho = rho / rho.sum()
        return cls(space=space, active_idx=int(first_state),
                   f=np.zeros(k), rho=rho, log_rho=np.log(rho),
                   seg_weights=np.zeros(k), gibbs_weights=np.zeros(k),
                   ref_size=float(n_bias))

    @property
    def n_windows(self):
        return self.space.n_states


class AWHPMFBackend:
    """Sampled PMF deconvolution fed by AWH iterations (AWH.jl:174-279)."""

    def __init__(self, awh_state, grid, cv, coupling=None,
                 target_temperature=None, target_pressure=None):
        self.grid = grid if isinstance(grid, PMFGrid) else PMFGrid.create(grid)
        self.cv = cv
        space = awh_state.space
        if coupling is not None:
            self.log_coupling = build_log_coupling_matrix(
                self.grid, space.n_states, coupling=coupling)
        else:
            if space.biases is None:
                raise ValueError("automatic PMF deconvolution needs per-state "
                                 "bias potentials; provide coupling=")
            self.log_coupling = build_log_coupling_matrix(
                self.grid, space.n_states,
                biases=tuple(b.bias if b is not None else None
                             for b in space.biases),
                betas=space.betas())
        self.acc = SampledPMFDeconvolutionAccumulator(grid=self.grid)
        self.target_beta = (None if target_temperature is None
                            else 1.0 / (KB * float(target_temperature)))
        self.target_pressure = target_pressure
        self.cv_history = []
        self.active_idx_history = []

    def update(self, awh_state, sys, weight_factor=1.0, potential_energy=0.0,
               box_volume=0.0, current_beta=1.0, current_pressure=0.0):
        val = self.cv.value(sys.coords, sys.boundary)
        val = tuple(np.atleast_1d(val.detach().double().cpu().numpy()))
        if len(val) == 1:
            val = val[0]
        self.cv_history.append(val)
        self.active_idx_history.append(awh_state.active_idx)
        g = awh_state.f + awh_state.log_rho
        if weight_factor <= 0 or not np.isfinite(weight_factor):
            raise ValueError("PMF deconvolution weight_factor must be "
                             "positive and finite")
        log_w = pmf_log_bin_weights(self.log_coupling, g,
                                    log_weight_factor=np.log(weight_factor))
        reweight_log = 0.0
        if self.target_beta is not None:
            reweight_log -= ((self.target_beta - float(current_beta))
                             * float(potential_energy))
        if self.target_pressure is not None:
            tb = (self.target_beta if self.target_beta is not None
                  else float(current_beta))
            reweight_log -= ((tb * float(self.target_pressure)
                              - float(current_beta) * float(current_pressure))
                             * float(box_volume))
        self.acc.accumulate(val, log_w, log_reweight=reweight_log)

    def pmf(self, zero="min", kBT=None, **kw):
        return pmf_result_from_sampled_deconvolution(self.acc, zero=zero,
                                                     kBT=kBT, **kw)


@dataclasses.dataclass
class AWHSimulation:
    """Reference-class AWH driver (AWH.jl AWHSimulation + simulate!).

    simulator: a template integrator (e.g. Langevin); its temperature is
    overridden per window. n_md_steps MD steps run between samples;
    update_freq samples per bias update; well_tempered_factor scales the
    target distribution toward low-f windows (np.inf disables);
    coverage_threshold controls initial-stage N doubling;
    significant_weight marks windows as visited.
    """

    state: AWHState
    simulator: object
    n_md_steps: int = 10
    update_freq: int = 1
    well_tempered_factor: float = 10.0
    coverage_threshold: float = 1.0
    significant_weight: float = 0.1
    log_freq: int = 100
    pmf: object = None              # AWHPMFBackend | None
    current_step: int = 0
    ref_size0: float = None

    def __post_init__(self):
        if self.n_md_steps <= 0:
            raise ValueError("n_md_steps must be positive")
        if self.update_freq <= 0:
            raise ValueError("update_freq must be positive")
        if self.ref_size0 is None:
            self.ref_size0 = float(self.state.ref_size)

    # -- per-sample reweighting (process_sample, AWH.jl:447-476) ------------

    def _process_sample(self, energies, volume=0.0):
        st = self.state
        betas = st.space.betas()
        u = betas * np.asarray(energies, dtype=np.float64)
        press = st.space.pressures()
        if np.any(np.isfinite(press)):
            u = u + betas * np.where(np.isfinite(press), press, 0.0) * volume
        z = st.log_rho + st.f - u
        z = z - z.max()
        w = np.exp(z)
        w /= w.sum()
        st.gibbs_weights = w
        st.seg_weights += w
        st.seg_samples += 1
        st.n_samples_total += 1.0
        thresh = self.significant_weight / st.n_windows
        for i in np.where(w > thresh)[0]:
            st.visited.add(int(i))
        return float(energies[st.active_idx])

    def _gibbs_sample_window(self, rng):
        return int(rng.choice(self.state.n_windows, p=self.state.gibbs_weights))

    # -- bias update (update_awh_bias!, AWH.jl:497-553) ---------------------

    def _update_bias(self, iteration_n):
        st = self.state
        if st.seg_samples < self.update_freq:
            return None
        ref_weight = (st.ref_size if st.covering_stage
                     else self.ref_size0 + st.n_samples_total)
        num = ref_weight * st.rho + st.seg_weights
        den = ref_weight * st.rho + st.seg_samples * st.rho
        delta_f = np.where(den > 0, np.log(np.maximum(num, 1e-300) / den), 0.0)
        st.f = st.f - delta_f
        st.f = st.f - st.f[0]

        if iteration_n % self.log_freq == 0:
            s = st.stats
            s.step_indices.append(iteration_n)
            s.active_state.append(st.active_idx)
            s.f_history.append(st.f.copy())
            s.n_effective_history.append(ref_weight)
            s.stage_history.append(
                "initial" if st.covering_stage else "linear")
            s.max_delta_f_history.append(float(np.abs(delta_f).max()))

        if np.isfinite(self.well_tempered_factor):
            fmin = st.f.min()
            rho = np.exp(-(st.f - fmin) / self.well_tempered_factor)
            tot = rho.sum()
            if tot > 0:
                rho = rho / tot
            rho = np.maximum(rho, np.finfo(np.float64).tiny)
            st.rho = rho
            st.log_rho = np.log(rho)

        if st.covering_stage:
            if len(st.visited) >= int(np.floor(
                    self.coverage_threshold * st.n_windows)):
                st.ref_size *= 2.0
                st.visited.clear()
                if st.ref_size >= self.ref_size0 + st.n_samples_total:
                    st.covering_stage = False

        st.seg_weights[:] = 0.0
        st.seg_samples = 0
        return delta_f

    # -- the driver -----------------------------------------------------------

    def simulate(self, sys, n_steps, seed=0, generator=None, noise=None):
        """Run floor(n_steps / n_md_steps) AWH iterations from the
        unbiased System. Each segment starts from a list built at its first
        step (so the stale-list check of run_chunk covers each segment),
        and the K-window energies are taken on the unbiased system with
        the segment's last list. Window choices come from
        numpy.random.default_rng(seed + 12345), as in the JAX package, so
        the same energies give the same windows. ``generator`` (a
        torch.Generator) draws the MD noise; ``noise``, a callable of the
        global step number, replaces it (run_chunk). Returns the final
        System: the input's atoms, interactions and box with the last
        coordinates and velocities (the JAX package's docstring promises
        the last window's lambda; its code, which this follows, keeps the
        input's atoms)."""
        rng = np.random.default_rng(seed + 12345)
        st = self.state
        space = st.space
        n_iter = int(n_steps) // self.n_md_steps
        base_general = sys.general_inters
        finder = sys.neighbor_finder

        for iteration_n in range(1, n_iter + 1):
            active = st.active_idx
            biased = space.apply_state(sys, active)
            sim_k = space.integrator_for(self.simulator, active)
            nbs = find_neighbors(finder, biased.coords, biased.boundary,
                                 biased.exclusions, self.current_step)
            aux = sim_k.init_aux(biased, nbs)
            biased, nbs, aux, _ = run_chunk(
                sim_k, biased, nbs, aux, self.current_step, self.n_md_steps,
                generator=generator, noise=noise)
            self.current_step += self.n_md_steps
            # strip the bias, keep coordinates and velocities
            sys = sys.update(coords=biased.coords,
                             velocities=biased.velocities,
                             general_inters=base_general)

            energies = space.state_energies(sys, nbs).cpu().numpy()
            vol = float(sys.boundary.volume())
            active_pe = self._process_sample(energies, volume=vol)

            if self.pmf is not None:
                w_fac = 1.0
                if st.covering_stage:
                    w_fac = st.ref_size / (st.ref_size + float(self.update_freq))
                betas = space.betas()
                press = space.pressures()
                self.pmf.update(
                    st, sys, weight_factor=w_fac,
                    potential_energy=active_pe,
                    box_volume=vol,
                    current_beta=float(betas[active]),
                    current_pressure=(float(press[active])
                                      if np.isfinite(press[active]) else 0.0))

            st.active_idx = self._gibbs_sample_window(rng)
            self._update_bias(iteration_n)
        return sys

    def free_energies(self):
        """Current per-window free-energy estimate in kBT units, gauged to
        window 0."""
        return self.state.f.copy()


# -- CV-grid flattening driver -------------------------------------------------


def interp(x, xp, fp):
    """jnp.interp in torch: fp linearly interpolated at x on the increasing
    knots xp, held at fp[0] below xp[0] and at fp[-1] above xp[-1] (zero
    gradient there); a knot interval narrower than the spacing of eps takes
    its left value."""
    flat = x.reshape(-1)
    i = torch.clamp(torch.searchsorted(xp, flat.detach(), right=True), 1,
                    xp.shape[0] - 1)
    dx = xp[i] - xp[i - 1]
    eps = np.finfo(str(xp.dtype).removeprefix("torch.")).eps
    dx0 = dx.abs() <= float(np.spacing(eps))
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (flat - xp[i - 1])
                    / torch.where(dx0, torch.ones_like(dx), dx)
                    * (fp[i] - fp[i - 1]))
    f = torch.where(flat < xp[0], fp[0], f)
    f = torch.where(flat > xp[-1], fp[-1], f)
    return f.reshape(x.shape)


@dataclasses.dataclass(frozen=True)
class GridBias(GeneralInteraction):
    """Bias energy interpolated linearly on a CV grid (differentiable)."""

    cv: object = None
    centers: torch.Tensor = None
    values: torch.Tensor = None

    def energy(self, coords, boundary, atoms):
        x = self.cv.value(coords, boundary)
        return interp(x, self.centers.to(x), self.values.to(x))


@dataclasses.dataclass
class GridAWHState:
    """Wang-Landau-style CV-grid state (compact adaptive-bias variant)."""

    centers: np.ndarray
    f_est: np.ndarray            # kJ/mol estimate of F(cv)
    hist: np.ndarray             # visits since last update-size change
    update_size: float           # kJ/mol per visit (shrinks over time)
    n_updates: int = 0
    covering_stage: bool = True

    @classmethod
    def create(cls, lo, hi, n_bins, initial_update=1.0):
        edges = np.linspace(lo, hi, n_bins + 1)
        centers = 0.5 * (edges[:-1] + edges[1:])
        return cls(centers=centers, f_est=np.zeros(n_bins),
                   hist=np.zeros(n_bins), update_size=initial_update)


@dataclasses.dataclass(frozen=True)
class GridAWH:
    """Adaptive-bias flattening on a CV grid: MD segments through simulate
    alternate with host Wang-Landau updates. A compact single-walker
    alternative to the windowed AWHSimulation for continuous CVs."""

    cv: object
    simulator: object
    temperature: float
    lo: float
    hi: float
    n_bins: int = 40
    n_steps_per_update: int = 100
    initial_update: float = 1.0
    flatness_threshold: float = 0.7

    def simulate(self, sys, n_updates, state=None, generator=None,
                 noise=None):
        """Returns (final System, GridAWHState). The applied bias is -f_est,
        so sampling flattens as f_est converges to the PMF. Each update
        runs simulate afresh (which removes the centre-of-mass motion, as
        the JAX package's does); ``generator`` draws its noise, or
        ``noise``, a callable (update, step_n) -> the step's draws,
        replaces it."""
        if state is None:
            state = GridAWHState.create(self.lo, self.hi, self.n_bins,
                                        self.initial_update)
        base_general = sys.general_inters
        dtype, dev = sys.coords.dtype, sys.device
        for u in range(n_updates):
            bias = GridBias(cv=self.cv,
                            centers=torch.as_tensor(state.centers,
                                                    dtype=dtype, device=dev),
                            values=torch.as_tensor(-state.f_est, dtype=dtype,
                                                   device=dev))
            biased = sys.update(general_inters=base_general + (bias,))
            step_noise = (None if noise is None else
                          lambda step_n, u=u: noise(u, step_n))
            biased, _, _ = simulate(biased, self.simulator,
                                    self.n_steps_per_update,
                                    generator=generator, noise=step_noise)
            sys = biased.update(general_inters=base_general)
            cv_val = float(self.cv.value(sys.coords, sys.boundary))
            x = (cv_val - self.lo) / (self.hi - self.lo) * self.n_bins
            b = int(np.clip(np.floor(x), 0, self.n_bins - 1))
            state.hist[b] += 1
            state.f_est[b] += state.update_size
            state.f_est -= state.f_est.min()
            state.n_updates += 1
            # stage control: halve the update size when the histogram is
            # sufficiently flat (initial stage), then switch to 1/t decay
            if state.covering_stage:
                visited = state.hist[state.hist > 0]
                if (len(visited) > self.n_bins * 0.6
                        and visited.min() > self.flatness_threshold
                        * state.hist.mean()):
                    state.update_size *= 0.5
                    state.hist[:] = 0
                    if state.update_size < KB * self.temperature * 0.05:
                        state.covering_stage = False
            else:
                state.update_size = self.initial_update / max(state.n_updates, 1)
        return sys, state

    def pmf(self, state):
        """Current PMF estimate (min-shifted)."""
        return state.centers, state.f_est - state.f_est.min()
