"""Energy minimization (counterpart of mollytpu/sim/minimize.py).

Adaptive-step steepest descent: each iteration moves every atom along its
force by at most ``step`` nm, projects the move back onto the constraints
(SHAKE with no velocities), and keeps it if the energy fell; the step grows
by 1.2 on acceptance and halves on rejection. A fixed number of iterations
with an early-converged mask, decided on the device by ``torch.where``, so
the loop never waits for the host. One neighbor list serves the whole run;
the stale-list check at its end raises as ``run_chunk`` does.
"""

from __future__ import annotations

import dataclasses

import torch

from ..forces import forces_virial, potential_energy
from ..ops.neighbors import find_neighbors
from .simulate import (list_check, list_cutoff, raise_if_overflow,
                       raise_if_stale)


@dataclasses.dataclass(frozen=True)
class SteepestDescentMinimizer:
    step_size: float = 0.01      # nm, initial largest displacement
    max_steps: int = 100
    tol: float = 100.0           # kJ/mol/nm, largest force at convergence

    def minimize(self, sys, neighbors=None):
        """Returns (minimized System, info): energy_initial, energy_final,
        converged, the (max_steps,) energies after each iteration, and the
        closest unlisted atom pair at the end (nm). Builds the list from
        the system's finder when ``neighbors`` is None."""
        if neighbors is None:
            neighbors = find_neighbors(sys.neighbor_finder, sys.coords,
                                       sys.boundary, sys.exclusions)
        coords = sys.coords
        step = torch.full((), self.step_size, dtype=coords.dtype,
                          device=coords.device)
        e0 = e_prev = potential_energy(sys, neighbors)
        done = torch.zeros((), dtype=torch.bool, device=coords.device)
        energies = []
        for _ in range(self.max_steps):
            f, _ = forces_virial(sys.update(coords=coords), neighbors)
            max_f = torch.linalg.vector_norm(f, dim=1).max()
            trial = coords + step * f / torch.clamp(max_f, min=1e-12)
            for c in sys.constraints:
                trial, _ = c.apply_position_constraints(
                    coords, trial, None, sys.masses, sys.boundary, 1.0)
            trial = sys.boundary.wrap(trial)
            e_trial = potential_energy(sys.update(coords=trial), neighbors)
            accept = (e_trial < e_prev) & ~done
            coords = torch.where(accept, trial, coords)
            e_prev = torch.where(accept, e_trial, e_prev)
            step = torch.where(done, step, torch.where(accept, step * 1.2,
                                                       step * 0.5))
            done = done | (max_f < self.tol)
            energies.append(e_prev)
        closest = (_closest_unlisted(sys, neighbors, coords, self.max_steps)
                   if neighbors is not None else float("inf"))
        return sys.update(coords=coords), {
            "energy_initial": e0, "energy_final": e_prev, "converged": done,
            "energies": torch.stack(energies) if energies else e0[None],
            "closest_unlisted": closest}


def _closest_unlisted(sys, neighbors, coords, n_iterations):
    """The stale-list check of run_chunk at the final coordinates."""
    cutoff = list_cutoff(sys)
    near, over = list_check(sys.update(coords=coords), neighbors, cutoff)
    if over is not None:
        raise_if_overflow(torch.maximum(neighbors.overflow, over),
                          n_iterations)
    return raise_if_stale(near, cutoff)
