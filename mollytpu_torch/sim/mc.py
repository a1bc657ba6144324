"""Metropolis Monte Carlo in configuration space (counterpart of
mollytpu/sim/mc.py:25-90).

Each move displaces one random atom (``random_uniform_translation`` or
``random_normal_translation``), wraps the trial into the box, takes the
potential energy of the whole trial and accepts it on exp(-dU / kB T),
by ``torch.where`` on the device: a run reads nothing on the host until it
ends. A trial move takes (generator, coords, boundary); the atom index and
the displacement can be injected (``moves``), and so can the acceptance
uniforms (``uniforms``), so that a test replays the JAX package's keys.

The JAX package's neighbor argument is kept: one table, built by the
caller, serves the whole run. Unlike the JAX package, the run checks that
table at its end against one built at the final coordinates, and raises
StaleNeighborList if a pair inside the cutoff is missing from it.
"""

from __future__ import annotations

import dataclasses

import torch

from ..forces import potential_energy
from ..units import KB
from .simulate import list_check, list_cutoff, raise_if_overflow, \
    raise_if_stale


def _move_one(coords, index, delta):
    """coords with row ``index`` displaced by ``delta`` (functional)."""
    return coords.index_add(0, index.reshape(1).to(torch.int64),
                            delta.reshape(1, -1).to(coords.dtype))


def _random_index(generator, coords):
    return torch.randint(0, coords.shape[0], (), generator=generator,
                         device=coords.device)


def random_uniform_translation(shift_size=0.1):
    """Move one random atom by U(-shift, shift) per axis."""

    def move(generator, coords, boundary, index=None, delta=None):
        if index is None:
            index = _random_index(generator, coords)
        if delta is None:
            delta = (2.0 * torch.rand(
                coords.shape[1], generator=generator, dtype=coords.dtype,
                device=coords.device) - 1.0) * shift_size
        return _move_one(coords, index, delta)

    return move


def random_normal_translation(shift_size=0.05):
    """Move one random atom by N(0, shift^2) per axis."""

    def move(generator, coords, boundary, index=None, delta=None):
        if index is None:
            index = _random_index(generator, coords)
        if delta is None:
            delta = shift_size * torch.randn(
                coords.shape[1], generator=generator, dtype=coords.dtype,
                device=coords.device)
        return _move_one(coords, index, delta)

    return move


@dataclasses.dataclass(frozen=True)
class MetropolisMonteCarlo:
    temperature: float
    trial_move: object = None

    def __post_init__(self):
        if self.trial_move is None:
            object.__setattr__(self, "trial_move",
                               random_uniform_translation())

    def simulate(self, sys, n_steps, generator=None, neighbors=None,
                 moves=None, uniforms=None):
        """Returns (final System, {"energies" (n_steps,), "accepted",
        "acceptance_rate"}), tensors on the device. ``moves`` is an
        optional step -> (atom index, displacement) and ``uniforms`` an
        optional step -> the acceptance uniform, each replacing the
        generator's draw. Raises StaleNeighborList if ``neighbors`` went
        stale."""
        if generator is None:
            generator = torch.Generator(device=sys.device).manual_seed(0)
        kt = KB * self.temperature
        coords = sys.coords
        e_cur = potential_energy(sys, neighbors)
        n_acc = torch.zeros((), dtype=torch.int32, device=sys.device)
        energies = []
        for step in range(n_steps):
            trial = self.trial_move(generator, coords, sys.boundary,
                                    *(moves(step) if moves else ()))
            trial = sys.boundary.wrap(trial)
            e_trial = potential_energy(sys.update(coords=trial), neighbors)
            u = (uniforms(step) if uniforms is not None else torch.rand(
                (), generator=generator, dtype=coords.dtype,
                device=sys.device))
            accept = u < torch.exp(torch.clamp(-(e_trial - e_cur) / kt,
                                               max=0.0))
            coords = torch.where(accept, trial, coords)
            e_cur = torch.where(accept, e_trial, e_cur)
            n_acc = n_acc + accept.to(torch.int32)
            energies.append(e_cur)
        final = sys.update(coords=coords)
        if neighbors is not None:
            cutoff = list_cutoff(final)
            closest, overflow = list_check(final, neighbors, cutoff)
            if overflow is not None:
                raise_if_overflow(torch.maximum(overflow, neighbors.overflow),
                                  n_steps)
            raise_if_stale(closest, cutoff)
        return final, {
            "energies": (torch.stack(energies) if energies
                         else coords.new_zeros((0,))),
            "accepted": n_acc, "acceptance_rate": n_acc / n_steps}
