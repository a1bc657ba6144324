"""Velocity sampling, kinetic energy and centre-of-mass motion
(counterpart of mollytpu/spatial.py:18-68).

Random numbers come from an explicit ``torch.Generator``; its stream is not
jax.random's, so tests compare distributions, not samples.
"""

from __future__ import annotations

import torch

from .units import KB


def random_velocities(masses, temp, generator, n_dims=3):
    """Maxwell-Boltzmann velocities (nm/ps) for every atom; zero-mass sites
    get zero velocity. The generator must live on the masses' device."""
    n = masses.shape[0]
    positive = masses > 0
    safe_m = torch.where(positive, masses, torch.ones_like(masses))
    sigma = torch.sqrt(KB * float(temp) / safe_m)
    noise = torch.randn((n, n_dims), generator=generator, dtype=masses.dtype,
                        device=masses.device)
    vels = sigma[:, None] * noise
    return torch.where(positive[:, None], vels, torch.zeros_like(vels))


def kinetic_energy(masses, velocities):
    return 0.5 * torch.sum(masses[:, None] * velocities * velocities)


def kinetic_energy_tensor(masses, velocities):
    """sum_i m_i v_i v_i^T / 2, a (3, 3) tensor."""
    mv = masses[:, None] * velocities
    return 0.5 * (mv.T @ velocities)


def temperature(masses, velocities, n_dof):
    """Instantaneous temperature 2K / (n_dof kB)."""
    return 2.0 * kinetic_energy(masses, velocities) / (n_dof * KB)


def n_dof(n_atoms, n_constraints=0, n_dims=3, remove_cm=True, n_frozen=0):
    """Degrees of freedom after constraints and centre-of-mass removal."""
    dof = n_dims * (n_atoms - n_frozen) - n_constraints
    if remove_cm:
        dof -= n_dims
    return dof


def remove_cm_motion(masses, velocities):
    """Subtract the mass-weighted mean velocity; zero-mass sites stay 0."""
    cm_v = torch.sum(masses[:, None] * velocities, dim=0) / torch.sum(masses)
    out = velocities - cm_v[None, :]
    return torch.where((masses > 0)[:, None], out, torch.zeros_like(out))
