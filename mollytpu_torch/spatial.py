"""Velocity sampling, kinetic energy, centre-of-mass motion, pressure and
barostat scaling (counterpart of mollytpu/spatial.py:18-125).

Random numbers come from an explicit ``torch.Generator``; its stream is not
jax.random's, so tests compare distributions, not samples.

Molecule centres differ from the JAX package's on purpose: it averages the
wrapped coordinates, so a molecule straddling a periodic face gets a
centre inside the box between its pieces, and its barostat scaling then
stretches the molecule's minimum-image bonds by (mu - 1) L; here each
molecule is first made whole by minimum image relative to its first atom
and moves rigidly (ROADMAP Queue 3). The two agree wherever no molecule
straddles a face.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .units import KB


def random_velocity(mass, temp, generator, n_dims=3, dtype=torch.float32):
    """One Maxwell-Boltzmann velocity sample (nm/ps) of an atom of ``mass``,
    on the generator's device."""
    sigma = math.sqrt(KB * float(temp) / float(mass))
    return sigma * torch.randn((n_dims,), generator=generator, dtype=dtype,
                               device=generator.device)


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


def pressure_tensor(kinetic_tensor, virial_tensor, volume):
    """P = (2K + W) / V, tensor form; the virial is sum dr (x) f."""
    return (2.0 * kinetic_tensor + virial_tensor) / volume


def scalar_pressure(kinetic_tensor, virial_tensor, volume, n_dims=3):
    p = pressure_tensor(kinetic_tensor, virial_tensor, volume)
    return torch.trace(p) / n_dims


def scale_coords(boundary, coords, mu, velocities=None):
    """Scale the box and every atom by mu (a scalar, a (3,) per-axis tensor
    or a (3, 3) matrix); velocities, when given, by the inverse. Returns
    (boundary, coords) or (boundary, coords, velocities)."""
    mu = torch.as_tensor(mu, dtype=coords.dtype, device=coords.device)
    new_boundary = boundary.scale(mu)
    if mu.dim() == 2:
        new_coords = coords @ mu.T
        if velocities is not None:
            inv_mu, _ = torch.linalg.inv_ex(mu)
            new_vels = velocities @ inv_mu.T
    else:
        new_coords = coords * mu
        if velocities is not None:
            new_vels = velocities / mu
    if velocities is None:
        return new_boundary, new_coords
    return new_boundary, new_coords, new_vels


def _whole(coords, molecule_ids, n_molecules, boundary):
    """Coordinates with each molecule made whole: every atom at its minimum
    image from its molecule's first atom (the lowest index)."""
    n = coords.shape[0]
    first = torch.full((n_molecules,), n, dtype=torch.int64,
                       device=coords.device).scatter_reduce(
        0, molecule_ids, torch.arange(n, device=coords.device),
        reduce="amin")
    ref = coords[first[molecule_ids]]
    return ref + boundary.displacement(ref, coords)


def molecule_centers(coords, masses, molecule_ids, n_molecules,
                     boundary=None):
    """Mass-weighted centre of each molecule, (n_molecules, 3). With a
    ``boundary`` each molecule is made whole first, by minimum image
    relative to its first atom; without one the coordinates are averaged
    as they are, as the JAX package does."""
    ids = molecule_ids.to(torch.int64)
    if boundary is not None:
        coords = _whole(coords, ids, n_molecules, boundary)
    w = masses.to(coords.dtype)
    wsum = torch.zeros((n_molecules,), dtype=coords.dtype,
                       device=coords.device).index_add_(0, ids, w)
    cw = torch.zeros((n_molecules, coords.shape[1]), dtype=coords.dtype,
                     device=coords.device).index_add_(0, ids,
                                                      w[:, None] * coords)
    return cw / torch.clamp(wsum, min=1e-30)[:, None]


def scale_coords_molecular(boundary, coords, mu, masses, molecule_ids,
                           n_molecules):
    """Scale the box and the molecules' centres by mu and move each
    molecule rigidly with its centre. Molecules are made whole first, so
    one that straddles a face keeps its shape; its atoms may then lie up to
    the molecule's extent outside the new box, and the next step wraps
    them. Returns (boundary, coords)."""
    mu = torch.as_tensor(mu, dtype=coords.dtype, device=coords.device)
    ids = molecule_ids.to(torch.int64)
    whole = _whole(coords, ids, n_molecules, boundary)
    centers = molecule_centers(whole, masses, ids, n_molecules)
    new_centers = centers @ mu.T if mu.dim() == 2 else centers * mu
    return boundary.scale(mu), whole + (new_centers - centers)[ids]


def unwrap_molecules(coords, boundary, molecule_ids, bonds_i, bonds_j):
    """Molecules made whole across the periodic boundary by a breadth-first
    walk over the bonds, on the host (mollytpu/spatial.py:128-164): each
    bonded atom moves by whole box lengths to its partner's image. For
    trajectory writers and visualisation; returns a numpy (N, 3) float64
    array. ``molecule_ids`` is unused, as in the JAX package."""
    c = np.asarray(torch.as_tensor(coords).detach().cpu(),
                   dtype=np.float64).copy()
    sides = np.asarray(torch.as_tensor(boundary.side_lengths).detach().cpu(),
                       dtype=np.float64)
    periodic = np.isfinite(sides)
    safe = np.where(periodic, sides, 1.0)
    n = c.shape[0]
    adj = [[] for _ in range(n)]
    for i, j in zip(np.asarray(bonds_i), np.asarray(bonds_j)):
        adj[int(i)].append(int(j))
        adj[int(j)].append(int(i))
    seen = np.zeros(n, dtype=bool)
    for start in range(n):
        if seen[start]:
            continue
        seen[start] = True
        stack = [start]
        while stack:
            a = stack.pop()
            for b in adj[a]:
                if seen[b]:
                    continue
                d = c[b] - c[a]
                c[b] = c[b] - np.where(periodic,
                                       np.round(d / safe) * sides, 0.0)
                seen[b] = True
                stack.append(b)
    return c
