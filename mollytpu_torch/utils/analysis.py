"""Trajectory analysis on tensors: displacements, distances, RMSD, radius
of gyration, hydrodynamic radius, RDF, dipole moment and MSD
(counterpart of mollytpu/utils/analysis.py)."""

from __future__ import annotations

import math

import numpy as np
import torch


def displacements(coords_a, coords_b, boundary):
    """Minimum-image displacement vectors between two frames (N, 3)."""
    return boundary.displacement(torch.as_tensor(coords_a),
                                 torch.as_tensor(coords_b))


def distances(coords, boundary):
    """All-pairs minimum-image distance matrix (N, N)."""
    c = torch.as_tensor(coords)
    diffs = tuple(c[:, k][None, :] - c[:, k][:, None] for k in range(3))
    return torch.sqrt(sum(x * x for x in boundary.mic_parts(diffs)))


def rmsd(coords, reference):
    """RMSD after Kabsch superposition of coords onto reference."""
    p = torch.as_tensor(coords)
    q = torch.as_tensor(reference)
    p = p - p.mean(dim=0)
    q = q - q.mean(dim=0)
    u, _, vt = torch.linalg.svd(p.T @ q)
    d = torch.sign(torch.linalg.det(u @ vt))
    flip = torch.stack([torch.ones_like(d), torch.ones_like(d), d])
    rot = (u * flip[None, :]) @ vt
    return torch.sqrt(torch.mean(torch.sum((p @ rot - q) ** 2, dim=1)))


def radius_gyration(coords, masses):
    c = torch.as_tensor(coords)
    m = torch.as_tensor(masses)
    com = torch.sum(c * m[:, None], dim=0) / torch.sum(m)
    return torch.sqrt(torch.sum(m * torch.sum((c - com) ** 2, dim=1))
                      / torch.sum(m))


def hydrodynamic_radius(coords, boundary):
    """R_h = N^2 / sum_{i != j} 1 / r_ij."""
    d = distances(coords, boundary)
    n = d.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=d.device)
    inv = torch.where(eye, torch.zeros_like(d),
                      1.0 / torch.where(eye, torch.ones_like(d), d))
    return n * n / torch.sum(inv)


def rdf(coords, boundary, n_bins=200, r_max=None):
    """Radial distribution function g(r) by histogram over the pairs i < j
    (r_max: half the smallest side length by default). Returns numpy
    (centers, g)."""
    c = torch.as_tensor(coords)
    n = c.shape[0]
    d = distances(c, boundary).detach().cpu().numpy()
    dv = d[np.triu_indices(n, k=1)]
    if r_max is None:
        r_max = float(boundary.side_lengths.min()) / 2.0
    hist, edges = np.histogram(dv, bins=n_bins, range=(0.0, r_max))
    centers = 0.5 * (edges[:-1] + edges[1:])
    rho = n / float(boundary.volume())
    shell = 4.0 * math.pi * centers ** 2 * (edges[1] - edges[0])
    norm = rho * shell * n * (n - 1) / 2.0 / n
    return centers, hist / np.maximum(norm, 1e-30)


def dipole_moment(coords, charges):
    """sum_i q_i r_i."""
    return torch.sum(torch.as_tensor(charges)[:, None]
                     * torch.as_tensor(coords), dim=0)


def msd(coords_series, boundary=None):
    """Mean squared displacement against the first frame of a (T, N, 3)
    stack."""
    x = torch.as_tensor(coords_series)
    d = x - x[0:1]
    return torch.mean(torch.sum(d * d, dim=-1), dim=-1)
