"""Collective variables with autograd gradients (counterpart of
mollytpu/free_energy/cv.py).

Each CV is a small frozen dataclass with ``value(coords, boundary) -> 0-d
tensor``, written with torch operations on the coordinates' device, and
``cv_gradient`` is torch.autograd.grad of it: exact for every CV, RMSD
through the Kabsch SVD included (whose gradient is undefined where two
singular values coincide). Index groups are int64 tensors, masses tensors;
both follow the coordinates to their device.
"""

from __future__ import annotations

import dataclasses

import torch


def _on(x, coords, dtype=None):
    """A group's tensor on the coordinates' device (and ``dtype``)."""
    return torch.as_tensor(x).to(device=coords.device, dtype=dtype)


def _smooth_min(d, beta):
    return -torch.logsumexp(-beta * d, dim=0) / beta


def _norm(dr):
    return torch.sqrt(torch.sum(dr * dr, dim=-1) + 1e-24)


def _group_distances(cv, coords, boundary):
    """(n1, n2) minimum-image distances between the two groups."""
    c1 = coords[_on(cv.group1, coords)]
    c2 = coords[_on(cv.group2, coords)]
    return _norm(boundary.displacement(c1[:, None, :], c2[None, :, :]))


@dataclasses.dataclass(frozen=True)
class CalcSingleDist:
    """Minimum-image distance between two atoms."""

    i: int
    j: int

    def value(self, coords, boundary):
        return _norm(boundary.displacement(coords[self.i], coords[self.j]))


@dataclasses.dataclass(frozen=True)
class CalcDist:
    """Mean pairwise distance between two index groups."""

    group1: torch.Tensor = None
    group2: torch.Tensor = None

    def value(self, coords, boundary):
        return torch.mean(_group_distances(self, coords, boundary))


@dataclasses.dataclass(frozen=True)
class CalcMinDist(CalcDist):
    """Smooth minimum distance between two groups, -logsumexp(-beta d) /
    beta (beta -> inf recovers the hard minimum)."""

    beta: float = 200.0

    def value(self, coords, boundary):
        d = _group_distances(self, coords, boundary)
        return _smooth_min(d.reshape(-1), self.beta)


@dataclasses.dataclass(frozen=True)
class CalcMaxDist(CalcDist):
    """Smooth maximum distance between two groups."""

    beta: float = 200.0

    def value(self, coords, boundary):
        d = _group_distances(self, coords, boundary)
        return -_smooth_min(-d.reshape(-1), self.beta)


@dataclasses.dataclass(frozen=True)
class CalcCMDist:
    """Distance between the mass-weighted centres of two groups."""

    group1: torch.Tensor = None
    group2: torch.Tensor = None
    masses1: torch.Tensor = None
    masses2: torch.Tensor = None

    def value(self, coords, boundary):
        m1 = _on(self.masses1, coords, coords.dtype)
        m2 = _on(self.masses2, coords, coords.dtype)
        c1 = torch.sum(coords[_on(self.group1, coords)] * m1[:, None],
                       dim=0) / torch.sum(m1)
        c2 = torch.sum(coords[_on(self.group2, coords)] * m2[:, None],
                       dim=0) / torch.sum(m2)
        return _norm(boundary.displacement(c1, c2))


@dataclasses.dataclass(frozen=True)
class CalcRg:
    """Mass-weighted radius of gyration of a group (no minimum image, as
    in the JAX package)."""

    group: torch.Tensor = None
    masses: torch.Tensor = None

    def value(self, coords, boundary):
        c = coords[_on(self.group, coords)]
        m = _on(self.masses, coords, coords.dtype)
        com = torch.sum(c * m[:, None], dim=0) / torch.sum(m)
        d2 = torch.sum((c - com) ** 2, dim=1)
        return torch.sqrt(torch.sum(m * d2) / torch.sum(m))


@dataclasses.dataclass(frozen=True)
class CalcRMSD:
    """RMSD of a group to an (M, 3) reference after Kabsch superposition."""

    reference: torch.Tensor = None
    group: torch.Tensor = None

    def value(self, coords, boundary):
        p = coords[_on(self.group, coords)]
        q = _on(self.reference, coords, coords.dtype)
        p = p - torch.mean(p, dim=0)
        q = q - torch.mean(q, dim=0)
        u, _, vt = torch.linalg.svd(p.T @ q)
        d = torch.sign(torch.linalg.det(u @ vt))
        flip = torch.stack([torch.ones_like(d), torch.ones_like(d), d])
        rot = (u * flip[None, :]) @ vt
        p_rot = p @ rot
        return torch.sqrt(torch.mean(torch.sum((p_rot - q) ** 2, dim=1))
                          + 1e-24)


@dataclasses.dataclass(frozen=True)
class CalcTorsion:
    """Signed dihedral angle between the planes (i, j, k) and (j, k, l):
    atan2 of the JAX package's (x, y) pair (mollytpu/ops/bonded.py:67)."""

    i: int
    j: int
    k: int
    l: int

    def value(self, coords, boundary):
        b1 = boundary.displacement(coords[self.i], coords[self.j])
        b2 = boundary.displacement(coords[self.j], coords[self.k])
        b3 = boundary.displacement(coords[self.k], coords[self.l])
        c1 = torch.linalg.cross(b1, b2)
        c2 = torch.linalg.cross(b2, b3)
        x = torch.dot(c1, c2)
        y = torch.dot(torch.linalg.cross(c1, c2), b2) / _norm(b2)
        return torch.atan2(y, x)


def cv_gradient(cv, coords, boundary):
    """dCV/dcoords, (N, 3), by torch.autograd."""
    with torch.enable_grad():
        x = coords.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(cv.value(x, boundary), x)
    return grad
