"""LINCS, the linear constraint solver (counterpart of mollytpu/ops/lincs.py).

LINCS (Hess et al., J. Comput. Chem. 18, 1463 (1997)) projects onto the
constraints with a truncated series for (I - A)^-1 in the coupling matrix
A, then corrects for rotation ``n_iters`` times. Each constraint couples
with the few that share one of its atoms: a fixed-width (K, C) table of
neighbour constraints (``nbr``, padded with K, which points at a zero row)
and coupling coefficients (``coef``), so one series term is a gather and a
multiply-add over (K, C). The corrections reach the atoms through one
``index_add_`` per projection.

LINCS does not converge on closed triangles (rigid water, angle
constraints): ``setup_constraints`` with ``algorithm="lincs"`` keeps those
on SHAKE.

The tables are in the dtype the builder is given, the system's: the JAX
package casts them to float32 whatever the system's dtype
(mollytpu/ops/lincs.py:93-99), so in float64 its target lengths are the
float32 roundings (0.09572 nm by 7e-10 nm). Built with
dtype=torch.float32 the port's tables are JAX's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import resolve_device
from .constraints import constraint_virial


@dataclasses.dataclass(frozen=True)
class LINCS:
    """All distance constraints with their coupling table."""

    idx_i: torch.Tensor     # (K,) int64
    idx_j: torch.Tensor     # (K,) int64
    dists: torch.Tensor     # (K,)
    sdiag: torch.Tensor     # (K,) 1 / sqrt(1/m_i + 1/m_j)
    inv_m_i: torch.Tensor   # (K,)
    inv_m_j: torch.Tensor   # (K,)
    nbr: torch.Tensor       # (K, C) int64, padding K
    coef: torch.Tensor      # (K, C)
    order: int = 4
    n_iters: int = 2

    @property
    def n_constraints(self) -> int:
        return int(self.idx_i.shape[0])

    @classmethod
    def build(cls, pairs, dists, masses, order=4, n_iters=2,
              dtype=torch.float32, device=None):
        """pairs (K, 2) atom indices, dists (K,) and masses (N,): the
        coupling table on the host (mollytpu/ops/lincs.py:57-106)."""
        device = resolve_device(device)
        pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        dists = np.asarray(dists, dtype=np.float64).reshape(-1)
        if isinstance(masses, torch.Tensor):
            masses = masses.detach().cpu().numpy()
        masses = np.asarray(masses, dtype=np.float64)
        k = pairs.shape[0]
        positive = masses > 0
        inv_m = np.where(positive, 1.0 / np.where(positive, masses, 1.0),
                         0.0)
        im_i, im_j = inv_m[pairs[:, 0]], inv_m[pairs[:, 1]]
        sdiag = 1.0 / np.sqrt(im_i + im_j)
        by_atom = {}
        for c, (i, j) in enumerate(pairs):
            by_atom.setdefault(int(i), []).append(c)
            by_atom.setdefault(int(j), []).append(c)
        links = [[] for _ in range(k)]
        for atom, members in by_atom.items():
            for a in members:
                for b in members:
                    if a != b:
                        # +1 when the shared atom has the same role (i or
                        # j) in both constraints, else -1
                        same = (pairs[a, 0] == atom) == (pairs[b, 0] == atom)
                        links[a].append((b, (1.0 if same else -1.0)
                                         * inv_m[atom]))
        width = max(1, max((len(x) for x in links), default=1))
        nbr = np.full((k, width), k, dtype=np.int64)
        coef = np.zeros((k, width))
        for a, row in enumerate(links):
            for c, (b, w) in enumerate(row):
                nbr[a, c] = b
                # A = I - S B^T M^-1 B S: the series takes the negated
                # normalised coupling
                coef[a, c] = -sdiag[a] * sdiag[b] * w

        def t(x, kind=dtype):
            return torch.as_tensor(x, dtype=kind, device=device)
        return cls(t(pairs[:, 0], torch.int64), t(pairs[:, 1], torch.int64),
                   t(dists), t(sdiag), t(im_i), t(im_j),
                   t(nbr, torch.int64), t(coef), order=order,
                   n_iters=n_iters)

    def _coupling(self, b):
        """coef * (b_k . b_l) for each listed neighbour l of k."""
        bpad = torch.cat([b, torch.zeros_like(b[:1])])
        return self.coef * (b[:, None, :] * bpad[self.nbr]).sum(dim=-1)

    def _series_solve(self, abb, rhs):
        """sum_{p=0..order} A^p rhs, (A v)[k] = sum_c abb[k, c] v[nbr]."""
        acc, v = rhs, rhs
        zero = torch.zeros_like(rhs[:1])
        for _ in range(self.order):
            v = (abb * torch.cat([v, zero])[self.nbr]).sum(dim=1)
            acc = acc + v
        return acc

    def _apply_lambda(self, x, lam, b):
        """x moved by the multipliers lam along the directions b: -lam/m_i
        onto i, +lam/m_j onto j."""
        corr = torch.cat([-(lam * self.inv_m_i)[:, None] * b,
                          (lam * self.inv_m_j)[:, None] * b])
        return x.index_add(0, torch.cat([self.idx_i, self.idx_j]), corr)

    def apply_position_constraints(self, coords_prev, coords_new, vels,
                                   masses, boundary, dt):
        """coords_new projected onto the constraints along the pre-step
        directions, with n_iters rotation corrections; velocities get the
        implied dx / dt. Returns (coords, vels)."""
        if self.n_constraints == 0:
            return coords_new, vels
        ii, jj, d0 = self.idx_i, self.idx_j, self.dists
        r_ref = boundary.displacement(coords_prev[jj], coords_prev[ii])
        b = r_ref / torch.linalg.vector_norm(r_ref, dim=1, keepdim=True)
        abb = self._coupling(b)

        def solve(coords, rhs):
            lam = self.sdiag * self._series_solve(abb, rhs)
            return self._apply_lambda(coords, lam, b)

        dr = boundary.displacement(coords_new[jj], coords_new[ii])
        coords = solve(coords_new, self.sdiag * ((b * dr).sum(dim=1) - d0))
        for _ in range(self.n_iters):
            # aim at sqrt(2 d0^2 - len^2) to undo the lengthening that the
            # rotation of a constraint brings (Hess 1997, eq. 10)
            dr = boundary.displacement(coords[jj], coords[ii])
            p = torch.sqrt(torch.clamp(2.0 * d0 * d0 - (dr * dr).sum(dim=1),
                                       min=0.0))
            coords = solve(coords, self.sdiag * (d0 - p))
        if vels is not None:
            vels = vels + (coords - coords_new) / dt
        return coords, vels

    def apply_velocity_constraints(self, coords, vels, masses, boundary):
        """The velocities without their components along the constraints
        (the LINCS projection, RATTLE's counterpart)."""
        if self.n_constraints == 0:
            return vels
        ii, jj = self.idx_i, self.idx_j
        dr = boundary.displacement(coords[jj], coords[ii])
        b = dr / torch.linalg.vector_norm(dr, dim=1, keepdim=True)
        rhs = self.sdiag * (b * (vels[ii] - vels[jj])).sum(dim=1)
        lam = self.sdiag * self._series_solve(self._coupling(b), rhs)
        return self._apply_lambda(vels, lam, b)

    def constraint_virial(self, coords_prev, coords_new_unconstrained,
                          coords_constrained, masses, boundary, dt):
        """The virial of the constraint forces, as SHAKERattle's
        (mollytpu/ops/lincs.py:183-187). No integrator reads it."""
        return constraint_virial(coords_new_unconstrained,
                                 coords_constrained, masses, dt)

    def max_violation(self, coords, boundary):
        dr = boundary.displacement(coords[self.idx_j], coords[self.idx_i])
        r = torch.linalg.vector_norm(dr, dim=1)
        return torch.max(torch.abs(r - self.dists))
