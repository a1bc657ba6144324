"""CMAP correction-map torsions, CHARMM's five-atom (phi, psi) grid terms
(counterpart of mollytpu/ops/cmap.py).

The energy is a bicubic interpolation of a periodic (phi, psi) grid: node
derivatives from periodic cubic splines, then per cell the 16 coefficients
of the bicubic patch (``cmap_coefficients``, on the host in float64, the
JAX package's numpy code). A CMAP list is a bonded list of kind
"cmap_torsion_<n>" (n the grid size) with one row per (a, b, c, d, e)
chain: phi is the dihedral of (a, b, c, d), psi that of (b, c, d, e). Its
term locates the cell of (phi, psi), gathers the cell's 4 x 4 block and
evaluates the polynomial; the gradient is written by hand, dE/dphi and
dE/dpsi along the two dihedrals' geometry gradients (the cell index is a
rounding, with zero gradient, as under JAX's autodiff).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import resolve_device
from .bonded import TERM_FUNCS, SpecificList, _dihedral


def _periodic_spline_derivs(y):
    """dy/dx at the nodes of the periodic cubic spline through y, samples
    of a uniform grid of spacing 2 pi / n."""
    n = y.shape[0]
    h = 2.0 * np.pi / n
    # cyclic tridiagonal system d_{i-1} + 4 d_i + d_{i+1}
    #   = 3 (y_{i+1} - y_{i-1}) / h
    A = np.zeros((n, n))
    rhs = np.zeros(n)
    for i in range(n):
        A[i, (i - 1) % n] = 1.0
        A[i, i] = 4.0
        A[i, (i + 1) % n] = 1.0
        rhs[i] = 3.0 * (y[(i + 1) % n] - y[(i - 1) % n]) / h
    return np.linalg.solve(A, rhs)


#: the Hermite basis: c = M F M^T for the cell's data matrix F
_HERMITE = np.array([
    [1.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, 1.0, 0.0],
    [-3.0, 3.0, -2.0, -1.0],
    [2.0, -2.0, 1.0, 1.0],
])


def cmap_coefficients(grid):
    """(n, n, 4, 4) bicubic patch coefficients of a periodic (n, n) energy
    grid: in cell (i, j), E(t, u) = sum_ab c[i, j, a, b] t^a u^b with t, u
    in [0, 1) the fractions along phi (first index) and psi."""
    grid = np.asarray(grid, dtype=np.float64)
    n = grid.shape[0]
    h = 2.0 * np.pi / n
    dphi = np.stack([_periodic_spline_derivs(grid[:, j]) for j in range(n)],
                    axis=1)
    dpsi = np.stack([_periodic_spline_derivs(grid[i, :]) for i in range(n)],
                    axis=0)
    dcross = np.stack([_periodic_spline_derivs(dpsi[:, j])
                       for j in range(n)], axis=1)
    coeffs = np.zeros((n, n, 4, 4))
    for i in range(n):
        i1 = (i + 1) % n
        for j in range(n):
            j1 = (j + 1) % n
            # values and psi derivatives; phi derivatives and the cross
            # derivative, scaled to the unit cell
            F = np.array([
                [grid[i, j], grid[i, j1], h * dpsi[i, j], h * dpsi[i, j1]],
                [grid[i1, j], grid[i1, j1], h * dpsi[i1, j],
                 h * dpsi[i1, j1]],
                [h * dphi[i, j], h * dphi[i, j1], h * h * dcross[i, j],
                 h * h * dcross[i, j1]],
                [h * dphi[i1, j], h * dphi[i1, j1], h * h * dcross[i1, j],
                 h * h * dcross[i1, j1]],
            ])
            coeffs[i, j] = _HERMITE @ F @ _HERMITE.T
    return coeffs


def _powers(t):
    """(1, t, t^2, t^3) and their derivatives, each (K, 4)."""
    one, zero = torch.ones_like(t), torch.zeros_like(t)
    return (torch.stack([one, t, t * t, t * t * t], dim=1),
            torch.stack([zero, one, 2.0 * t, 3.0 * t * t], dim=1))


def _cmap_term(coeff_table, n_grid):
    """The term function of a CMAP kind over ``coeff_table`` (n_maps, n, n,
    4, 4), a float64 host array, kept on each device and dtype it meets."""
    table = torch.as_tensor(np.asarray(coeff_table, dtype=np.float64))
    on_device = {}
    h = 2.0 * math.pi / n_grid

    def term(x, boundary, p, grad):
        key = (x.device, x.dtype)
        if key not in on_device:
            on_device[key] = table.to(device=x.device, dtype=x.dtype)
        coeffs = on_device[key]
        phi, g_phi = _dihedral(x[:, 0:4], boundary, grad)
        psi, g_psi = _dihedral(x[:, 1:5], boundary, grad)
        gphi = (phi + math.pi) / h
        gpsi = (psi + math.pi) / h
        i0 = torch.floor(gphi).long().clamp(0, n_grid - 1)
        j0 = torch.floor(gpsi).long().clamp(0, n_grid - 1)
        tv, dtv = _powers(gphi - i0)
        uv, duv = _powers(gpsi - j0)
        block = coeffs[p["map_index"].long(), i0, j0]           # (K, 4, 4)
        cu = (block @ uv[:, :, None])[:, :, 0]                  # (K, 4)
        e = (tv * cu).sum(dim=1)
        if not grad:
            return e, None
        de_dphi = (dtv * cu).sum(dim=1) / h
        de_dpsi = (tv[:, None, :] @ block @ duv[:, :, None])[:, 0, 0] / h
        g = torch.zeros_like(x)
        g[:, 0:4] += de_dphi[:, None, None] * g_phi
        g[:, 1:5] += de_dpsi[:, None, None] * g_psi
        return e, g

    return term


def register_cmap(coeff_table, n_grid):
    """Register the kind "cmap_torsion_<n_grid>" over ``coeff_table`` and
    return its name. A later table of the same grid size replaces the
    kind's, as in the JAX package."""
    kind = f"cmap_torsion_{n_grid}"
    TERM_FUNCS[kind] = _cmap_term(coeff_table, n_grid)
    return kind


def make_cmap_list(i, j, k, l, m, map_index, coeff_table, n_grid,
                   dtype=torch.float32, device=None):
    """The CMAP terms of the chains (i, j, k, l, m), each on its map of
    ``coeff_table`` (n_maps, n, n, 4, 4), as a SpecificList."""
    device = resolve_device(device)
    idx = torch.stack([torch.as_tensor(np.asarray(c), dtype=torch.int64,
                                       device=device).reshape(-1)
                       for c in (i, j, k, l, m)], dim=1)
    params = {"map_index": torch.as_tensor(np.asarray(map_index),
                                           dtype=torch.int64,
                                           device=device).reshape(-1),
              "weight": torch.ones(idx.shape[0], dtype=dtype,
                                   device=device)}
    return SpecificList(register_cmap(coeff_table, n_grid), idx, params)
