"""Plain reference of LAMMPS's bench/in.lj: one LJ species on an fcc
lattice, plain LJ truncated at the cutoff (lj/cut, no shift), every atom
pair closer than the cutoff from cell bins (reference/cells.py), float64
(or the TF32 control)."""

from __future__ import annotations

import numpy as np
import torch

from .cells import CellBins, padded, pair_mask


def fcc_lattice(n_cells, density, sigma):
    """(4 n_cells^3, 3) positions in nm and the cube's edge: LAMMPS's
    ``lattice fcc <density>`` with ``create_atoms`` over n_cells^3 cells,
    the basis (0,0,0), (1/2,1/2,0), (1/2,0,1/2), (0,1/2,1/2), cells in
    x-major order."""
    a = (4.0 / density) ** (1.0 / 3.0) * sigma
    basis = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5],
                      [0.0, 0.5, 0.5]])
    cells = np.stack(np.meshgrid(*[np.arange(n_cells)] * 3, indexing="ij"),
                     axis=-1).reshape(-1, 1, 3)
    return ((cells + basis[None]) * a).reshape(-1, 3), n_cells * a


class LJFcc:

    def __init__(self, cfg, prec, device):
        lj = cfg["lj"]
        self.prec, self.device = prec, device
        x, edge = fcc_lattice(lj["n_cells"], lj["density_reduced"],
                              lj["sigma_nm"])
        dt = prec.dtype
        self.n = x.shape[0]
        self.start = torch.as_tensor(x, dtype=dt, device=device)
        self.edges = np.array([edge] * 3)
        self.L = torch.as_tensor(self.edges, dtype=dt, device=device)
        self.sigma, self.eps = lj["sigma_nm"], lj["epsilon_kj_mol"]
        self.rc = lj["cutoff_reduced"] * lj["sigma_nm"]
        self.mass = torch.full((self.n,), float(lj["mass_u"]), dtype=dt,
                               device=device)

    def mic(self, d):
        return d - self.L * torch.round(d / self.L)

    def wrap(self, x):
        return x - torch.floor(x / self.L) * self.L

    def _pairs(self, x):
        """Per block of cells: the rows' indices, and for each neighbouring
        cell (d = x_j - x_i by the minimum image, marked for the
        precision, |d|^2, the pairs inside the cutoff)."""
        rnd, n, rc2 = self.prec.rnd, self.n, self.rc * self.rc
        xp = padded(x)
        for rows, tables in CellBins(x, self.edges, self.rc).blocks():
            def near(rows=rows, tables=tables):
                for cols in tables:
                    d = rnd(self.mic(xp[cols][:, None, :, :]
                                     - xp[rows][:, :, None, :]))
                    r2 = rnd((d * d).sum(-1))
                    yield d, r2, (r2 < rc2) & pair_mask(rows, cols, n)
            yield rows, near()

    def forces(self, x):
        x = x.to(self.prec.dtype)
        rnd, s2, eps = self.prec.rnd, self.sigma ** 2, self.eps
        out = torch.zeros((self.n + 1, 3), dtype=x.dtype, device=x.device)
        for rows, near in self._pairs(x):
            acc = torch.zeros(rows.shape + (3,), dtype=x.dtype,
                              device=x.device)
            for d, r2, keep in near:
                inv_r2 = rnd(1.0 / torch.where(keep, r2, torch.ones_like(r2)))
                s6 = rnd((s2 * inv_r2) ** 3)
                g = rnd(4.0 * eps * (6.0 * s6 - 12.0 * s6 * s6) * inv_r2)
                g = torch.where(keep, g, torch.zeros_like(g))
                acc = acc + (g[..., None] * d).sum(2)
            out[rows] = acc
        return rnd(out[:self.n])

    def energy(self, x):
        """The pair energy (kJ/mol): each pair once."""
        x = x.to(self.prec.dtype)
        rnd, s2, eps = self.prec.rnd, self.sigma ** 2, self.eps
        total = torch.zeros((), dtype=x.dtype, device=x.device)
        for _, near in self._pairs(x):
            for _, r2, keep in near:
                inv_r2 = rnd(1.0 / torch.where(keep, r2, torch.ones_like(r2)))
                s6 = rnd((s2 * inv_r2) ** 3)
                u = rnd(4.0 * eps * (s6 * s6 - s6))
                u = torch.where(keep, u, torch.zeros_like(u))
                total = total + 0.5 * u.sum()
        return total

    def pair_count(self, x):
        from roofline.count import count_pairs
        own = torch.arange(self.n, device=x.device)
        lj = torch.ones(self.n, dtype=torch.bool, device=x.device)
        return count_pairs(x.to(torch.float64), self.L.to(torch.float64),
                           self.rc, own, lj)
