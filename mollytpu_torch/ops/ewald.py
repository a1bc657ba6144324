"""Smooth particle-mesh Ewald and the Ewald exclusion correction
(counterpart of mollytpu/ops/ewald.py:45-193, 370-425, 538-717).

The port carries the JAX package's scatter form of PME: charges spread
with ``index_add_``, ``torch.fft`` for the convolution and a stencil gather
for the forces. The dense one-hot matmul form of the JAX package exists for
the TPU's slow scatter and is not carried over. The exclusion correction is
the sparse pair form over the excluded and 1-4 pairs.

Sign conventions: energies in kJ/mol; virial W_ab = -dE/d(strain_ab),
matching the pair kernel's -(dU/dr / r) dr (x) dr.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..free_energy.alchemy import scaled_charge
from ..units import COULOMB_CONST


def ewald_error_alpha(dist_cutoff, error_tol=0.0005):
    """alpha = sqrt(-log(2 tol)) / rc (OpenMM convention)."""
    return math.sqrt(-math.log(2.0 * error_tol)) / dist_cutoff


def _smooth_size(n):
    """Smallest 2,3,5-smooth integer >= n (FFT-friendly mesh dims)."""
    def is_smooth(x):
        for p in (2, 3, 5):
            while x % p == 0:
                x //= p
        return x == 1

    while not is_smooth(n):
        n += 1
    return n


def pme_mesh_dims(side_lengths, alpha, error_tol, smooth=True):
    """ceil(2 alpha L / (3 tol^(1/5))), min 6, optionally rounded up to
    FFT-smooth sizes."""
    dims = []
    for L in np.asarray(side_lengths, dtype=np.float64):
        s = int(math.ceil(2.0 * alpha * float(L) / (3.0 * error_tol ** 0.2)))
        s = max(s, 6)
        dims.append(_smooth_size(s) if smooth else s)
    return tuple(dims)


@functools.lru_cache(maxsize=None)
def _mesh_tensor(mesh_dims, dtype, device):
    """The mesh dimensions as a (3,) tensor, built once per mesh, dtype and
    device: a tensor made from host values on each call would copy them to
    the card and sync the host."""
    return torch.tensor(mesh_dims, dtype=dtype, device=device)


def bspline_moduli(order, mesh_dims, dtype=np.float64):
    """|DFT of the cardinal B-spline|^2 per mesh dimension, near-zero
    entries patched by neighbour averaging as in OpenMM. Host-side."""
    data = np.zeros(order, dtype=np.float64)
    data[0] = 1.0
    for k in range(3, order + 1):
        d = 1.0 / (k - 1)
        new = np.zeros(order)
        new[k - 1] = 0.0
        for j in range(1, k - 1):
            new[k - 1 - j] = d * ((j) * data[k - 2 - j] + (k - j) * data[k - 1 - j])
        new[0] = d * data[0]
        data = new
    out = []
    for K in mesh_dims:
        m = np.arange(K)
        phases = np.exp(2j * np.pi * np.outer(m, np.arange(order)) / K)
        s = phases @ data
        mod = np.abs(s) ** 2
        eps = 1e-7 * mod.max()
        for i in range(K):
            if mod[i] < eps:
                mod[i] = 0.5 * (mod[(i - 1) % K] + mod[(i + 1) % K])
        out.append(mod.astype(dtype))
    return out


def bspline_weights(w, order=5):
    """Cardinal B-spline weights and derivatives at fractional offsets w in
    [0, 1): (...,) -> (theta, dtheta), each (..., order)."""
    th = [torch.zeros_like(w) for _ in range(order)]
    th[0] = 1.0 - w
    th[1] = w
    for k in range(3, order):
        d = 1.0 / (k - 1)
        new = [torch.zeros_like(w) for _ in range(order)]
        new[k - 1] = d * w * th[k - 2]
        for j in range(1, k - 1):
            new[k - 1 - j] = d * ((w + j) * th[k - 2 - j]
                                  + (k - j - w) * th[k - 1 - j])
        new[0] = d * (1.0 - w) * th[0]
        th = new
    # derivative from the order-1 splines: dM_n(u) = M_{n-1}(u) - M_{n-1}(u-1)
    dth = [-th[0]] + [th[j - 1] - th[j] for j in range(1, order)]
    d = 1.0 / (order - 1)
    new = [torch.zeros_like(w) for _ in range(order)]
    new[order - 1] = d * w * th[order - 2]
    for j in range(1, order - 1):
        new[order - 1 - j] = d * ((w + j) * th[order - 2 - j]
                                  + (order - j - w) * th[order - 1 - j])
    new[0] = d * (1.0 - w) * th[0]
    return torch.stack(new, dim=-1), torch.stack(dth, dim=-1)


def _effective_charges(atoms, scheduler, dtype):
    """The charges PME sums: scaled by the scheduler's scale_elec when it
    has one and the atoms carry lambda and role
    (mollytpu/ops/ewald.py:148-152)."""
    q = atoms.charge
    if (scheduler is not None and atoms.lam is not None
            and atoms.alch_role is not None):
        q = scaled_charge(scheduler, q, atoms.lam, atoms.alch_role)
    return q.to(dtype)


def _corrections(q, alpha, volume, ke):
    """Self energy and the neutralising-background correction."""
    e_self = -ke * alpha / math.sqrt(math.pi) * torch.sum(q * q)
    qtot = torch.sum(q)
    e_charge = -ke * math.pi / (2.0 * alpha ** 2) * qtot * qtot / volume
    return e_self, e_charge


@dataclasses.dataclass(frozen=True)
class PME:
    """Smooth PME reciprocal sum plus self and background corrections. Pair
    it with CoulombEwald (real space) and EwaldExclusionCorrection. With a
    ``scheduler`` the sums run over the alchemically scaled charges; the
    exclusion correction keeps the unscaled ones, as in the JAX package."""

    dist_cutoff: float = 1.0
    error_tol: float = 0.0005
    order: int = 5
    mesh_dims: tuple = None
    coulomb_const: float = COULOMB_CONST
    epsilon_r: float = 1.0
    alpha: float = None
    moduli_x: torch.Tensor = None
    moduli_y: torch.Tensor = None
    moduli_z: torch.Tensor = None
    scheduler: object = None

    @classmethod
    def setup(cls, boundary, dist_cutoff=1.0, error_tol=0.0005, order=5,
              epsilon_r=1.0, dtype=torch.float32, scheduler=None,
              mesh_dims=None, smooth_dims=True):
        alpha = ewald_error_alpha(dist_cutoff, error_tol)
        sides = boundary.side_lengths.detach().cpu().numpy()
        if mesh_dims is None:
            mesh_dims = pme_mesh_dims(sides, alpha, error_tol,
                                      smooth=smooth_dims)
        mods = [torch.as_tensor(m, dtype=dtype,
                                device=boundary.side_lengths.device)
                for m in bspline_moduli(order, mesh_dims)]
        return cls(dist_cutoff=float(dist_cutoff), error_tol=float(error_tol),
                   order=order, mesh_dims=tuple(int(x) for x in mesh_dims),
                   epsilon_r=float(epsilon_r), alpha=float(alpha),
                   moduli_x=mods[0], moduli_y=mods[1], moduli_z=mods[2],
                   scheduler=scheduler)

    @property
    def _ke(self):
        return self.coulomb_const / self.epsilon_r

    def _spread(self, coords, boundary, q):
        """Charge grid (K1, K2, K3) and the stencil cache (flat mesh index
        (N, o, o, o), theta and dtheta (N, 3, o), 1/L (3,))."""
        K = self.mesh_dims
        inv_l = 1.0 / boundary.side_lengths.to(coords.dtype)
        t = coords * inv_l                                   # fractional
        kk = _mesh_tensor(K, coords.dtype, coords.device)
        t = (t - torch.floor(t)) * kk
        ti = torch.floor(t)
        theta, dtheta = bspline_weights(t - ti, self.order)  # (N, 3, o)
        offs = torch.arange(self.order, device=coords.device)
        ti = ti.to(torch.int64)
        g = [(ti[:, d:d + 1] + offs[None, :]) % K[d] for d in range(3)]
        flat = ((g[0][:, :, None, None] * K[1] + g[1][:, None, :, None])
                * K[2] + g[2][:, None, None, :])
        wxyz = (theta[:, 0, :, None, None] * theta[:, 1, None, :, None]
                * theta[:, 2, None, None, :]) * q[:, None, None, None]
        grid = torch.zeros(K[0] * K[1] * K[2], dtype=coords.dtype,
                           device=coords.device)
        grid.index_add_(0, flat.reshape(-1), wxyz.reshape(-1))
        return grid.view(K), (flat, theta, dtheta, inv_l)

    def _influence(self, boundary, dtype):
        """k-space factor eterm(m) (without ke), m vectors, |m|^2 and the
        Gaussian exponent factor; eterm is 0 at m = 0."""
        K = self.mesh_dims
        dev = boundary.side_lengths.device
        inv_l = 1.0 / boundary.side_lengths.to(torch.float64)
        vol = boundary.volume().to(torch.float64)

        def wrapped(n):
            m = torch.arange(n, device=dev)
            return torch.where(m < (n + 1) // 2, m, m - n).to(torch.float64)

        mx = wrapped(K[0]) * inv_l[0]
        my = wrapped(K[1]) * inv_l[1]
        mz = wrapped(K[2]) * inv_l[2]
        zeros = torch.zeros(K, dtype=torch.float64, device=dev)
        mh = torch.stack([mx[:, None, None] + zeros, my[None, :, None] + zeros,
                          mz[None, None, :] + zeros], dim=-1)
        m2 = (mh * mh).sum(dim=-1)
        bsm = (self.moduli_x.double()[:, None, None]
               * self.moduli_y.double()[None, :, None]
               * self.moduli_z.double()[None, None, :])
        factor = math.pi ** 2 / self.alpha ** 2
        nonzero = m2 > 0
        m2s = torch.where(nonzero, m2, torch.ones_like(m2))
        denom = m2s * bsm * (math.pi * vol)
        eterm = torch.where(nonzero, torch.exp(-factor * m2s) / denom,
                            torch.zeros_like(m2))
        return eterm.to(dtype), mh.to(dtype), m2.to(dtype), factor

    def _recip(self, coords, boundary, q, needs_virial=False):
        """(E_recip, convolved potential grid, stencil cache, virial)."""
        dtype = coords.dtype
        grid, cache = self._spread(coords, boundary, q)
        ke = self._ke
        cgrid = torch.fft.fftn(grid)
        eterm, mh, m2, factor = self._influence(boundary, dtype)
        ek = eterm * (cgrid.real ** 2 + cgrid.imag ** 2)
        e_recip = 0.5 * ke * torch.sum(ek)
        vir = torch.zeros((3, 3), dtype=dtype, device=coords.device)
        if needs_virial:
            m2s = torch.where(m2 > 0, m2, torch.ones_like(m2))
            coeff = 2.0 * (1.0 + factor * m2) / m2s
            mm = torch.einsum("xyz,xyza,xyzb->ab", 0.5 * ke * ek * coeff,
                              mh, mh)
            vir = e_recip * torch.eye(3, dtype=dtype,
                                      device=coords.device) - mm
        ktot = self.mesh_dims[0] * self.mesh_dims[1] * self.mesh_dims[2]
        phi = (torch.fft.ifftn(cgrid * eterm) * ktot).real.to(dtype)
        return e_recip, phi, cache, vir

    def energy(self, coords, boundary, atoms):
        q = _effective_charges(atoms, self.scheduler, coords.dtype)
        e_recip, _, _, _ = self._recip(coords, boundary, q)
        e_self, e_charge = _corrections(q, self.alpha, boundary.volume(),
                                        self._ke)
        return e_recip + e_self + e_charge

    def force_virial(self, coords, boundary, atoms, needs_virial=False):
        q = _effective_charges(atoms, self.scheduler, coords.dtype)
        _, phi, (flat, theta, dtheta, inv_l), vir = self._recip(
            coords, boundary, q, needs_virial)
        ph = phi.reshape(-1)[flat]                          # (N, o, o, o)
        tx, ty, tz = theta.unbind(dim=1)
        dx, dy, dz = dtheta.unbind(dim=1)
        K = self.mesh_dims
        du = torch.stack([
            torch.einsum("nxyz,nx,ny,nz->n", ph, dx, ty, tz) * K[0],
            torch.einsum("nxyz,nx,ny,nz->n", ph, tx, dy, tz) * K[1],
            torch.einsum("nxyz,nx,ny,nz->n", ph, tx, ty, dz) * K[2]], dim=-1)
        # chain rule through fractional coordinates u = x / L
        forces = -(du * q[:, None] * self._ke) * inv_l
        if needs_virial:
            # background term E ~ 1/V gives W = E I
            _, e_charge = _corrections(q, self.alpha, boundary.volume(),
                                       self._ke)
            vir = vir + e_charge * torch.eye(3, dtype=coords.dtype,
                                             device=coords.device)
        return forces, vir


@dataclasses.dataclass(frozen=True)
class EwaldExclusionCorrection:
    """U = -ke q_i q_j erf(alpha r) / r over the pairs removed from the
    Ewald sum (excluded and 1-4), as a sparse pair list (i < j)."""

    pair_i: torch.Tensor
    pair_j: torch.Tensor
    alpha: float = 0.0
    coulomb_const: float = COULOMB_CONST

    @classmethod
    def setup(cls, pairs, alpha, ke=COULOMB_CONST, device=None):
        arr = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        arr = np.unique(np.sort(arr, axis=1), axis=0)
        return cls(pair_i=torch.as_tensor(arr[:, 0], device=device),
                   pair_j=torch.as_tensor(arr[:, 1], device=device),
                   alpha=float(alpha), coulomb_const=float(ke))

    def _geometry(self, coords, boundary, atoms):
        dr = boundary.displacement(coords[self.pair_i],
                                   coords[self.pair_j])      # x_j - x_i
        r2 = (dr * dr).sum(dim=1)
        r = torch.sqrt(r2 + 1e-24)
        q = atoms.charge.to(coords.dtype)
        return dr, r2, r, q[self.pair_i] * q[self.pair_j]

    def energy(self, coords, boundary, atoms):
        _, _, r, qq = self._geometry(coords, boundary, atoms)
        return -self.coulomb_const * torch.sum(
            qq * torch.erf(self.alpha * r) / r)

    def force_virial(self, coords, boundary, atoms, needs_virial=False):
        dr, r2, r, qq = self._geometry(coords, boundary, atoms)
        ke, a = self.coulomb_const, self.alpha
        # dU/dr = -ke qq (2a/sqrt(pi) exp(-a^2 r^2)/r - erf(ar)/r^2)
        dudr = -ke * qq * (2.0 * a / math.sqrt(math.pi)
                           * torch.exp(-(a * r) ** 2) / r
                           - torch.erf(a * r) / r2)
        coef = dudr / r
        fi = coef[:, None] * dr                               # force on i
        forces = torch.zeros_like(coords)
        forces.index_add_(0, self.pair_i, fi)
        forces.index_add_(0, self.pair_j, -fi)
        vir = (-torch.einsum("k,ka,kb->ab", coef, dr, dr) if needs_virial
               else torch.zeros((3, 3), dtype=coords.dtype,
                                device=coords.device))
        return forces, vir
