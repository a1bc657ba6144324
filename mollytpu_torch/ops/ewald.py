"""Smooth particle-mesh Ewald in any periodic box, the Ewald exclusion
correction and the reference Ewald sum (counterpart of
mollytpu/ops/ewald.py:45-367, 370-425, 538-717).

The port carries the JAX package's scatter form of PME: charges spread
with ``index_add_``, ``torch.fft`` for the convolution and a stencil gather
for the forces. The dense one-hot matmul form of the JAX package exists for
the TPU's slow scatter and is not carried over. The exclusion correction is
the sparse pair form over the excluded and 1-4 pairs.

The box enters through its reciprocal matrix (``boundary.reciprocal()``,
the inverse of the box matrix, held on the box): fractional coordinates
are x @ inv, the mesh vectors m = sum_d m_d inv[:, d], and the forces
follow by the chain rule through the fractional coordinates. A triclinic
box and an orthorhombic one (a diagonal inverse) take the same path. The
influence function depends on the box alone and is cached on the box
object, as its minimum-image row is: a box moved by a barostat is a new
object and gets its own.

Two rules set the splitting parameter alpha and the mesh. OpenMM's, the
default: alpha = sqrt(-ln(2 tol)) / rc and the mesh from the same tolerance
(``ewald_error_alpha``, ``pme_mesh_dims``). GROMACS's: alpha from
erfc(alpha rc) = ewald-rtol (``ewald_rtol_alpha``) and the mesh from
fourierspacing (``pme_mesh_dims_spacing``); ``PME.setup`` takes the
resulting ``alpha`` and ``mesh_dims``, and the same alpha goes to the real
space (``CoulombEwald(alpha=...)``) and the exclusion correction.

Sign conventions: energies in kJ/mol; virial W_ab = -dE/d(strain_ab),
matching the pair kernel's -(dU/dr / r) dr (x) dr.

``EVALUATIONS`` counts PME's force evaluations by mesh, on the host.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..boundary import _cached
from ..free_energy.alchemy import scaled_charge
from ..tracing import span
from ..units import COULOMB_CONST
from .bonded import ewald_exclusions
from .general import GeneralInteraction

#: mesh dims -> PME force evaluations on that mesh, counted on the host
EVALUATIONS = {}


def ewald_error_alpha(dist_cutoff, error_tol=0.0005):
    """alpha = sqrt(-log(2 tol)) / rc (OpenMM convention)."""
    return math.sqrt(-math.log(2.0 * error_tol)) / dist_cutoff


def ewald_rtol_alpha(dist_cutoff, ewald_rtol=1e-5):
    """alpha with erfc(alpha rc) = ewald_rtol (GROMACS's ewald-rtol rule,
    calc_ewaldcoeff_q): doubled from 5 until erfc(alpha rc) falls below
    the tolerance, then bisected 60 more times."""
    beta, i = 5.0, 0
    while math.erfc(beta * dist_cutoff) > ewald_rtol:
        i += 1
        beta *= 2.0
    lo, hi = 0.0, beta
    for _ in range(i + 60):
        beta = 0.5 * (lo + hi)
        if math.erfc(beta * dist_cutoff) > ewald_rtol:
            lo = beta
        else:
            hi = beta
    return beta


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


def pme_mesh_dims_spacing(side_lengths, fourier_spacing, smooth=True):
    """ceil(L / fourierspacing) per side, min 6, optionally rounded up to
    FFT-smooth sizes (GROMACS sizes the mesh from its fourierspacing)."""
    dims = []
    for L in np.asarray(side_lengths, dtype=np.float64):
        s = max(int(math.ceil(float(L) / fourier_spacing - 1e-9)), 6)
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


def _exclusion_terms(q, coords, boundary, alpha, excl_i, excl_j):
    """Per pair of (excl_i, excl_j): the displacement x_j - x_i, r^2, r,
    q_i q_j and erf(alpha r)."""
    dr = boundary.displacement(coords[excl_i], coords[excl_j])
    r2 = (dr * dr).sum(dim=-1)
    r = torch.sqrt(r2 + 1e-24)
    return dr, r2, r, q[excl_i] * q[excl_j], torch.erf(alpha * r)


def _exclusion_energy(q, coords, boundary, alpha, ke, excl_i, excl_j):
    """-ke q_i q_j erf(alpha r) / r over pairs removed from the Ewald sum
    (mollytpu/ops/ewald.py:163-170)."""
    if excl_i.shape[0] == 0:
        return torch.zeros((), dtype=coords.dtype, device=coords.device)
    _, _, r, qq, erf_ar = _exclusion_terms(q, coords, boundary, alpha, excl_i,
                                           excl_j)
    return -ke * torch.sum(qq * erf_ar / r)


def _exclusion_force_virial(q, coords, boundary, alpha, ke, excl_i, excl_j,
                            needs_virial):
    """Forces and virial of _exclusion_energy (mollytpu/ops/ewald.py:
    173-193)."""
    vir = torch.zeros((3, 3), dtype=coords.dtype, device=coords.device)
    if excl_i.shape[0] == 0:
        return torch.zeros_like(coords), vir
    dr, r2, r, qq, erf_ar = _exclusion_terms(q, coords, boundary, alpha,
                                             excl_i, excl_j)
    dudr = -ke * qq * (2.0 * alpha / math.sqrt(math.pi)
                       * torch.exp(-(alpha * r) ** 2) / r - erf_ar / r2)
    coef = dudr / r
    fi = coef[:, None] * dr                                   # force on i
    forces = torch.zeros_like(coords).index_add(0, excl_i, fi).index_add(
        0, excl_j, -fi)
    if needs_virial:
        vir = -torch.einsum("k,ka,kb->ab", coef, dr, dr)
    return forces, vir


def _pairs(pairs, device):
    """(i, j) index tensors of a (P, 2) pair array; empty for None."""
    arr = np.asarray([] if pairs is None else pairs,
                     dtype=np.int64).reshape(-1, 2)
    return (torch.as_tensor(arr[:, 0], device=device),
            torch.as_tensor(arr[:, 1], device=device))


def _mesh_vectors(boundary, mesh_dims):
    """The reciprocal mesh vectors m = sum_d m_d inv[:, d] over the wrapped
    mesh indices m_d, (K1, K2, K3, 3) in float64 (mollytpu/ops/ewald.py:
    572-582)."""
    inv = boundary.reciprocal().to(torch.float64)
    dev = inv.device

    def wrapped(n):
        m = torch.arange(n, device=dev)
        return torch.where(m < (n + 1) // 2, m, m - n).to(torch.float64)

    mx, my, mz = (wrapped(k) for k in mesh_dims)
    return (mx[:, None, None, None] * inv[:, 0]
            + my[None, :, None, None] * inv[:, 1]
            + mz[None, None, :, None] * inv[:, 2])


@dataclasses.dataclass(frozen=True)
class PME:
    """Smooth PME reciprocal sum plus self and background corrections. Pair
    it with CoulombEwald (real space) and EwaldExclusionCorrection. With a
    ``scheduler`` the sums run over the alchemically scaled charges; the
    exclusion correction keeps the unscaled ones, as in the JAX package.

    ``excl_i, excl_j`` (index tensors) are pairs whose reciprocal-space
    interaction PME subtracts itself (mollytpu/ops/ewald.py:389-394); the
    model builders leave them empty and add an EwaldExclusionCorrection."""

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
    excl_i: torch.Tensor = None
    excl_j: torch.Tensor = None

    def __post_init__(self):
        if self.excl_i is None:
            dev = None if self.moduli_x is None else self.moduli_x.device
            ei, ej = _pairs(None, dev)
            object.__setattr__(self, "excl_i", ei)
            object.__setattr__(self, "excl_j", ej)

    @classmethod
    def setup(cls, boundary, dist_cutoff=1.0, error_tol=0.0005, order=5,
              excl_pairs=None, epsilon_r=1.0, dtype=torch.float32,
              scheduler=None, mesh_dims=None, smooth_dims=True, alpha=None):
        """The mesh is sized from ``boundary.side_lengths``, the basis
        diagonal of a triclinic box, as in the JAX package. ``alpha`` and
        ``mesh_dims``, when given, replace the OpenMM rule's values from
        ``error_tol`` (GROMACS's: ewald_rtol_alpha, pme_mesh_dims_spacing)."""
        if alpha is None:
            alpha = ewald_error_alpha(dist_cutoff, error_tol)
        sides = boundary.side_lengths.detach().cpu().numpy()
        if mesh_dims is None:
            mesh_dims = pme_mesh_dims(sides, alpha, error_tol,
                                      smooth=smooth_dims)
        dev = boundary.side_lengths.device
        mods = [torch.as_tensor(m, dtype=dtype, device=dev)
                for m in bspline_moduli(order, mesh_dims)]
        ei, ej = _pairs(excl_pairs, dev)
        return cls(dist_cutoff=float(dist_cutoff), error_tol=float(error_tol),
                   order=order, mesh_dims=tuple(int(x) for x in mesh_dims),
                   epsilon_r=float(epsilon_r), alpha=float(alpha),
                   moduli_x=mods[0], moduli_y=mods[1], moduli_z=mods[2],
                   scheduler=scheduler, excl_i=ei, excl_j=ej)

    @property
    def _ke(self):
        return self.coulomb_const / self.epsilon_r

    def _spread(self, coords, boundary, q):
        """Charge grid (K1, K2, K3) and the stencil cache (flat mesh index
        (N, o, o, o), theta and dtheta (N, 3, o), the box's inverse)."""
        K = self.mesh_dims
        inv = boundary.reciprocal(coords.dtype)
        # fractional coordinates x @ inv, as elementwise products: exact
        # (no reduced-precision matmul) and, for a diagonal inverse, x / L
        t = (coords[:, 0:1] * inv[0] + coords[:, 1:2] * inv[1]
             + coords[:, 2:3] * inv[2])
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
        return grid.view(K), (flat, theta, dtheta, inv)

    def _influence(self, boundary, dtype):
        """k-space factor eterm(m) (without ke), the m vectors and the
        virial's coefficient 2 (1 + pi^2 |m|^2 / alpha^2) / |m|^2; eterm is
        0 at m = 0. Computed once per box object and cached on it
        (mollytpu/ops/ewald.py:565-591, 608-612)."""
        key = ("pme-influence", self.mesh_dims, self.order, self.alpha,
               self.moduli_x.dtype, dtype)
        return _cached(boundary, key,
                       lambda: self._make_influence(boundary, dtype))

    def _make_influence(self, boundary, dtype):
        vol = boundary.volume().to(torch.float64)
        mh = _mesh_vectors(boundary, self.mesh_dims)
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
        coeff = 2.0 * (1.0 + factor * m2) / m2s
        return eterm.to(dtype), mh.to(dtype), coeff.to(dtype)

    def _recip(self, coords, boundary, q, needs_virial=False):
        """(E_recip, convolved potential grid, stencil cache, virial)."""
        dtype = coords.dtype
        with span("pme.spread"):
            grid, cache = self._spread(coords, boundary, q)
        with span("pme.solve"):
            return self._solve(grid, cache, boundary, dtype, needs_virial)

    def _solve(self, grid, cache, boundary, dtype, needs_virial):
        """The FFT, the influence function and the inverse FFT of
        ``_recip``."""
        ke = self._ke
        cgrid = torch.fft.fftn(grid)
        eterm, mh, coeff = self._influence(boundary, dtype)
        ek = eterm * (cgrid.real ** 2 + cgrid.imag ** 2)
        e_recip = 0.5 * ke * torch.sum(ek)
        vir = torch.zeros((3, 3), dtype=dtype, device=grid.device)
        if needs_virial:
            mm = torch.einsum("xyz,xyza,xyzb->ab", 0.5 * ke * ek * coeff,
                              mh, mh)
            vir = e_recip * torch.eye(3, dtype=dtype,
                                      device=grid.device) - mm
        ktot = self.mesh_dims[0] * self.mesh_dims[1] * self.mesh_dims[2]
        phi = (torch.fft.ifftn(cgrid * eterm) * ktot).real.to(dtype)
        return e_recip, phi, cache, vir

    def energy(self, coords, boundary, atoms):
        q = _effective_charges(atoms, self.scheduler, coords.dtype)
        e_recip, _, _, _ = self._recip(coords, boundary, q)
        e_self, e_charge = _corrections(q, self.alpha, boundary.volume(),
                                        self._ke)
        e_excl = _exclusion_energy(q, coords, boundary, self.alpha, self._ke,
                                   self.excl_i, self.excl_j)
        return e_recip + e_self + e_charge + e_excl

    def force_virial(self, coords, boundary, atoms, needs_virial=False):
        EVALUATIONS[self.mesh_dims] = EVALUATIONS.get(self.mesh_dims, 0) + 1
        q = _effective_charges(atoms, self.scheduler, coords.dtype)
        _, phi, cache, vir = self._recip(coords, boundary, q, needs_virial)
        with span("pme.gather"):
            forces = self._gather(phi, cache, q)
        f_ex, v_ex = _exclusion_force_virial(
            q, coords, boundary, self.alpha, self._ke, self.excl_i,
            self.excl_j, needs_virial)
        forces = forces + f_ex
        if needs_virial:
            # background term E ~ 1/V gives W = E I
            _, e_charge = _corrections(q, self.alpha, boundary.volume(),
                                       self._ke)
            vir = vir + v_ex + e_charge * torch.eye(
                3, dtype=coords.dtype, device=coords.device)
        return forces, vir

    def charge_change_energy(self, coords, boundary, q, index, dq):
        """(K,) E(q + dq_k) - E(q) in float64, exactly, where the charges
        ``q`` (N,) change by the rows of ``dq`` (K, S) on the atoms
        ``index`` (S,) alone: every term of ``energy`` is a quadratic in
        the change. The reciprocal sum on the same mesh and splines,

            E_recip(q + dq) = E_recip(q) + ke (dq . phi + dq . psi dq / 2),

        phi (S,) the convolved potential of ``q`` at each changed atom and
        psi (S, S) their mesh interaction, psi_ab = sum over the stencil
        points p of atom a and p' of b of their weights times h(p - p'),
        h = fftn(eterm) the mesh's real-space kernel (built once per box);
        the self and background terms; and the excluded pairs
        (``excl_i``, ``excl_j``)."""
        f64 = torch.float64
        x, q, dq = coords.to(f64), q.to(f64), dq.to(f64)
        ke, alpha, K = self._ke, self.alpha, self.mesh_dims
        grid, (flat, theta, _, _) = self._spread(x, boundary, q)
        eterm, h = self._kernels64(boundary)
        phi = (torch.fft.ifftn(torch.fft.fftn(grid) * eterm)
               * (K[0] * K[1] * K[2])).real.reshape(-1)
        th = theta[index]
        w = (th[:, 0, :, None, None] * th[:, 1, None, :, None]
             * th[:, 2, None, None, :]).reshape(index.shape[0], -1)
        pts = flat[index].reshape(index.shape[0], -1)
        g = (pts // (K[1] * K[2]), (pts // K[2]) % K[1], pts % K[2])
        diff = [(a[:, :, None, None] - a[None, None, :, :]) % k
                for a, k in zip(g, K)]
        psi = torch.einsum("ap,bq,apbq->ab", w, w,
                           h[(diff[0] * K[1] + diff[1]) * K[2] + diff[2]])
        e = ke * (dq @ (phi[pts] * w).sum(dim=1)
                  + 0.5 * torch.einsum("ks,st,kt->k", dq, psi, dq))
        e = e - ke * alpha / math.sqrt(math.pi) * (
            2.0 * q[index] * dq + dq * dq).sum(dim=1)
        qt, dt = q.sum(), dq.sum(dim=1)
        e = e - ke * math.pi / (2.0 * alpha ** 2) * (
            2.0 * qt * dt + dt * dt) / boundary.volume().to(f64)
        if self.excl_i.shape[0] == 0:
            return e
        d = torch.zeros((dq.shape[0], q.shape[0]), dtype=f64,
                        device=x.device).index_copy_(1, index, dq)
        _, _, r, _, erf_ar = _exclusion_terms(q, x, boundary, alpha,
                                              self.excl_i, self.excl_j)
        qi, qj = q[self.excl_i], q[self.excl_j]
        di, dj = d[:, self.excl_i], d[:, self.excl_j]
        return e - ke * (erf_ar / r * (qi * dj + di * qj + di * dj)).sum(
            dim=1)

    def _kernels64(self, boundary):
        """(eterm, h = fftn(eterm).real flattened) in float64, once per
        box."""
        def make():
            eterm = self._make_influence(boundary, torch.float64)[0]
            return eterm, torch.fft.fftn(eterm).real.reshape(-1)
        key = ("pme-kernels64", self.mesh_dims, self.order, self.alpha)
        return _cached(boundary, key, make)

    def _gather(self, phi, cache, q):
        """The forces of the convolved grid ``phi`` on the charges, from
        the stencil cache of ``_spread``."""
        flat, theta, dtheta, inv = cache
        ph = phi.reshape(-1)[flat]                          # (N, o, o, o)
        tx, ty, tz = theta.unbind(dim=1)
        dx, dy, dz = dtheta.unbind(dim=1)
        K = self.mesh_dims
        du = torch.stack([
            torch.einsum("nxyz,nx,ny,nz->n", ph, dx, ty, tz) * K[0],
            torch.einsum("nxyz,nx,ny,nz->n", ph, tx, dy, tz) * K[1],
            torch.einsum("nxyz,nx,ny,nz->n", ph, tx, ty, dz) * K[2]], dim=-1)
        # chain rule through the fractional coordinates u = x @ inv:
        # dE/dx = dE/du @ inv.T, as elementwise products
        du = du * q[:, None] * self._ke
        return -(du[:, 0:1] * inv[:, 0] + du[:, 1:2] * inv[:, 1]
                 + du[:, 2:3] * inv[:, 2])


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

    def energy(self, coords, boundary, atoms):
        return _exclusion_energy(atoms.charge.to(coords.dtype), coords,
                                 boundary, self.alpha, self.coulomb_const,
                                 self.pair_i, self.pair_j)

    def force_virial(self, coords, boundary, atoms, needs_virial=False):
        return _exclusion_force_virial(
            atoms.charge.to(coords.dtype), coords, boundary, self.alpha,
            self.coulomb_const, self.pair_i, self.pair_j, needs_virial)


def ewald_exclusion_list(excl_pairs, charges, alpha, ke=COULOMB_CONST,
                         dtype=torch.float32, device=None):
    """A SpecificList of -ke q_i q_j erf(alpha r) / r terms over the pairs
    removed from an Ewald or PME sum, with k q_i q_j taken from the
    charges at setup (mollytpu/ops/ewald.py:296-310)."""
    arr = np.asarray(excl_pairs, dtype=np.int64).reshape(-1, 2)
    q = np.asarray(charges.detach().cpu() if isinstance(charges, torch.Tensor)
                   else charges, dtype=np.float64)
    kqq = ke * q[arr[:, 0]] * q[arr[:, 1]]
    return ewald_exclusions(arr[:, 0], arr[:, 1], kqq,
                            np.full(arr.shape[0], float(alpha)),
                            dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class Ewald(GeneralInteraction):
    """The reference Ewald reciprocal sum over the k-space cube |k_d| <=
    kmax, with the self, background and exclusion corrections
    (mollytpu/ops/ewald.py:313-366): the correctness oracle for PME in an
    orthorhombic box. Forces and the virial come from autograd of the
    energy (GeneralInteraction). Pair it with CoulombEwald."""

    dist_cutoff: float = 1.0
    error_tol: float = 0.0005
    kmax: int = 12
    coulomb_const: float = COULOMB_CONST
    alpha: float = None
    excl_i: torch.Tensor = None
    excl_j: torch.Tensor = None
    scheduler: object = None

    def __post_init__(self):
        if self.alpha is None:
            object.__setattr__(self, "alpha", ewald_error_alpha(
                self.dist_cutoff, self.error_tol))
        if self.excl_i is None:
            ei, ej = _pairs(None, None)
            object.__setattr__(self, "excl_i", ei)
            object.__setattr__(self, "excl_j", ej)

    def energy(self, coords, boundary, atoms):
        ke, alpha, km = self.coulomb_const, self.alpha, self.kmax
        q = _effective_charges(atoms, self.scheduler, coords.dtype)
        vol = boundary.volume()
        ints = torch.arange(-km, km + 1, device=coords.device)
        kvec = torch.stack(torch.meshgrid(ints, ints, ints, indexing="ij"),
                           dim=-1).reshape(-1, 3).to(coords.dtype)
        nonzero = torch.any(kvec != 0, dim=1)
        kfac = 2.0 * math.pi * kvec / boundary.side_lengths[None, :]
        k2 = (kfac * kfac).sum(dim=-1)
        k2s = torch.where(nonzero, k2, torch.ones_like(k2))
        phases = coords @ kfac.T                                  # (N, K)
        s_re = torch.sum(q[:, None] * torch.cos(phases), dim=0)
        s_im = torch.sum(q[:, None] * torch.sin(phases), dim=0)
        terms = torch.where(
            nonzero, torch.exp(-k2s / (4.0 * alpha ** 2)) / k2s
            * (s_re ** 2 + s_im ** 2), torch.zeros_like(k2))
        e_recip = ke * 2.0 * math.pi / vol * torch.sum(terms)
        e_self, e_charge = _corrections(q, alpha, vol, ke)
        e_excl = _exclusion_energy(q, coords, boundary, alpha, ke,
                                   self.excl_i.to(coords.device),
                                   self.excl_j.to(coords.device))
        return e_recip + e_self + e_charge + e_excl
