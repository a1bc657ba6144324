"""Plain reference of GROMACS's water benchmark as the configuration runs
it: rigid SPC water in an orthorhombic box, in float64 (or the TF32
control), written in plain torch operations.

Each step of its leap-frog is the GROMACS step with SETTLE:

- forces: LJ between oxygens, truncated at the cutoff; Ewald real space
  ke q_i q_j erfc(beta r) / r between atoms of different waters inside the
  cutoff (every pair from cell bins, reference/cells.py); smooth PME of
  order 4 (cardinal B-splines in closed form) on the configured mesh; the
  exclusion correction -ke q_i q_j erf(beta r) / r inside each water; beta
  from erfc(beta rc) = ewald-rtol by its own bisection;
- leap-frog: v += dt F / m, x' = x + dt v, SETTLE (Miyamoto and Kollman's
  analytic solution, in GROMACS's form) from x to x', v = (x' - x) / dt;
- v-rescale (Bussi, Donadio and Parrinello) on the half-step velocities,
  every step, from the draws (r1, g) the caller hands it: the program's
  own, so that both follow one trajectory.

Where it departs from GROMACS, and the program does too:

- no potential-shift modifiers: they change each pair's energy by a
  constant inside the cutoff and no force, so forces compare exactly and
  energies compare unshifted;
- the thermostat acts every step (GROMACS: every nsttcouple steps);
- the program solves the rigid waters by SHAKE / RATTLE where GROMACS
  runs SETTLE; both put each water on the same rigid triangle along its
  old bond directions, which is what this SETTLE is checked against;
- no centre-of-mass motion removal (the start has none, and the forces
  and the thermostat keep it so).

It imports nothing of the program: it reads the tile (.gro) and lays out
the box itself.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from .cells import CellBins, padded, pair_mask

#: kJ mol^-1 nm e^-2 (GROMACS's ONE_4PI_EPS0)
COULOMB_CONST = 138.935458
#: Boltzmann's constant in kJ mol^-1 K^-1
KB = 0.00831446261815324
#: the configuration's keys the reference reads
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def ewald_beta(rc, rtol):
    """beta with erfc(beta rc) = rtol, by bisection on [0, 10 / rc]."""
    lo, hi = 0.0, 10.0 / rc
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if math.erfc(mid * rc) > rtol:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def fft_size(edge, spacing):
    """The smallest 2,3,5-smooth mesh size >= edge / spacing."""
    n = max(6, math.ceil(edge / spacing - 1e-9))
    while True:
        m = n
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        if m == 1:
            return n
        n += 1


def read_tile(path):
    """(coordinates (N, 3) nm, box edges (3,)) of a .gro of waters."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    n = int(lines[1])
    xyz = np.array([[float(ln[20:28]), float(ln[28:36]), float(ln[36:44])]
                    for ln in lines[2:2 + n]])
    return xyz, np.array([float(v) for v in lines[2 + n].split()[:3]])


def settle(x0, x1, m_o, m_h, d_oh, d_hh):
    """SETTLE (GROMACS's settleTemplate): waters x1 (W, 3, 3), rows O, H1,
    H2, put back on the rigid triangle, from their constrained positions x0
    before the step. Whole waters (no periodic jump inside one)."""
    wohh = m_o + 2.0 * m_h
    wh = m_h / wohh
    rc = 0.5 * d_hh
    ra = 2.0 * m_h * math.sqrt(d_oh * d_oh - rc * rc) / wohh
    rb = math.sqrt(d_oh * d_oh - rc * rc) - ra
    d21, d31 = x0[:, 1] - x0[:, 0], x0[:, 2] - x0[:, 0]
    doh2, doh3 = x1[:, 1] - x1[:, 0], x1[:, 2] - x1[:, 0]
    a1 = -(doh2 + doh3) * wh
    com = x1[:, 0] - a1
    b1, c1 = x1[:, 1] - com, x1[:, 2] - com
    zd = torch.cross(d21, d31, dim=1)
    xd = torch.cross(a1, zd, dim=1)
    yd = torch.cross(zd, xd, dim=1)
    # rows of the frame: the unit x', y', z' axes
    frame = torch.stack([xd / torch.linalg.vector_norm(xd, dim=1)[:, None],
                         yd / torch.linalg.vector_norm(yd, dim=1)[:, None],
                         zd / torch.linalg.vector_norm(zd, dim=1)[:, None]],
                        dim=1)

    def to_frame(v):
        return torch.einsum("wij,wj->wi", frame, v)
    b0d, c0d = to_frame(d21), to_frame(d31)
    a1d_z = to_frame(a1)[:, 2]
    b1d, c1d = to_frame(b1), to_frame(c1)
    sinphi = a1d_z / ra
    cosphi = torch.sqrt(1.0 - sinphi * sinphi)
    sinpsi = (b1d[:, 2] - c1d[:, 2]) / (2.0 * rc * cosphi)
    cospsi = torch.sqrt(1.0 - sinpsi * sinpsi)
    a2d_y = ra * cosphi
    b2d_x = -rc * cospsi
    t1 = -rb * cosphi
    t2 = rc * sinpsi * sinphi
    b2d_y, c2d_y = t1 - t2, t1 + t2
    alpha = (b2d_x * (b0d[:, 0] - c0d[:, 0]) + b0d[:, 1] * b2d_y
             + c0d[:, 1] * c2d_y)
    beta = (b2d_x * (c0d[:, 1] - b0d[:, 1]) + b0d[:, 0] * b2d_y
            + c0d[:, 0] * c2d_y)
    gamma = (b0d[:, 0] * b1d[:, 1] - b1d[:, 0] * b0d[:, 1]
             + c0d[:, 0] * c1d[:, 1] - c1d[:, 0] * c0d[:, 1])
    al2be2 = alpha * alpha + beta * beta
    sinthe = (alpha * gamma - beta * torch.sqrt(al2be2 - gamma * gamma)) \
        / al2be2
    costhe = torch.sqrt(1.0 - sinthe * sinthe)
    a3d = torch.stack([-a2d_y * sinthe, a2d_y * costhe, a1d_z], dim=1)
    b3d = torch.stack([b2d_x * costhe - b2d_y * sinthe,
                       b2d_x * sinthe + b2d_y * costhe, b1d[:, 2]], dim=1)
    c3d = torch.stack([-b2d_x * costhe - c2d_y * sinthe,
                       -b2d_x * sinthe + c2d_y * costhe, c1d[:, 2]], dim=1)

    def back(v):
        return torch.einsum("wji,wj->wi", frame, v)
    return torch.stack([com + back(a3d), com + back(b3d), com + back(c3d)],
                       dim=1)


def bspline4(w):
    """Order-4 cardinal B-spline weights M4(w + 3 - j), j = 0..3, and their
    derivatives, at fractional offsets w in [0, 1): each (..., 4), for the
    mesh points floor(u) - 3 + j."""
    w2, w3 = w * w, w * w * w
    one = 1.0 - w
    th = torch.stack([one * one * one / 6.0,
                      (3.0 * w3 - 6.0 * w2 + 4.0) / 6.0,
                      (-3.0 * w3 + 3.0 * w2 + 3.0 * w + 1.0) / 6.0,
                      w3 / 6.0], dim=-1)
    dth = torch.stack([-0.5 * one * one, 0.5 * (3.0 * w2 - 4.0 * w),
                       0.5 * (-3.0 * w2 + 2.0 * w + 1.0), 0.5 * w2], dim=-1)
    return th, dth


class SPCWater:
    """The configuration's box of SPC waters; ``start`` is its first frame
    (the tile laid out and each water put on its triangle)."""

    ORDER = 4

    def __init__(self, cfg, prec, device):
        w, mdp = cfg["water"], cfg["mdp"]
        self.prec, self.device = prec, device
        dt = prec.dtype
        tile, edges = read_tile(os.path.join(REPO, w["tile"]))
        k = w["tiles_per_side"]
        shifts = np.stack(np.meshgrid(*[np.arange(k)] * 3, indexing="ij"),
                          axis=-1).reshape(-1, 1, 3) * edges
        x = (tile[None] + shifts).reshape(-1, 3)
        self.edges = edges * k
        self.n = x.shape[0]
        self.n_waters = self.n // 3
        self.m_o, self.m_h = w["mass_ow_u"], w["mass_hw_u"]
        self.d_oh, self.d_hh = w["d_oh_nm"], w["d_hh_nm"]
        self.L = torch.as_tensor(self.edges, dtype=dt, device=device)
        self.rc = mdp["rcoulomb"]
        self.rc_lj = mdp["rvdw"]
        self.beta = ewald_beta(self.rc, mdp["ewald_rtol"])
        self.mesh = [fft_size(e, mdp["fourierspacing"]) for e in self.edges]
        self.sigma, self.eps = w["sigma_ow_nm"], w["epsilon_ow_kj_mol"]
        q = np.tile([w["charge_ow"], w["charge_hw"], w["charge_hw"]],
                    self.n_waters)
        self.charge = torch.as_tensor(q, dtype=dt, device=device)
        self.mass = torch.as_tensor(np.tile([self.m_o, self.m_h, self.m_h],
                                            self.n_waters), dtype=dt,
                                    device=device)
        idx = torch.arange(self.n, device=device)
        self.molecule, self.is_o = idx // 3, idx % 3 == 0
        self.n_dof = 3 * self.n - 3 * self.n_waters - 3
        x = torch.as_tensor(x, dtype=dt, device=device)
        self.start = self.constrain(x, x)
        self._influence = None

    # -- geometry ----------------------------------------------------------

    def mic(self, d):
        return d - self.L * torch.round(d / self.L)

    def whole(self, x):
        """Each water's hydrogens at the oxygen's minimum image."""
        w = x.view(-1, 3, 3)
        return (w[:, :1] + self.mic(w - w[:, :1])).reshape(-1, 3)

    def constrain(self, x0, x1):
        """SETTLE from the waters at x0 to x1 (each made whole first)."""
        x0 = self.whole(x0.to(self.prec.dtype)).view(-1, 3, 3)
        x1 = self.whole(x1.to(self.prec.dtype))
        # x1's waters next to x0's, so that x1 - x0 is the step's move
        x1 = x1 - (self.L * torch.round(
            (x1.view(-1, 3, 3)[:, :1] - x0[:, :1]) / self.L)).expand(
            -1, 3, -1).reshape(-1, 3)
        out = settle(x0, x1.view(-1, 3, 3), self.m_o, self.m_h, self.d_oh,
                     self.d_hh)
        return self.prec.rnd(out.reshape(-1, 3))

    def constraint_deviation(self, x):
        """max over the water's three distances of |r - d0| / d0."""
        w = x.to(torch.float64).view(-1, 3, 3)
        d0 = torch.tensor([self.d_oh, self.d_oh, self.d_hh],
                          dtype=torch.float64, device=w.device)
        r = torch.stack([
            torch.linalg.vector_norm(self.mic(w[:, 1] - w[:, 0]), dim=1),
            torch.linalg.vector_norm(self.mic(w[:, 2] - w[:, 0]), dim=1),
            torch.linalg.vector_norm(self.mic(w[:, 2] - w[:, 1]), dim=1)],
            dim=1)
        return float(((r - d0).abs() / d0).max())

    # -- real space --------------------------------------------------------

    def _near(self, x):
        """Per block of cells: the rows, and per neighbouring cell (d =
        x_j - x_i, |d|^2, q_i q_j, both oxygens, the pairs of different
        waters inside the cutoff)."""
        rnd, n = self.prec.rnd, self.n
        rc2 = max(self.rc, self.rc_lj) ** 2
        xp, qp = padded(x), padded(self.charge)
        mp, op = padded(self.molecule), padded(self.is_o)
        for rows, tables in CellBins(x, self.edges, max(
                self.rc, self.rc_lj)).blocks():
            def near(rows=rows, tables=tables):
                for cols in tables:
                    d = rnd(self.mic(xp[cols][:, None, :, :]
                                     - xp[rows][:, :, None, :]))
                    r2 = rnd((d * d).sum(-1))
                    keep = ((r2 < rc2) & pair_mask(rows, cols, n)
                            & (mp[cols][:, None, :] != mp[rows][:, :, None]))
                    qq = qp[cols][:, None, :] * qp[rows][:, :, None]
                    oo = op[cols][:, None, :] & op[rows][:, :, None]
                    yield d, r2, qq, oo, keep
            yield rows, near()

    def _pair_terms(self, r2, qq, oo, keep):
        """(energy, (1/r) dU/dr) of each slot's pair, 0 where not kept."""
        rnd = self.prec.rnd
        safe = torch.where(keep, r2, torch.ones_like(r2))
        r = rnd(torch.sqrt(safe))
        inv_r = rnd(1.0 / r)
        inv_r2 = rnd(inv_r * inv_r)
        br = rnd(self.beta * r)
        erfc = rnd(torch.erfc(br))
        kqq = COULOMB_CONST * qq
        u_c = rnd(kqq * erfc * inv_r)
        du_c = rnd(-kqq * (2.0 * self.beta / math.sqrt(math.pi)
                           * torch.exp(-br * br) * inv_r
                           + erfc * inv_r2))
        s6 = rnd((self.sigma * self.sigma * inv_r2) ** 3)
        lj = oo & (r2 < self.rc_lj ** 2)
        u_lj = torch.where(lj, rnd(4.0 * self.eps * (s6 * s6 - s6)), 0.0)
        g_lj = torch.where(lj, rnd(4.0 * self.eps * (6.0 * s6 - 12.0 * s6
                                                     * s6) * inv_r2), 0.0)
        c = r2 < self.rc * self.rc
        u = torch.where(c, u_c, 0.0) + u_lj
        g = torch.where(c, rnd(du_c * inv_r), 0.0) + g_lj
        zero = torch.zeros_like(u)
        return torch.where(keep, u, zero), torch.where(keep, g, zero)

    def _real_forces(self, x):
        out = torch.zeros((self.n + 1, 3), dtype=x.dtype, device=x.device)
        for rows, near in self._near(x):
            acc = torch.zeros(rows.shape + (3,), dtype=x.dtype,
                              device=x.device)
            for d, r2, qq, oo, keep in near:
                _, g = self._pair_terms(r2, qq, oo, keep)
                acc = acc + (g[..., None] * d).sum(2)
            out[rows] = acc
        return out[:self.n]

    def _real_energy(self, x):
        total = torch.zeros((), dtype=x.dtype, device=x.device)
        for _, near in self._near(x):
            for _, r2, qq, oo, keep in near:
                total = total + 0.5 * self._pair_terms(r2, qq, oo, keep)[0]\
                    .sum()
        return total

    # -- inside the waters: the exclusion correction -----------------------

    def _excluded(self, x):
        """(energy, forces) of -ke q_i q_j erf(beta r) / r over each
        water's three pairs."""
        rnd = self.prec.rnd
        w = x.view(-1, 3, 3)
        q = self.charge.view(-1, 3)
        f = torch.zeros_like(w)
        e = torch.zeros((), dtype=x.dtype, device=x.device)
        for i, j in ((0, 1), (0, 2), (1, 2)):
            d = rnd(self.mic(w[:, j] - w[:, i]))
            r = rnd(torch.linalg.vector_norm(d, dim=1))
            kqq = COULOMB_CONST * q[:, i] * q[:, j]
            erf = rnd(torch.erf(self.beta * r))
            e = e - (kqq * erf / r).sum()
            du = -kqq * (2.0 * self.beta / math.sqrt(math.pi)
                         * torch.exp(-(self.beta * r) ** 2) / r - erf / (r * r))
            g = rnd(du / r)[:, None] * d           # force on i
            f[:, i] += g
            f[:, j] -= g
        return e, f.reshape(-1, 3)

    # -- reciprocal space: smooth PME of order 4 ---------------------------

    def _influence_grid(self):
        """G(m) = ke exp(-pi^2 |m|^2 / beta^2) / (pi V |m|^2 |D(m)|^2),
        0 at m = 0; D(m) = prod_k sum_j M4(j + 1) exp(2 pi i m_k j / K_k)."""
        if self._influence is not None:
            return self._influence
        dev, dt = self.device, torch.float64
        vol = float(np.prod(self.edges))
        m1 = [1.0 / 6.0, 4.0 / 6.0, 1.0 / 6.0]
        parts, d2 = [], []
        for K, L in zip(self.mesh, self.edges):
            k = torch.arange(K, device=dev, dtype=dt)
            mk = torch.where(k < (K + 1) // 2, k, k - K) / L
            parts.append(mk)
            ph = 2.0 * math.pi * k / K
            re = sum(c * torch.cos(ph * j) for j, c in enumerate(m1))
            im = sum(c * torch.sin(ph * j) for j, c in enumerate(m1))
            d2.append(re * re + im * im)
        mx, my, mz = torch.meshgrid(*parts, indexing="ij")
        msq = mx * mx + my * my + mz * mz
        dd = (d2[0][:, None, None] * d2[1][None, :, None]
              * d2[2][None, None, :])
        safe = torch.where(msq > 0, msq, torch.ones_like(msq))
        g = COULOMB_CONST * torch.exp(-math.pi ** 2 * safe / self.beta ** 2) \
            / (math.pi * vol * safe * dd)
        self._influence = torch.where(msq > 0, g, torch.zeros_like(g))
        return self._influence

    def _stencil(self, x):
        """Per atom: the mesh points (N, 4) per axis and the weights and
        derivatives (N, 3, 4)."""
        rnd = self.prec.rnd
        K = torch.tensor(self.mesh, dtype=x.dtype, device=x.device)
        u = x / self.L
        u = rnd((u - torch.floor(u)) * K)
        base = torch.floor(u)
        th, dth = bspline4(u - base)
        pts = [(base[:, a:a + 1].long() - 3 + torch.arange(4, device=x.device))
               % self.mesh[a] for a in range(3)]
        return pts, rnd(th), rnd(dth)

    def _reciprocal(self, x, forces=True):
        rnd = self.prec.rnd
        Kx, Ky, Kz = self.mesh
        pts, th, dth = self._stencil(x)
        flat = ((pts[0][:, :, None, None] * Ky + pts[1][:, None, :, None])
                * Kz + pts[2][:, None, None, :])
        w = (th[:, 0, :, None, None] * th[:, 1, None, :, None]
             * th[:, 2, None, None, :])
        grid = torch.zeros(Kx * Ky * Kz, dtype=x.dtype, device=x.device)
        grid.index_add_(0, flat.reshape(-1),
                        rnd(w * self.charge[:, None, None, None]).reshape(-1))
        qhat = torch.fft.fftn(grid.view(Kx, Ky, Kz))
        g = self._influence_grid().to(x.dtype)
        energy = 0.5 * (g * (qhat.real ** 2 + qhat.imag ** 2)).sum()
        if not forces:
            return energy, None
        phi = rnd(torch.fft.ifftn(g * qhat).real * (Kx * Ky * Kz))
        ph = phi.reshape(-1)[flat]
        tx, ty, tz = th.unbind(1)
        dx, dy, dz = dth.unbind(1)
        du = torch.stack([
            torch.einsum("nabc,na,nb,nc->n", ph, dx, ty, tz) * Kx,
            torch.einsum("nabc,na,nb,nc->n", ph, tx, dy, tz) * Ky,
            torch.einsum("nabc,na,nb,nc->n", ph, tx, ty, dz) * Kz], dim=1)
        return energy, -self.charge[:, None] * du / self.L

    # -- the model ---------------------------------------------------------

    def forces(self, x):
        x = x.to(self.prec.dtype)
        _, f_ex = self._excluded(x)
        _, f_rec = self._reciprocal(x)
        return self.prec.rnd(self._real_forces(x) + f_ex + f_rec)

    def energy(self, x):
        """The potential energy (kJ/mol), without potential shifts."""
        x = x.to(self.prec.dtype)
        e_self = -COULOMB_CONST * self.beta / math.sqrt(math.pi) * float(
            (self.charge.double() ** 2).sum())
        e_rec, _ = self._reciprocal(x, forces=False)
        return self._real_energy(x) + self._excluded(x)[0] + e_rec + e_self

    def pair_count(self, x):
        from roofline.count import count_pairs
        return count_pairs(x.to(torch.float64), self.L.to(torch.float64),
                           self.rc, self.molecule, self.is_o)

    # -- leap-frog with v-rescale ------------------------------------------

    def vrescale(self, v, dt, temperature, tau, r1, g):
        """Bussi's v-rescale: v scaled by alpha, alpha^2 = c + (1 - c)
        (K_ref / (n_f K)) (r1^2 + g) + 2 r1 sqrt(c (1 - c) K_ref /
        (n_f K)), c = exp(-dt / tau), K_ref = n_f kB T / 2."""
        ke = 0.5 * (self.mass[:, None] * v * v).sum()
        c = math.exp(-dt / tau)
        ratio = 0.5 * self.n_dof * KB * temperature / (self.n_dof * ke)
        a2 = c + (1.0 - c) * ratio * (g + r1 * r1) + 2.0 * r1 * torch.sqrt(
            c * (1.0 - c) * ratio)
        return v * torch.sqrt(a2)

    def leapfrog(self, x, v, n_steps, dt, temperature, tau, draws):
        """n_steps of leap-frog with SETTLE and v-rescale from the program's
        state (x, v); ``draws`` the (r1, g) of each step."""
        dtp = self.prec.dtype
        x, v = self.whole(x.to(dtp)), v.to(dtp)
        m = self.mass[:, None]
        for k in range(n_steps):
            f = self.forces(x)
            v = v + dt * f / m
            x_new = self.constrain(x, x + dt * v)
            v = (x_new - x) / dt
            x = x_new
            r1, g = draws[k]
            v = self.vrescale(v, dt, temperature, tau, float(r1), float(g))
        return x, v
