"""Plain reference of one alchemical window of GROMACS's water benchmark:
the box of reference/spc_water.py with one water, the one whose oxygen is
nearest the box centre in the start frame, coupled alchemically at
lambda, in float64 (or the TF32 control), written in plain torch
operations.

Every interaction of that water (the solute) reads lambda through the
default schedule of an inserted molecule: sterics s = min(2 lambda, 1),
electrostatics e = max(0, 2 lambda - 1). Each solute-solvent pair takes
the smaller lambda of its two atoms (the solvent's is 1), so s and e are
the solute's:

- LJ, Beutler soft-core: U = s (C12 / R^2 - C6 / R), R = a (1 - s)
  sigma^6 + r^6 (floored at 1e-12), C6 = 4 eps sigma^6, C12 = C6 sigma^6,
  a = the configuration's ``sc-alpha``, sigma by Lorentz and eps by
  Berthelot mixing, 0 beyond rvdw and where either atom has no LJ;
- Ewald real space, Beutler soft-core: U = e ke q_i q_j erfc(beta r) /
  (a_q (1 - e) sigma^6 + r^6)^(1/6) inside rcoulomb (the bracket floored
  at 1e-18), the exact erfc of the true distance, sigma by Lorentz mixing
  (0 for two hydrogens), a_q = a (sc-coul = yes);
- PME, its self term and the exclusion correction inside each water, all
  on the scheduled charges: the solute's q times e.

The solvent's own pairs are reference/spc_water.py's. The solute's forces
are the gradient of its pairs' energy by autograd. It imports nothing of
the program.
"""

from __future__ import annotations

import contextlib
import math

import torch

from .spc_water import COULOMB_CONST, SPCWater


def sterics(lam):
    return min(2.0 * lam, 1.0)


def electrostatics(lam):
    return max(0.0, 2.0 * lam - 1.0)


class SPCWaterFEP(SPCWater):
    """The configuration's box with its solute coupled at ``lam``, the
    window's lambda; ``energies`` gives U at several."""

    def __init__(self, cfg, prec, device, lam):
        super().__init__(cfg, prec, device)
        w, fe = cfg["water"], cfg["free_energy"]
        self.lam = lam
        self.a_lj = self.a_q = fe["mdp"]["sc-alpha"]
        x = self.start.to(torch.float64)
        oxygens = torch.arange(0, self.n, 3, device=device)
        near = torch.linalg.vector_norm(
            x[oxygens] - 0.5 * self.L.to(torch.float64), dim=1)
        first = int(oxygens[torch.argmin(near)])
        self.solute = torch.arange(first, first + 3, device=device)
        solute = torch.zeros(self.n, dtype=torch.bool, device=device)
        solute[self.solute] = True
        self.in_solute = solute
        self.lj_atom = self.is_o.clone()
        self.sigma_atom = self.is_o.to(prec.dtype) * w["sigma_ow_nm"]
        self.eps_atom = self.is_o.to(prec.dtype) * w["epsilon_ow_kj_mol"]
        self.q0 = self.charge
        # the solvent's pairs: the base class's real space with the solute
        # carrying neither charge nor LJ
        self.charge = torch.where(solute, 0.0, self.q0)
        self.is_o = self.is_o & ~solute

    def charges(self, lam):
        """The scheduled charges: the solute's times e(lambda)."""
        return torch.where(self.in_solute, self.q0 * electrostatics(lam),
                           self.q0)

    @contextlib.contextmanager
    def _scheduled(self, lam):
        """The base class's PME and exclusion correction on the scheduled
        charges inside the block."""
        solvent, self.charge = self.charge, self.charges(lam)
        try:
            yield
        finally:
            self.charge = solvent

    # -- the solute's pairs ------------------------------------------------

    def _solute_energy(self, x, lam):
        rnd = self.prec.rnd
        s = self.solute
        d = rnd(self.mic(x[None, :, :] - x[s][:, None, :]))       # (3, N, 3)
        r2 = rnd((d * d).sum(-1))
        other = (self.molecule != self.molecule[s[0]])[None, :]
        coul = other & (r2 < self.rc ** 2)
        lj = (other & (r2 < self.rc_lj ** 2) & self.lj_atom[s][:, None]
              & self.lj_atom[None, :])
        r2 = torch.where(coul | lj, r2, torch.ones_like(r2))
        r = rnd(torch.sqrt(r2))
        r6 = rnd(r2 * r2 * r2)
        sig = 0.5 * (self.sigma_atom[s][:, None] + self.sigma_atom[None, :])
        sig6 = rnd(sig ** 6)
        total = torch.zeros((), dtype=x.dtype, device=x.device)
        st, el = sterics(lam), electrostatics(lam)
        if st > 0:
            eps = torch.sqrt(self.eps_atom[s][:, None]
                             * self.eps_atom[None, :])
            c6 = rnd(4.0 * eps * sig6)
            c12 = rnd(c6 * sig6)
            big_r = rnd(torch.clamp(self.a_lj * (1.0 - st) * sig6 + r6,
                                    min=1e-12))
            u = rnd(st * (c12 / (big_r * big_r) - c6 / big_r))
            total = total + torch.where(lj, u, 0.0).sum()
        if el > 0:
            qq = self.q0[s][:, None] * self.q0[None, :]
            rq = rnd(torch.clamp(self.a_q * (1.0 - el) * sig6 + r6,
                                 min=1e-18))
            u = rnd(el * COULOMB_CONST * qq * rq ** (-1.0 / 6.0)
                    * rnd(torch.erfc(self.beta * r)))
            total = total + torch.where(coul, u, 0.0).sum()
        return total

    def _solute_forces(self, x, lam):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            (grad,) = torch.autograd.grad(self._solute_energy(xg, lam), xg)
        return -grad

    # -- the model ---------------------------------------------------------

    def _scheduled_energy(self, x, lam):
        """PME, its self term and the exclusion correction on the scheduled
        charges."""
        q = self.charges(lam)
        e_self = -COULOMB_CONST * self.beta / math.sqrt(math.pi) * float(
            (q.double() ** 2).sum())
        with self._scheduled(lam):
            return (self._reciprocal(x, forces=False)[0]
                    + self._excluded(x)[0] + e_self)

    def forces(self, x):
        x = x.to(self.prec.dtype)
        with self._scheduled(self.lam):
            _, f_ex = self._excluded(x)
            _, f_rec = self._reciprocal(x)
        return self.prec.rnd(self._real_forces(x) + f_ex + f_rec
                             + self._solute_forces(x, self.lam))

    def energy(self, x, lam=None):
        """The potential energy (kJ/mol) at ``lam`` (default: the
        window's), without potential shifts."""
        return self.energies(x, [self.lam if lam is None else lam])[0]

    def energies(self, x, lams):
        """(K,) U at each lambda of ``lams``; the solvent's pairs, which do
        not read lambda, summed once."""
        x = x.to(self.prec.dtype)
        solvent = self._real_energy(x)
        return torch.stack([solvent + self._solute_energy(x, lam)
                            + self._scheduled_energy(x, lam)
                            for lam in lams])

    def pair_count(self, x):
        from roofline.count import count_pairs
        return count_pairs(x.to(torch.float64), self.L.to(torch.float64),
                           self.rc, self.molecule, self.lj_atom)

    def solute_pair_count(self, x):
        """(pairs with a solute atom inside rcoulomb, those of them that
        take the LJ term at the window's lambda)."""
        x = x.to(torch.float64)
        s = self.solute
        d = self.mic(x[None, :, :] - x[s][:, None, :])
        r2 = (d * d).sum(-1)
        other = (self.molecule != self.molecule[s[0]])[None, :]
        pairs = other & (r2 < self.rc ** 2)
        lj = (other & (r2 < self.rc_lj ** 2) & self.lj_atom[s][:, None]
              & self.lj_atom[None, :])
        if sterics(self.lam) == 0:
            lj = torch.zeros_like(lj)
        return int(pairs.sum()), int(lj.sum())
