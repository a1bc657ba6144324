"""Coupling one molecule alchemically, and the terms of the energy that
read its lambda.

``couple_molecule`` is GROMACS's couple-moltype for a molecule of a PME
system (couple-lambda0 = none, couple-lambda1 = vdw-q): its atoms take the
role of an inserted molecule, Lennard-Jones and real-space Coulomb become
their Beutler soft-core forms under DefaultLambdaScheduler, and PME sums
the scheduled charges and subtracts the excluded and 1-4 pairs itself, on
the same scheduled charges. The Ewald exclusion correction, which keeps
the unscaled charges (the JAX package's convention, kept wherever a system
is put together by hand), is taken out: beside a scheduled PME it leaves
the molecule's reciprocal self-term wrong at every lambda below 1.

``PerturbedTerms`` gives U(lambda_k) as U(lambda_run) plus the change of
the terms that read lambda, summed in float64, as GROMACS computes foreign
lambdas from the perturbed interactions alone: the pairs of the perturbed
atoms, by the pair kernel's own pair terms (the arithmetic of its plain
twin), and PME's energy, a quadratic in the perturbed atoms' charges on
the same mesh and splines (``PME.charge_change_energy``). A float32 total
of a large box rounds to several kJ/mol; FEP needs the differences between
lambdas to a fraction of kT.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..atoms import ALCH_CORE, ALCH_INSERT
from ..forces import potential_energy
from ..ops.ewald import PME, EwaldExclusionCorrection
from ..ops.pair_kernel import _pair_terms_alch, build_fused_spec, pair_lambdas
from ..ops.pairwise import (CoulombSoftCoreBeutlerEwald, LennardJones,
                            LennardJonesSoftCoreBeutler)
from .alchemy import DefaultLambdaScheduler, scaled_charge

F64 = torch.float64

#: GROMACS's sc-alpha, on LJ and on the Ewald real space alike (sc-coul =
#: yes), with sc-power 1 and sc-r-power 6: Beutler's soft core
SC_ALPHA = 0.5


def couple_molecule(sys, atom_mask):
    """The system with the atoms of the boolean ``atom_mask`` coupled
    alchemically as an inserted molecule, at the lambda they had (1 where
    the atoms carried none, the system as it was; ``set_lambda`` moves
    it): Beutler soft-core LJ and soft-core Ewald real space at sc-alpha
    SC_ALPHA in place of LennardJones and CoulombEwald, and PME on the
    charges DefaultLambdaScheduler scales
    (sterics over lambda 0-0.5, charges over 0.5-1) with the Ewald
    exclusion correction's pairs moved into PME (``excl_i``, ``excl_j``).
    The system needs exactly one LennardJones, one CoulombEwald and one
    PME."""
    sched = DefaultLambdaScheduler()
    kinds = sorted(type(i).__name__ for i in sys.pairwise_inters)
    if kinds != ["CoulombEwald", "LennardJones"]:
        raise NotImplementedError(
            "couple_molecule needs LennardJones and CoulombEwald as the "
            f"pairwise interactions, got {kinds}")
    pmes = [g for g in sys.general_inters if isinstance(g, PME)]
    if len(pmes) != 1:
        raise NotImplementedError("couple_molecule needs one PME, got "
                                  f"{len(pmes)}")
    excls = [g for g in sys.general_inters
             if isinstance(g, EwaldExclusionCorrection)]
    pme = pmes[0]
    if excls:
        (excl,) = excls
        if excl.alpha != pme.alpha:
            raise ValueError("the exclusion correction's alpha is not PME's")
        pme = dataclasses.replace(pme, excl_i=excl.pair_i.to(torch.int64),
                                  excl_j=excl.pair_j.to(torch.int64))
    pme = dataclasses.replace(pme, scheduler=sched)

    pair = []
    for i in sys.pairwise_inters:
        if isinstance(i, LennardJones):
            pair.append(LennardJonesSoftCoreBeutler(
                cutoff=i.cutoff, alpha=SC_ALPHA,
                use_neighbors=i.use_neighbors, sigma_mixing=i.sigma_mixing,
                epsilon_mixing=i.epsilon_mixing, scheduler=sched,
                weight_special=i.weight_special))
        else:
            pair.append(CoulombSoftCoreBeutlerEwald(
                dist_cutoff=i.dist_cutoff, error_tol=i.error_tol,
                alpha_sc=SC_ALPHA, use_neighbors=i.use_neighbors,
                scheduler=sched, weight_special=i.weight_special,
                coulomb_const=i.coulomb_const, alpha=i.alpha,
                approximate_erfc=i.approximate_erfc))
    general = tuple(pme if isinstance(g, PME) else g
                    for g in sys.general_inters
                    if not isinstance(g, EwaldExclusionCorrection))

    a = sys.atoms
    mask = torch.as_tensor(atom_mask, dtype=torch.bool, device=sys.device)
    roles = (torch.full_like(mask, ALCH_CORE, dtype=torch.int32)
             if a.alch_role is None else a.alch_role)
    atoms = dataclasses.replace(
        a, alch_role=torch.where(mask, ALCH_INSERT, roles),
        lam=torch.ones_like(a.charge) if a.lam is None else a.lam)
    return sys.update(atoms=atoms, pairwise_inters=tuple(pair),
                      general_inters=general)


def _pairs_with(i, j, member):
    """The pairs (i, j) with an atom in the boolean numpy ``member``."""
    i, j = np.asarray(i, np.int64), np.asarray(j, np.int64)
    keep = member[i] | member[j]
    return i[keep], j[keep]


@dataclasses.dataclass(frozen=True)
class PerturbedTerms:
    """The terms of a system's energy that read the lambda of the atoms
    ``index``, for cross energies: ``energies`` gives U(lambda_k) as
    U(lambda_run) plus, summed in float64 for every lambda at once, the
    change of

    - every pair with a perturbed atom inside the pair kernel's cut_max,
      with its excluded and 1-4 pairs taken off or weighted as the kernel
      does, by the kernel's pair terms (ops/pair_kernel.py,
      ``_pair_terms_alch``). The pairs are the ``cap`` nearest atoms of
      each perturbed atom (``torch.topk``, so no host read), ``cap`` set
      from the box's mean density at twice the atoms a cut_max sphere
      holds; where a row's cap may have left out a partner inside
      cut_max, every energy of the call is NaN;
    - the scheduled PME's energy, a quadratic in the perturbed atoms'
      charges (``PME.charge_change_energy``).

    Set up once per system (``setup``); valid while the lambda of no other
    atom changes, which ExtendedStateSpace's ``atom_mask`` ensures when it
    is the mask given here."""

    index: torch.Tensor        # (S,) the perturbed atoms
    rank: torch.Tensor         # (N,) an atom's place in index, S elsewhere
    mask: torch.Tensor         # (N,) bool
    excl_i: torch.Tensor       # the excluded and 1-4 pairs with a
    excl_j: torch.Tensor       # perturbed atom, and whether each is 1-4
    special: torch.Tensor
    spec: object               # the pair kernel's FusedSpec
    pme: object                # the scheduled PME, or None
    cap: int                   # candidate partners per perturbed atom

    @classmethod
    def setup(cls, sys, atom_mask):
        spec = build_fused_spec(sys.pairwise_inters)
        if not spec.needs_lam or spec.scale_q:
            raise NotImplementedError(
                "PerturbedTerms takes the soft-core pair path (K1c) only")
        pmes = [g for g in sys.general_inters
                if getattr(g, "scheduler", None) is not None]
        if any(not isinstance(g, PME) for g in pmes) or len(pmes) > 1:
            raise NotImplementedError(
                "of the general interactions only one PME may read lambda")
        dev, n = sys.device, sys.n_atoms
        member = np.asarray(torch.as_tensor(atom_mask).cpu(), dtype=bool)
        idx = np.nonzero(member)[0]
        rank = np.full(n, len(idx), np.int64)
        rank[idx] = np.arange(len(idx))
        ex = sys.exclusions
        ei, ej = _pairs_with(ex.excl_i.cpu(), ex.excl_j.cpu(), member)
        si, sj = _pairs_with(ex.spec_i.cpu(), ex.spec_j.cpu(), member)
        sphere = n / float(sys.boundary.volume()) * 4.0 / 3.0 * math.pi \
            * spec.cut_max ** 3
        cap = min(n, 1 << int(math.ceil(math.log2(2.0 * sphere + 64.0))))

        def t(a, dtype=torch.int64):
            return torch.as_tensor(a, dtype=dtype, device=dev)
        return cls(index=t(idx), rank=t(rank), mask=t(member, torch.bool),
                   excl_i=t(np.concatenate([ei, si])),
                   excl_j=t(np.concatenate([ej, sj])),
                   special=t(np.r_[np.zeros(len(ei)), np.ones(len(si))],
                             torch.bool),
                   spec=spec, pme=pmes[0] if pmes else None, cap=cap)

    # -- the pairs ----------------------------------------------------------

    def _pair_list(self, sys):
        """Every pair with a perturbed atom the energy needs, flat: (i, j,
        r^2 in float64, 1-4 flag, weight, cap_ok). The scan's pairs (each
        unordered pair once, weight 1 inside cut_max), each excluded or
        1-4 pair again at full strength (weight -1) and each 1-4 pair
        weighted (weight 1); cap_ok is false where a row's cap may have
        left out a partner inside cut_max."""
        x, box = sys.coords, sys.boundary
        s, n, cap = self.index.shape[0], sys.n_atoms, self.cap
        cut2 = self.spec.cut_max ** 2
        order = torch.arange(s, device=x.device)[:, None]
        d = box.displacement(x[self.index][:, None, :], x[None, :, :])
        r2 = torch.where(self.rank[None, :] > order, (d * d).sum(dim=-1),
                         float("inf"))
        near, j_scan = torch.topk(r2, cap, dim=1, largest=False)
        cap_ok = (near[:, -1] > cut2 * (1.0 + 1e-4)).all() | (cap >= n)
        p = self.excl_i.shape[0]
        i = torch.cat([self.index[:, None].expand(s, cap).reshape(-1),
                       self.excl_i, self.excl_i])
        j = torch.cat([j_scan.reshape(-1), self.excl_j, self.excl_j])
        special = torch.cat([torch.zeros(s * cap + p, dtype=torch.bool,
                                         device=x.device), self.special])
        scan_on = (self.rank[j_scan] > order).reshape(-1)
        x64 = x.to(F64)
        dd = box.displacement(x64[i], x64[j])
        r2 = (dd * dd).sum(dim=-1)
        inside = r2 < cut2
        sign = torch.cat([scan_on.to(F64),
                          torch.full((p,), -1.0, dtype=F64, device=x.device),
                          self.special.to(F64)])
        weight = torch.where(inside, sign, 0.0)
        return i, j, torch.where(inside, r2, 1.0), special, weight, cap_ok

    def _pairs(self, pairs, atoms, lam):
        """(K,) pair energies at the per-atom lambdas ``lam`` (K, N)."""
        i, j, r2, special, weight, _ = pairs
        role = (torch.zeros_like(atoms.charge) if atoms.alch_role is None
                else atoms.alch_role).to(F64)
        sig, q = atoms.sigma.to(F64), atoms.charge.to(F64)
        sqeps = torch.sqrt(atoms.epsilon.to(F64))
        lam_s, lam_e = pair_lambdas(self.spec, lam[:, i], lam[:, j],
                                    role[i], role[j])
        e = _pair_terms_alch(self.spec, r2, 0.5 * (sig[i] + sig[j]),
                             sqeps[i] * sqeps[j], q[i] * q[j], special,
                             lam_s, lam_e)[0]
        return (e * weight).sum(dim=-1)

    # -- PME ----------------------------------------------------------------

    def _pme_change(self, sys, lam):
        """(K,) E_PME at the per-atom lambdas ``lam[1:]`` less E_PME at
        ``lam[0]``, the system's own: (K + 1, N) rows."""
        pme, a, i = self.pme, sys.atoms, self.index
        q = scaled_charge(pme.scheduler, a.charge.to(F64), lam[0],
                          a.alch_role)
        dq = scaled_charge(pme.scheduler, a.charge[i].to(F64), lam[1:, i],
                           a.alch_role[i]) - q[i]
        return pme.charge_change_energy(sys.coords, sys.boundary, q, i, dq)

    # -- the states ---------------------------------------------------------

    def energies(self, sys, neighbors, lams):
        """(K,) float64 U(lambda_k) of ``sys`` for each lambda in ``lams``
        set on the perturbed atoms: U at the system's own lambdas (one
        potential_energy) plus the change of the terms above."""
        u_run = potential_energy(sys, neighbors).to(F64)
        a = sys.atoms
        lam_run = (torch.ones_like(a.charge) if a.lam is None
                   else a.lam).to(F64)
        lam = torch.stack([lam_run] + [torch.where(self.mask, float(v),
                                                   lam_run) for v in lams])
        pairs = self._pair_list(sys)
        e = self._pairs(pairs, a, lam)
        du = e[1:] - e[0]
        if self.pme is not None:
            du = du + self._pme_change(sys, lam)
        return torch.where(pairs[-1], u_run + du, float("nan"))
