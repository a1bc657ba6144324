"""Thermodynamic states and the alchemical window Hamiltonians
(counterpart of mollytpu/free_energy/thermo.py:27-121).

Setting lambda returns a System with new per-atom lambdas. The JAX package
maps the energy over the lambda axis with vmap; here it is a loop over the
windows that reuses the caller's neighbor list, which does not depend on
lambda (the pair kernel reads lambda per call).
"""

from __future__ import annotations

import dataclasses

import torch

from ..forces import potential_energy
from ..units import KB


@dataclasses.dataclass(frozen=True)
class ThermoState:
    """One thermodynamic state: lambda, temperature (K), pressure."""

    lam: float = 1.0
    temperature: float = 300.0
    pressure: float = None
    name: str = ""

    @property
    def beta(self):
        return 1.0 / (KB * self.temperature)


def set_lambda(sys, lam, atom_mask=None):
    """System with per-atom lambda set to ``lam`` (everywhere, or where the
    boolean ``atom_mask`` is true). Soft-core and scaled interactions and a
    scheduled PME read it."""
    cur = sys.atoms.lam
    new = (torch.full_like(cur, lam) if atom_mask is None
           else torch.where(atom_mask, torch.as_tensor(
               lam, dtype=cur.dtype, device=cur.device), cur))
    return sys.update(atoms=dataclasses.replace(sys.atoms, lam=new))


@dataclasses.dataclass(frozen=True)
class LambdaHamiltonian:
    """U(x; lambda); ``atom_mask`` selects the perturbed atoms (None: all)."""

    atom_mask: torch.Tensor = None

    def energy(self, sys, lam, neighbors=None):
        return potential_energy(set_lambda(sys, lam, self.atom_mask),
                                neighbors)

    def energies(self, sys, lams, neighbors=None):
        """(K,) U(x; lambda_k) for every lambda in ``lams``, on one list."""
        return torch.stack([self.energy(sys, float(lam), neighbors)
                            for lam in lams])


@dataclasses.dataclass(frozen=True)
class AlchemicalPartition:
    """The energy split into a shared part and a perturbed part, so cross
    energies of K states evaluate the shared part once. Perturbed are the
    pairwise interactions that read lambda (those with a scheduler, a lambda
    mixing or, through the zero-lambda shortcut of the LJ family, a sigma
    mixing) and the general interactions with a scheduler (PME on scheduled
    charges). The JAX package counts every general interaction as shared,
    so its cross energies miss the scheduled PME's change with lambda
    (mollytpu/free_energy/thermo.py:91-97); here they equal
    LambdaHamiltonian.energies."""

    atom_mask: torch.Tensor = None

    @staticmethod
    def _is_perturbed(inter):
        return (hasattr(inter, "scheduler") or hasattr(inter, "lambda_mixing")
                or hasattr(inter, "sigma_mixing"))

    def split(self, sys):
        pert = tuple(i for i in sys.pairwise_inters if self._is_perturbed(i))
        shared = tuple(i for i in sys.pairwise_inters
                       if not self._is_perturbed(i))
        g_pert = tuple(g for g in sys.general_inters
                       if getattr(g, "scheduler", None) is not None)
        g_shared = tuple(g for g in sys.general_inters
                         if getattr(g, "scheduler", None) is None)
        return (sys.update(pairwise_inters=shared, general_inters=g_shared),
                sys.update(pairwise_inters=pert, specific_lists=(),
                           general_inters=g_pert))

    def evaluate_energy(self, sys, lam, neighbors=None, shared_energy=None):
        """Total energy at lambda, reusing a cached shared part."""
        sys_shared, sys_pert = self.split(sys)
        if shared_energy is None:
            shared_energy = potential_energy(sys_shared, neighbors)
        return shared_energy + potential_energy(
            set_lambda(sys_pert, lam, self.atom_mask), neighbors)

    def cross_energies(self, sys, lams, neighbors=None):
        """(K,) energies at each lambda with the shared part computed once."""
        sys_shared, sys_pert = self.split(sys)
        e_shared = potential_energy(sys_shared, neighbors)
        return e_shared + torch.stack([potential_energy(
            set_lambda(sys_pert, float(lam), self.atom_mask), neighbors)
            for lam in lams])
