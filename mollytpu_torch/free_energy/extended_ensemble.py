"""Extended state spaces for generalized-ensemble methods (counterpart of
mollytpu/free_energy/extended_ensemble.py).

A discrete space of thermodynamic states (lambda grids, temperature
ladders, umbrella windows as per-state bias potentials) with an active-state
cursor, consumed by the AWH and TSS drivers. Switching state returns a
System with new per-atom lambdas and the state's bias attached. The K-state
energy sweep (the span ``fep.cross``) evaluates one potential energy where
the selected lambdas are equal, else the cross energies: those of the
space's PerturbedTerms where it has them (free_energy/coupling.py: U at the
running lambda plus the change of the lambda-dependent terms, in float64),
else the AlchemicalPartition's (the shared part once, the perturbed part
per lambda on one list); and adds each state's bias energy on top.

``STATE_EVALUATIONS`` counts the states whose energy the sweep evaluated,
by path: "whole" (a whole-system energy per lambda, or one for states of
one lambda) and "perturbed" (the lambda-dependent terms), on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..forces import potential_energy
from ..tracing import span
from ..units import KB
from .thermo import AlchemicalPartition, ThermoState, set_lambda

#: path -> states whose energy state_energies evaluated on it
STATE_EVALUATIONS = {"whole": 0, "perturbed": 0}


@dataclasses.dataclass(frozen=True)
class ExtendedStateSpace:
    """Discrete space of ThermoStates, optionally with a per-state bias
    potential (a BiasPotential or another general interaction, or None),
    a boolean ``atom_mask`` of the atoms whose lambda the states set
    (None: every atom) and, optionally, the PerturbedTerms set up on that
    mask, which the cross energies then take."""

    states: Tuple[ThermoState, ...]
    biases: Tuple = None
    atom_mask: torch.Tensor = None
    perturbed_terms: object = None

    @classmethod
    def lambda_grid(cls, lambdas, temperature=300.0, atom_mask=None,
                    perturbed_terms=None):
        return cls(tuple(ThermoState(lam=float(l), temperature=temperature)
                         for l in lambdas), atom_mask=atom_mask,
                   perturbed_terms=perturbed_terms)

    @classmethod
    def temperature_ladder(cls, temperatures, lam=1.0):
        return cls(tuple(ThermoState(lam=lam, temperature=float(t))
                         for t in temperatures))

    @classmethod
    def umbrella_windows(cls, biases, temperature=300.0):
        """One state per bias potential (an umbrella window ladder)."""
        return cls(tuple(ThermoState(lam=1.0, temperature=temperature)
                         for _ in biases), biases=tuple(biases))

    @property
    def n_states(self):
        return len(self.states)

    def betas(self):
        return np.array([1.0 / (KB * float(s.temperature))
                         for s in self.states])

    def lambdas(self):
        return np.array([float(s.lam) for s in self.states])

    def pressures(self):
        return np.array([
            float(s.pressure) if s.pressure is not None else np.nan
            for s in self.states])

    # -- state application ---------------------------------------------------

    def apply_state(self, sys, index):
        """The System of state ``index`` (a host int): lambda set, the
        state's bias appended to the general interactions."""
        st = self.states[index]
        out = set_lambda(sys, float(st.lam), self.atom_mask)
        if self.biases is not None and self.biases[index] is not None:
            out = out.update(
                general_inters=sys.general_inters + (self.biases[index],))
        return out

    def integrator_for(self, simulator, index):
        """The simulator at this state's temperature."""
        st = self.states[index]
        if hasattr(simulator, "temperature"):
            return dataclasses.replace(simulator,
                                       temperature=float(st.temperature))
        return simulator

    # -- K-state energy sweep ------------------------------------------------

    def state_energies(self, sys, neighbors=None, indices=None):
        """U_k(x) of every state k, or of the states in ``indices``, as a
        float64 tensor on sys's device. ``sys`` is the UNBIASED system (no
        state bias attached). The energies are added in float64: the JAX
        package adds the biases in the system's dtype, where a float32
        total of ~1e5 kJ/mol rounds each window's bias to 0.016 kJ/mol."""
        with span("fep.cross"):
            return self._state_energies(sys, neighbors, indices)

    def _state_energies(self, sys, neighbors, indices):
        lams = self.lambdas()
        sel = (list(range(self.n_states)) if indices is None
               else [int(i) for i in indices])
        lams_sel = lams[sel]
        if np.all(lams_sel == lams_sel[0]):
            e = potential_energy(set_lambda(sys, float(lams_sel[0]),
                                            self.atom_mask), neighbors)
            es = e.double().expand(len(sel))
            path = "whole"
        elif self.perturbed_terms is not None:
            es = self.perturbed_terms.energies(sys, neighbors, lams_sel)
            path = "perturbed"
        else:
            es = AlchemicalPartition(self.atom_mask).cross_energies(
                sys, lams_sel, neighbors).double()
            path = "whole"
        STATE_EVALUATIONS[path] += len(sel)
        if self.biases is not None:
            zero = torch.zeros((), dtype=torch.float64, device=sys.device)
            es = es + torch.stack([
                zero if self.biases[k] is None else self.biases[k].energy(
                    sys.coords, sys.boundary, sys.atoms).double()
                for k in sel])
        return es

    def reduced_potentials(self, sys, neighbors=None, energies=None,
                           indices=None):
        """u_k = beta_k (U_k + p_k V), the generalized-ensemble reduced
        potential, float64; ``indices`` restricts the sweep to a subset."""
        if energies is None:
            energies = self.state_energies(sys, neighbors, indices=indices)
        sel = (slice(None) if indices is None
               else np.asarray([int(i) for i in indices]))
        betas = torch.as_tensor(self.betas()[sel], dtype=torch.float64,
                                device=energies.device)
        u = betas * energies
        press = self.pressures()[sel]
        if np.any(np.isfinite(press)):
            v = sys.boundary.volume().double()
            p = torch.as_tensor(np.where(np.isfinite(press), press, 0.0),
                                dtype=torch.float64, device=energies.device)
            u = u + betas * p * v
        return u


@dataclasses.dataclass
class ActiveThermoState:
    """Cursor into an ExtendedStateSpace."""

    space: ExtendedStateSpace
    index: int = 0

    @property
    def state(self):
        return self.space.states[self.index]

    def move(self, new_index):
        self.index = int(np.clip(new_index, 0, self.space.n_states - 1))
        return self.state
