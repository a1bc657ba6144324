"""Per-atom parameter tensors, structure of arrays
(counterpart of mollytpu/atoms.py)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import resolve_device

#: alchemical roles (mollytpu/atoms.py:23-26)
ALCH_CORE = 0
ALCH_INSERT = 1
ALCH_DELETE = 2


@dataclasses.dataclass(frozen=True)
class Atoms:
    """(N,) tensors: mass (u), charge (e), sigma (nm), epsilon (kJ/mol), an
    int32 force-field type id, the alchemical coupling parameter lam in
    [0, 1], the int32 alchemical role (ALCH_*) and, for Buckingham, the
    per-atom A (kJ/mol), B (1/nm) and C (kJ/mol nm^6), None when unused."""

    mass: torch.Tensor
    charge: torch.Tensor
    sigma: torch.Tensor
    epsilon: torch.Tensor
    atom_type: torch.Tensor = None
    lam: torch.Tensor = None
    alch_role: torch.Tensor = None
    buck_A: torch.Tensor = None
    buck_B: torch.Tensor = None
    buck_C: torch.Tensor = None

    def to(self, device=None, dtype=None):
        def cast(t, floating=True):
            if t is None:
                return None
            return t.to(device=device, dtype=dtype if floating else None)

        return Atoms(cast(self.mass), cast(self.charge), cast(self.sigma),
                     cast(self.epsilon), cast(self.atom_type, False),
                     cast(self.lam), cast(self.alch_role, False),
                     cast(self.buck_A), cast(self.buck_B), cast(self.buck_C))


def make_atoms(n=None, mass=1.0, charge=0.0, sigma=0.0, epsilon=0.0,
               atom_type=None, lam=1.0, alch_role=ALCH_CORE,
               buck_A=None, buck_B=None, buck_C=None,
               dtype=torch.float32, device=None):
    """Broadcast scalars or sequences to (N,) tensors on ``device`` (the
    CUDA card unless the caller names another)."""
    device = resolve_device(device)

    def arr(x, dt=dtype, size=n):
        t = torch.as_tensor(x, dtype=dt, device=device)
        if t.ndim == 0:
            if size is None:
                raise ValueError("n must be given when all params are scalars")
            t = torch.full((size,), t.item(), dtype=dt, device=device)
        return t

    mass_t = arr(mass)
    n_atoms = mass_t.shape[0]
    # the lambda fields default to scalars: they take the atom count
    lam_t = arr(lam, size=n_atoms)
    role_t = arr(alch_role, torch.int32, n_atoms)
    if atom_type is None:
        type_t = torch.zeros((n_atoms,), dtype=torch.int32, device=device)
    else:
        type_t = arr(atom_type, torch.int32)
    buck = {name: None if val is None else arr(val, size=n_atoms)
            for name, val in (("buck_A", buck_A), ("buck_B", buck_B),
                              ("buck_C", buck_C))}
    return Atoms(mass=mass_t, charge=arr(charge), sigma=arr(sigma),
                 epsilon=arr(epsilon), atom_type=type_t, lam=lam_t,
                 alch_role=role_t, **buck)


@dataclasses.dataclass
class AtomData:
    """Host-side per-atom metadata, numpy arrays that never go to the
    device (mollytpu/atoms.py:93-102): the trajectory writers' names."""

    atom_name: np.ndarray = None      # str
    residue_name: np.ndarray = None   # str
    residue_number: np.ndarray = None  # int
    chain_id: np.ndarray = None       # str
    element: np.ndarray = None        # str
    hetero_atom: np.ndarray = None    # bool
