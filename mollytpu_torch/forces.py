"""Force and energy dispatch (counterpart of mollytpu/forces.py:45-116):
the pair kernel over the cluster-pair list first, then the bonded lists,
then the general interactions (PME and the Ewald exclusion correction where
the system has them, the dispersion correction)."""

from __future__ import annotations

import torch

from .ops.bonded import all_specific_forces, specific_energy
from .ops.pair_kernel import block_nonbonded, build_fused_spec


def _pair(sys, neighbors, compute_energy):
    if neighbors is None:
        raise ValueError("pairwise interactions present but neighbors is None")
    spec = build_fused_spec(sys.pairwise_inters)
    return block_nonbonded(spec, sys.coords, sys.boundary, sys.atoms,
                           sys.exclusions, neighbors,
                           compute_energy=compute_energy)


def potential_energy(sys, neighbors=None, step_n=0):
    """Total potential energy (kJ/mol), a scalar tensor."""
    e = torch.zeros((), dtype=sys.coords.dtype, device=sys.device)
    if sys.pairwise_inters:
        _, e_nb, _ = _pair(sys, neighbors, True)
        e = e + e_nb
    for slist in sys.specific_lists:
        e = e + specific_energy(slist, sys.coords, sys.boundary)
    for gi in sys.general_inters:
        e = e + gi.energy(sys.coords, sys.boundary, sys.atoms)
    return e


def forces_virial(sys, neighbors=None, step_n=0, needs_virial=False):
    """(forces (N, 3) kJ/mol/nm, virial (3, 3) kJ/mol)."""
    fs = torch.zeros_like(sys.coords)
    vir = torch.zeros((3, 3), dtype=sys.coords.dtype, device=sys.device)
    if sys.pairwise_inters:
        f, _, v = _pair(sys, neighbors, needs_virial)
        fs = fs + f
        if v is not None:
            vir = vir + v
    # in place below: the accumulators are this function's own tensors
    if any(s.n_terms for s in sys.specific_lists):
        f, v = all_specific_forces(sys.specific_lists, sys.coords,
                                   sys.boundary, needs_virial=needs_virial)
        fs.add_(f)
        vir.add_(v)
    for gi in sys.general_inters:
        f, v = gi.force_virial(sys.coords, sys.boundary, sys.atoms,
                               needs_virial=needs_virial)
        fs.add_(f)
        vir.add_(v)
    return fs, vir
