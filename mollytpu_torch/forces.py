"""Force and energy dispatch (counterpart of mollytpu/forces.py:22-137).

Pairwise interactions split by ``use_neighbors``, as in the JAX package:
those without a list run the dense all-pairs engine; those with one run
the pair kernel when the list is the cluster-pair list (BlockPairs) and
the kernel's spec takes them all, the cell-tile engine on cell tiles
(ops/celltiles.py), else the neighbor-table engine (ops/nonbonded.py). A cluster-pair list with interactions the kernel
refuses raises: that list feeds the kernel only. Then the bonded lists,
then the general interactions (PME and the Ewald exclusion correction
where the system has them, the dispersion correction, implicit solvent),
PME under the span ``forces.pme``, the exclusion correction under
``forces.excl`` and the others under ``forces.general``.
Last, the forces on virtual sites move onto their parents; the virial
stays as computed at the site positions, as in the JAX package.
"""

from __future__ import annotations

import torch

from .ops import nonbonded
from .ops.blockpairs import BlockPairs
from .ops.bonded import all_specific_forces, specific_energy
from .ops.celltiles import CellTiles, tile_energy, tile_forces
from .ops.ewald import PME, EwaldExclusionCorrection
from .ops.pair_kernel import block_nonbonded, build_fused_spec
from .spatial import kinetic_energy as _kinetic_energy
from .tracing import span


def _general_span(inter):
    """The span of a general interaction's force call: PME and the Ewald
    exclusion correction have their own, the others share one."""
    name = type(inter).__name__
    if isinstance(inter, PME):
        return span("forces.pme", name)
    if isinstance(inter, EwaldExclusionCorrection):
        return span("forces.excl", name)
    return span("forces.general", name)


def _split_by_neighbors(inters):
    nonl = tuple(i for i in inters if not getattr(i, "use_neighbors", False))
    nl = tuple(i for i in inters if getattr(i, "use_neighbors", False))
    return nonl, nl


def _kernel_spec(nl, neighbors):
    """The pair kernel's spec for the listed interactions when the list is
    BlockPairs, None for a neighbor table."""
    if not isinstance(neighbors, BlockPairs):
        return None
    try:
        return build_fused_spec(nl)
    except NotImplementedError as err:
        raise NotImplementedError(
            f"{err}. The cluster-pair list (BlockPairFinder) feeds only the "
            "pair kernel: build the system with neighbor_finder=\"cell\" "
            "(CellListNeighborFinder) to run these interactions on the "
            "neighbor engine") from err


def _listed(nl, neighbors):
    if neighbors is None:
        raise ValueError(
            "neighbor-list interactions present but neighbors is None")
    return _kernel_spec(nl, neighbors)


def potential_energy(sys, neighbors=None, step_n=0):
    """Total potential energy (kJ/mol), a scalar tensor."""
    coords, boundary, atoms = sys.coords, sys.boundary, sys.atoms
    e = torch.zeros((), dtype=coords.dtype, device=sys.device)
    nonl, nl = _split_by_neighbors(sys.pairwise_inters)
    if nonl:
        mask = nonbonded.dense_pair_mask(sys.n_atoms, sys.exclusions,
                                         sys.device)
        e = e + nonbonded.dense_energy(nonl, atoms, coords, boundary, mask)
    if nl:
        spec = _listed(nl, neighbors)
        if spec is not None:
            _, e_nb, _ = block_nonbonded(spec, coords, boundary, atoms,
                                         sys.exclusions, neighbors,
                                         compute_energy=True)
            e = e + e_nb
        elif isinstance(neighbors, CellTiles):
            e = e + tile_energy(nl, atoms, coords, boundary, neighbors,
                                sys.neighbor_finder, sys.exclusions)
        else:
            e = e + nonbonded.neighbor_energy(nl, atoms, coords, boundary,
                                              neighbors)
    for slist in sys.specific_lists:
        e = e + specific_energy(slist, coords, boundary)
    for gi in sys.general_inters:
        e = e + gi.energy(coords, boundary, atoms)
    return e


def forces_virial(sys, neighbors=None, step_n=0, needs_virial=False):
    """(forces (N, 3) kJ/mol/nm, virial (3, 3) kJ/mol)."""
    with span("forces"):
        return _forces_virial(sys, neighbors, step_n, needs_virial)


def _forces_virial(sys, neighbors, step_n, needs_virial):
    coords, boundary, atoms = sys.coords, sys.boundary, sys.atoms
    fs = torch.zeros_like(coords)
    vir = torch.zeros((3, 3), dtype=coords.dtype, device=sys.device)
    nonl, nl = _split_by_neighbors(sys.pairwise_inters)
    if nonl:
        with span("forces.pairs", "dense"):
            mask = nonbonded.dense_pair_mask(sys.n_atoms, sys.exclusions,
                                             sys.device)
            f, v = nonbonded.dense_forces(
                nonl, atoms, coords, boundary, mask,
                velocities=sys.velocities, step_n=step_n,
                needs_virial=needs_virial)
        fs, vir = fs + f, vir + v
    if nl:
        spec = _listed(nl, neighbors)
        if spec is not None:
            with span("forces.pairs", "kernel"):
                f, _, v = block_nonbonded(spec, coords, boundary, atoms,
                                          sys.exclusions, neighbors,
                                          compute_energy=needs_virial)
            fs = fs + f
            if v is not None:
                vir = vir + v
        elif isinstance(neighbors, CellTiles):
            with span("forces.pairs", "tiles"):
                f, v = tile_forces(nl, atoms, coords, boundary, neighbors,
                                   sys.neighbor_finder, sys.exclusions,
                                   velocities=sys.velocities, step_n=step_n,
                                   needs_virial=needs_virial)
            fs, vir = fs + f, vir + v
        else:
            with span("forces.pairs", "neighbor"):
                f, v = nonbonded.neighbor_forces(
                    nl, atoms, coords, boundary, neighbors,
                    velocities=sys.velocities, step_n=step_n,
                    needs_virial=needs_virial)
            fs, vir = fs + f, vir + v
    if any(s.n_terms for s in sys.specific_lists):
        with span("forces.bonded"):
            f, v = all_specific_forces(sys.specific_lists, coords, boundary,
                                       needs_virial=needs_virial)
        fs, vir = fs + f, vir + v
    for gi in sys.general_inters:
        with _general_span(gi):
            f, v = gi.force_virial(coords, boundary, atoms,
                                   needs_virial=needs_virial)
        fs, vir = fs + f, vir + v
    if sys.virtual_sites is not None:
        fs = sys.virtual_sites.distribute_forces(coords, boundary, fs)
    return fs, vir


def forces(sys, neighbors=None, step_n=0):
    return forces_virial(sys, neighbors, step_n)[0]


def accelerations(sys, neighbors=None, step_n=0):
    """F / m, zero for massless sites."""
    f = forces(sys, neighbors, step_n)
    m = sys.masses
    positive = m > 0
    safe = torch.where(positive, m, torch.ones_like(m))
    return torch.where(positive[:, None], f / safe[:, None],
                       torch.zeros_like(f))


def kinetic_energy(sys):
    return _kinetic_energy(sys.masses, sys.velocities)


def total_energy(sys, neighbors=None, step_n=0):
    return potential_energy(sys, neighbors, step_n) + kinetic_energy(sys)
