"""One alchemical window of GROMACS's water benchmark as the port builds
it: the water cell's system (systems/gmx_water.py, started from the seed)
with the water whose oxygen is nearest the box centre coupled by
``couple_molecule`` (role INSERT, Beutler soft-core LJ and Ewald real
space, PME on the scheduled charges with the excluded pairs inside PME),
at lambda 1 until the protocol sets the window's. Its plain reference is
``reference/spc_water_fep.py``, which picks the solute by the same rule
from its own start and takes the window's lambda from ``inputs``."""

from __future__ import annotations

import torch

from systems import gmx_water


def solute_mask(system):
    """The atoms of the water whose oxygen lies nearest the box centre
    (waters are O, H, H in order)."""
    x = system.coords.to(torch.float64)
    oxygens = torch.arange(0, system.n_atoms, 3, device=x.device)
    near = torch.linalg.vector_norm(
        x[oxygens] - 0.5 * system.boundary.side_lengths.to(torch.float64),
        dim=1)
    first = int(oxygens[torch.argmin(near)])
    mask = torch.zeros(system.n_atoms, dtype=torch.bool, device=x.device)
    mask[first:first + 3] = True
    return mask


def build(cfg, seed, device, work):
    import mollytpu_torch as pt
    system, _ = gmx_water.build(cfg, seed, device, work)
    mask = solute_mask(system)
    return pt.couple_molecule(system, mask), {"mask": mask}


def reference(cfg, inputs, prec, device):
    from reference.spc_water_fep import SPCWaterFEP
    return SPCWaterFEP(cfg, prec, device, inputs["lambda"])
