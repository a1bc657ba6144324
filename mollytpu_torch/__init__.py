"""mollytpu_torch: the PyTorch / CUDA port of mollytpu.

The JAX package ``mollytpu`` is the reference; this package mirrors its
module names and public layouts ((N, 3) coordinates and forces in nm and
kJ/mol/nm, (3, 3) virials, the internal units of ``units``). The hot pair
kernel is hand-written CUDA C++ for Hopper (``csrc/``), built with nvcc on
first use; every kernel has a plain PyTorch twin that CPU tensors use.
Entry points build on the CUDA card unless given ``device="cpu"``.
"""

from . import units
from .atoms import Atoms, make_atoms
from .boundary import (Orthorhombic, Triclinic, cubic, rectangular,
                       triclinic, triclinic_from_lengths_angles)
from .config import resolve_device
from .forces import forces_virial, potential_energy
from .models.forcefield import ForceField
from .models.setup import system_from_pdb
from .models.waterbox import DODECAHEDRON, TIP3P_XML, water_box_pdb
from .ops.cutoffs import (DistanceCutoff, NoCutoff, ShiftedForceCutoff,
                          ShiftedPotentialCutoff)
from .ops.general import LJDispersionCorrection
from .ops.pairwise import (Coulomb, CoulombEwald, CoulombReactionField,
                           LennardJones)
from .ops.blockpairs import BlockPairFinder, BlockPairs
from .sim.integrators import Langevin
from .sim.simulate import StaleNeighborList, run_chunk, simulate
from .spatial import (kinetic_energy, kinetic_energy_tensor, n_dof,
                      random_velocities, remove_cm_motion, temperature)
from .system import Exclusions, System
