"""LAMMPS's Lennard-Jones benchmark (``bench/in.lj`` in the LAMMPS source
tree, the "LJ" row of the LAMMPS benchmark page) as a System of the port.

in.lj in reduced units: an fcc lattice at density 0.8442 sigma^-3 of
20^3 unit cells (32,000 atoms), ``velocity all create 1.44``,
``pair_style lj/cut 2.5`` (truncated, not shifted), ``neighbor 0.3 bin``
with ``neigh_modify delay 0 every 20 check no``, ``fix nve``, 100 steps of
0.005 tau. Here in the JAX package's argon-like units
(``__graft_entry__.py``): sigma 0.34 nm, epsilon 1 kJ/mol, mass 40 u, so
tau = sigma sqrt(m / epsilon) = 2.1504 ps; the box is 33.592 sigma =
11.4211 nm, the cutoff 0.85 nm, the list radius 0.952 nm, the time step
0.010752 ps and T = 1.44 epsilon / kB = 173.19 K.

The pair energy of the lattice is -6.7733681 epsilon per atom (54
neighbours inside 2.5 sigma), the step-0 E_pair LAMMPS prints: it
depends on the lattice only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import boundary as bnd
from ..atoms import make_atoms
from ..config import resolve_device
from ..ops.cutoffs import DistanceCutoff
from ..ops.neighbors import CellListNeighborFinder
from ..ops.pairwise import LennardJones
from ..sim.integrators import VelocityVerlet
from ..spatial import remove_cm_motion, temperature
from ..system import System
from ..units import KB

SIGMA = 0.34             # nm
EPSILON = 1.0            # kJ/mol
MASS = 40.0              # u
TAU = SIGMA * math.sqrt(MASS / EPSILON)   # ps
DENSITY = 0.8442         # sigma^-3
CUTOFF = 2.5 * SIGMA     # lj/cut 2.5
SKIN = 0.3 * SIGMA       # neighbor 0.3 bin
EVERY = 20               # neigh_modify every 20 check no
DT = 0.005 * TAU         # ps
T_REDUCED = 1.44
TEMPERATURE = T_REDUCED * EPSILON / KB    # K
#: E_pair / N of the lattice, in epsilon
LATTICE_ENERGY = -6.7733681


def lattice_constant():
    """The fcc cell edge (nm): 4 atoms per cell at DENSITY."""
    return (4.0 / DENSITY) ** (1.0 / 3.0) * SIGMA


def fcc_lattice(n_cells):
    """(4 n_cells^3, 3) fcc positions (nm) and the cube's side (nm),
    as LAMMPS's ``lattice fcc`` + ``create_atoms``."""
    a = lattice_constant()
    basis = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5],
                      [0.0, 0.5, 0.5]])
    cells = np.stack(np.meshgrid(*[np.arange(n_cells)] * 3, indexing="ij"),
                     axis=-1).reshape(-1, 1, 3)
    return ((cells + basis[None]) * a).reshape(-1, 3), n_cells * a


def lj_bench_system(n_cells=20, dtype=torch.float32, device=None, seed=0,
                    n_steps=EVERY, t_reduced=T_REDUCED):
    """in.lj's System on ``device`` (the CUDA card unless the caller names
    another): the lattice, LennardJones with a 0.85 nm DistanceCutoff on
    the neighbor table, a CellListNeighborFinder of radius 0.952 nm
    rebuilt every ``n_steps`` steps and sized by its Poisson rule (not
    from the perfect lattice, whose uniform cells the melted liquid does
    not keep), and velocities at ``t_reduced`` epsilon / kB (in.lj's 1.44;
    in.melt, LAMMPS's 4,000-atom example, takes 3.0) drawn from a seeded
    generator with zero total momentum, scaled to the temperature exactly
    (3N - 3 degrees of freedom), as ``velocity create`` does. LAMMPS's own
    random sequence cannot be reproduced."""
    device = resolve_device(device)
    pos, side = fcc_lattice(n_cells)
    n = pos.shape[0]
    boundary = bnd.cubic(side, dtype=dtype, device=device)
    atoms = make_atoms(n=n, mass=MASS, sigma=SIGMA, epsilon=EPSILON,
                       dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    vels = torch.randn((n, 3), generator=gen, dtype=torch.float64,
                       device=device)
    masses = atoms.mass.to(torch.float64)
    vels = remove_cm_motion(masses, vels)
    vels = vels * math.sqrt(t_reduced * EPSILON / KB / float(
        temperature(masses, vels, 3 * n - 3)))
    finder = CellListNeighborFinder.setup(boundary, CUTOFF + SKIN, n,
                                          n_steps=n_steps)
    lj = LennardJones(cutoff=DistanceCutoff(CUTOFF), use_neighbors=True)
    return System(atoms=atoms, coords=torch.as_tensor(pos, dtype=dtype,
                                                      device=device),
                  boundary=boundary, velocities=vels.to(dtype),
                  pairwise_inters=(lj,), neighbor_finder=finder,
                  n_dof=3 * n - 3)


def lj_bench_integrator():
    """``fix nve`` at 0.005 tau: velocity Verlet, no centre-of-mass
    removal (the momentum is zero from the start)."""
    return VelocityVerlet(dt=DT, remove_cm=False)
