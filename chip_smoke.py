#!/usr/bin/env python3
"""On-card smoke run of mollytpu_torch, the PyTorch / CUDA port of mollytpu.

    python3 chip_smoke.py

needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc.
Phases, each printing one line or more before the next starts:

1. versions and the card (name and power limit from nvidia-smi);
2. build of the hand-written kernels from mollytpu_torch/csrc, with each
   kernel instance's registers and spills (a spill fails the run);
3. the pair kernel against its plain PyTorch twin on the same f32 inputs,
   forces-only and with energy + virial, on a 64-atom system with 1-4 and
   far-window exclusions in a cube and in a skewed triclinic box: every
   mode without alchemical lambda (K1a and K1b), then the alchemical
   path (K1c: soft-core LJ x soft-core / scaled Coulomb, 4 INSERT and 4
   DELETE atoms, five lambdas, each scheduler) and the scaled-charge
   family on K1a/K1b;
4. four main paths, each at 5,318 TIP3P waters (15,954 atoms, liquid
   density) built from the in-repo force field with rigid water and H-bond
   constraints, Langevin at 2 fs and 300 K, rebuild every 10 steps:
   PME in the cube (K1a), the reaction field (nonbonded_method="cutoff") in
   the cube and in the rhombic dodecahedron (K1b), and PME in the rhombic
   dodecahedron (K1b's Ewald instance with the triclinic minimum image,
   coul3-triclinic). For each: the kernel
   against its twin on the built system; the kernel's device time (CUDA
   events around 25 back-to-back launches of the C entry point, with
   torch.profiler's kernel time beside it), its time through the wrapper
   and the twin's (median of 25 calls each), the device operations of a
   forces-only wrapper call (the force fill and the launch, gated), and
   the kernel's bound; on the PME frame the
   roofline probes (probe_phase: distance_only and noocc against their
   twins, the device times of full, gather_only, distance_only, noocc and
   of the per-call chain with preponly and nogather, and their
   differences); then the launch counts set to 0,
   one 100-step warm-up chunk and 100-step timed chunks, the counts read;
   gates: every force evaluation launched the path's kernel instance,
   every SHAKE / RATTLE of the rigid waters launched the rigid-triangle
   kernel (csrc/rigid_triangles.cu; three a Langevin step),
   coordinates finite, constraints held, temperature sane, no stale list
   (no atom pair the list left out came inside the cutoff by any rebuild),
   and the f32 forces against a float64 evaluation through the plain twins;
   on the built cube, K1b's other modes timed against their twins, each
   with its bound;
5. after the PME main path, the NPT phase on its box: the steepest-
   descent minimizer on the lattice start (100 iterations on one list;
   energy and max|F| before and after; gates: the energy fell, the state,
   one launch per evaluation, no stale list); NPT-PME (MC): from the PME
   path's end state, Langevin with MonteCarloBarostat at OpenMM's defaults
   (1 bar, an attempt every 25 steps, isotropic, molecules scaled), a
   warm-up of at least 100 steps in pieces that end right after an attempt,
   and at the first accepted move the kernel against its twin at the moved
   box on the list built at the old one (K1a forces-only and with energy,
   and the energy instance timed with its bound); then 200 timed steps with
   the drift check between chunks; gates: launches exactly 1 + steps + 3
   per attempt (2 with energy), a move accepted, the volume within 5% of the
   start, the main-path gates and the float64 gate at the final box; a
   host-sync check over one rebuild interval holding an attempt, stepped
   under torch.cuda.set_sync_debug_mode("error"); the NPT step's
   components; NPT-PME (C-rescale): CRescaleBarostat (tau 1 ps, every 10
   steps, water's compressibility, rigid waters moved by their centres) in
   20-step pieces with the drift check between them, at least 100 steps
   and until the finder has been set up anew for the drifted box and a
   piece has run on it; the virial instance on the main path; the same
   gates but the volume band (without the constraint virial, as in the
   JAX package, the box expands) and the instantaneous pressure;
   then, on the PME path's end state, the bonded phase: every bonded kind
   (synthetic lists, one row per water) in f32 against a float64
   evaluation on the CPU (max|dF|/rms|F| < 1e-3, relative dE and dvirial
   < 1e-5), with the ms and device calls per all_specific_forces call;
   and MTS-PME: bench.py's MTS headline, MTSLangevinIntegrator at 4 fs
   outer steps with the pair kernel and the bonded lists twice and PME
   and its corrections once per outer step, a rebuild every 5 outer steps,
   50 warm-up and 100 timed outer steps (after 200 Langevin steps from
   the same state, timed as a yardstick); gates: K1a launched exactly
   1 + 2 per outer step, PME evaluated 1 + 1 per outer step, the main-path
   gates and the float64 gate, and 5 outer steps on one list under
   set_sync_debug_mode("error");
6. for the reaction field in the cube: CUDA-event times of the step's
   components and a torch.profiler summary of 20 steps; then Bonded-PME:
   the PME cube with flexible H-O-H angles (constraints="hbonds",
   rigid_water=False: 10,636 O-H constraints, 5,318 harmonic angles), the
   kernel against its twin on the built frame, the angle list's ms and
   device calls per evaluation, the main path (100 warm-up + 200 timed
   steps) with its gates, the float64 check including the angles, the
   step's components, and 10 steps on one list under
   set_sync_debug_mode("error");
7. the alchemical free-energy path (FEP-water): the PME water box with the
   water nearest the box centre inserted alchemically, Beutler soft-core
   LJ + Beutler soft-core Ewald real space (K1c) and PME on the scheduled
   charges. At lambda 1 the lambda instance against K1a on one frame; the
   lambda instance against its twin and K1a, timed; the roofline probes on
   the lambda instance at lambda 0.75; five lambda windows of
   100 + 200 Langevin steps, each sampling U(x; lambda_k) at all five
   lambdas every 20 steps; MBAR in float64 on the card against the same
   solve on the CPU; the main-path gates and the step's components.

8. LJ-bench: LAMMPS's bench/in.lj at 32,000 atoms
   (mollytpu_torch/models/ljbench.py) on the general pair path: the
   neighbor-table engine over a CellListNeighborFinder (sized by its
   Poisson rule), velocity Verlet, no pair kernel. Gates: the lattice's
   pair energy per atom against a numpy lattice sum (1e-4 in f32, 1e-9 in
   f64); in.lj's 100 steps with no overflow and no stale list at any
   rebuild, at its cadence of 20 or, where the exact stale-list check
   stops that run, at 10; the f32 NVE drift at most twice the f64 run's
   plus 1e-3 epsilon per atom; f32 forces (1e-4 of rms|F|) and energy
   (1e-5) against float64 on the frame after 100 steps; finite
   coordinates and T < 1000 K; no pair-kernel launch over the phase; the
   steps between two rebuilds under set_sync_debug_mode("error"). Then
   200 timed steps after 100 (ms/step, timesteps/s, katom-step/s,
   tau/day, ns/day), the step's components and a torch.profiler summary.
   On in.melt's frame (4,000 atoms, 10^3 cells, 3.0 epsilon / kB): the
   dense engine against the cell-list engine, and each new potential,
   cutoff, mixing rule and an NBFix table, f32 against f64 and the
   neighbor engine against the dense one. DPD: the pair noise on the
   card bit for bit the CPU's, and 20 DPDVelocityVerlet steps in float64
   on the card against the CPU (1e-9 nm).

9. after the PME-dodecahedron main path: 10 steps on one list under
   set_sync_debug_mode("error"); PME per evaluation with the box's cached
   influence function and with it recomputed (also on the PME cube); the
   step's components; the production phase through simulate from the
   path's end state: 200 steps with Temperature, KineticEnergy,
   PotentialEnergy and TotalEnergy loggers every 10 steps, ScalarPressure,
   Volume, Coordinates and an XTC TrajectoryWriter every 50 (gates: each
   log's record count, finite records, the first PE record against a
   direct potential_energy call, the XTC read back by the port's reader
   within 1e-3 nm of the logged coordinates, exact launch counts, the
   state), ms/step beside the bare path's and ms per XTC frame; a
   checkpoint, the generator's state identical after the load, and 10
   resumed steps within 1e-4 nm of 10 uninterrupted ones; the integrators
   phase: Verlet, StormerVerlet, NoseHoover and LangevinSplitting
   ("BAOAB", "BAOOAB"), 100 steps each with the state gates and one launch
   per step, ms/step each; OverdampedLangevin on Muller-Brown in float64,
   the card against the CPU on the same noise (1e-9 nm).

10. after Bonded-PME, the setup options: TIP4P-Ew-PME, the PME cube's
   lattice with 5,318 TIP4P-Ew waters (21,272 particles, M a virtual site
   of type average3; mollytpu_torch/data/tip4pew.xml), K1a against its
   twin on the frame, timed with its bound, the main path (100 + 200
   steps) with its gates (the float64 check moves the sites' forces onto
   their parents), after every chunk each site on its position within
   SITE_TOL nm and every site force row 0, n_dof 6 x 5,318 - 3, ms/step
   beside the TIP3P PME path's, PME per evaluation with the charged
   sites, the step's components (the sites' placement and force
   distribution among them), a rebuild interval under
   set_sync_debug_mode("error");
   LINCS-PME, the Bonded-PME box built with constraint_algorithm="lincs"
   (all 10,636 O-H constraints on LINCS, none on SHAKE), K1a against its
   twin, the main path with LINCS's violation under LINCS_TOL nm after
   every chunk, LINCS and SHAKE per call on the same frame and pairs, the
   step's components, a rebuild interval without a host sync;
   GROMACS-PME, the TIP3P cube
   written as .gro / .top with [ settles ] and built by
   system_from_gromacs (the neighbor-table engine over a cell list), its
   forces term by term and its energy against system_from_pdb's on the
   same coordinates (gated at TOL_GMX_FORCE and TOL_GMX_ENERGY), GMX_STEPS steps with the state
   gates and no pair-kernel launch; then the setup-option checks, each
   float32 on the card against float64 on the CPU: GB OBC2 and GBn2 on an
   open cluster of 1,000 TIP3P waters, a CMAP list on random five-atom
   chains and a random 24 x 24 grid, the global SHAKE sweeps on six-rings,
   and the four virtual-site types.

11. after FEP-water, the free-energy phases on the PME path's end state
   (K1a) and FEP-water's end state at lambda 0.75 (K1c), the CV the O-O
   distance from FEP-water's solute oxygen to the oxygen nearest it:
   Umbrella-MBAR, eight SquareBias windows (2,000 kJ/mol/nm^2, 0.25-0.60
   nm) each 50 + 100 steps from the previous window's end with the eight
   window energies every 10 steps (one energy launch each), MBAR on the
   card against the CPU, the PMF with error bars (mbar_pmf,
   pmf_with_uncertainty) on 14 bins from 0.24 to 0.66 nm, each window's
   mean CV within three sqrt(kT/k) of its centre; AWH-umbrella,
   AWHSimulation over the same windows (25 iterations of 20 steps) with
   its PMF backend; GridAWH, 20 updates of 20 steps on 16 bins from 0.24
   to 0.64 nm; AWH-lambda, AWHSimulation over a 12-rung lambda ladder on
   the inserted water (12 energy launches per sweep); TSS-lambda, two
   replicas from the ladder's ends over its 4-rung windows, 15 cycles of
   20 steps, the stitched free energies and, where every window has
   samples in two retained epochs, the jackknife. Gates: exact launches
   (one per force evaluation and one per lambda of each energy sweep), the
   state, no stale list at any rebuild of any segment, finite estimates,
   and the last frame of each phase against float64 through the plain
   twins (each state's energy, U_k - U_0, each bias's energy and forces).

12. the last modules. After MTS-PME, on the PME path's end state:
   T-REMD-PME, ReplicaExchangeMD with four replicas on a 300.0, 300.6,
   301.2, 301.8 K ladder (adjacent rungs this close exchange at 5,318
   waters), Langevin at each rung, 4 cycles of 50 steps; then
   Calculators: Calculator's energy and forces against potential_energy
   and forces_virial (one K1a energy launch, one forces launch), an
   ExternalCalculator wrapping a numpy harmonic tether on every oxygen
   for 50 Langevin steps beside 50 without it (its forces and energy
   against add_position_restraints' with the same k and references, the
   ms/step the host round trip adds), and NPT (C-rescale) with it and no
   fn_virial raising. After the free-energy phases, on FEP-water's end
   state: H-REMD-FEP, HamiltonianReplicaExchangeMD over lambda 1.0,
   0.75, 0.5, 0.25 of the inserted water, 3 cycles of 50 steps, each
   exchange's eight energies on lists built for them (K1c). Gates of
   both REMD phases: exact launches (per replica and cycle 1 + 50 force
   evaluations, and 1 (T-REMD) or 2 (H-REMD) with energy), no stale list,
   every exchange decision equal to the host's float64 recomputation
   from the printed energies and uniforms, velocities rescaled by exactly
   sqrt(T_i / T_j) (T-REMD; unscaled under H-REMD), the last cycle's
   energies against float64 twins, each replica's state; ms per
   replica-step beside the PME path's and ms per exchange. After
   LJ-bench: MC-LJ, MetropolisMonteCarlo on its 32,000-atom end state at
   its kinetic temperature, random_normal_translation(0.02), 500 moves
   on one neighbor table (gates: acceptance in (0.05, 1], the running
   energy against a fresh potential_energy, no pair-kernel launch, the
   table not stale at the end; ms per move); Gradients, dE/d(epsilon)
   through 20 velocity Verlet steps of simulate_differentiable on in.lj's
   float64 liquid (LJ-bench's f64 run), with and without per-step
   checkpointing, against the central difference on the card (2e-3),
   the peak memory of each, and a gradient through the pair kernel
   raising NotImplementedError without a launch.

13. the last public modules. After the Calculators, on the PME
   path's start frame: CellTiles-PME, the cell-tile engine (ops/
   celltiles.py, plain PyTorch: JAX's is XLA) on a CellTileFinder of the
   main paths' 1.15 nm radius (4^3 cells of capacity 352): its pair
   forces, energy and virial against K1a's on the frame (TOL_TILE_K1A;
   K1a launched uncounted, as the comparator) and against the float64
   tile engine (TOL_F64 off the cutoff), ms per tile_forces, tile_energy
   and find, then 10 + 40 Langevin steps (ms/step, no overflow, no stale
   table, no pair-kernel launch, the state, peak device memory) and one
   rebuild interval under set_sync_debug_mode("error"); Mesh, one T-REMD
   cycle of 5 steps on CellTiles-PME's end state through
   mesh=replica_mesh() against mesh=None from generators seeded alike,
   under torch.use_deterministic_algorithms, bit for bit, with the
   device count; Tuner, tune_launch on the PME end state (skin 0.15 nm
   at cadence 10, then 0.10, 0.20, 0.30 at cadence(s) = round(10 (s /
   0.15)^2)), each candidate's ms/step, the choice, and its round trip
   through the on-disk cache. After LJ-bench: CellTiles-LJ, in.lj's
   32,000 atoms on tiles (11^3 cells of capacity 64) at LJ-bench's
   cadence: the lattice energy (TOL_LJ_E0_F32), 100 NVE steps beside 100
   on the cell list from the same state (the tiles' drift at most twice
   the cell list's + LJ_DRIFT_SLACK), the tile forces and energy against
   the cell-list engine's on the end frame (TOL_ENGINES), ms/step and
   timesteps/s beside the cell list's, peak memory, no pair-kernel launch.

14. the cell-list kernel (csrc/cell_neighbors.cu), which every
   CellListNeighborFinder.find on the card launches. Over GROMACS-PME,
   LJ-bench, CellTiles-LJ, MC-LJ and Gradients, neighbors.FIND_LAUNCHES
   is set to 0 before each and read after it (gates: one launch per find
   on the card, no call of the twin find_plain there). After Gradients,
   Cell-kernel: the kernel against find_plain on the same card tensors
   (idx, special and overflow element for element; gated) on LJ-bench's
   end frame and on in.lj at the benchmark cell's 256,000 atoms melted
   100 steps, in f32 and f64, each with the kernel's device ms, the
   whole find's, the twin's and the bound of the table's bytes.
15. the rigid-triangle kernel (csrc/rigid_triangles.cu), which every
   SHAKE / RATTLE of rigid waters on the card launches. Over each main
   path with the phases after it, TIP4P-Ew-PME, GROMACS-PME and
   FEP-water with the free-energy phases, constraints.TRIANGLE_LAUNCHES
   is set to 0 before and read after (gate: one launch per call and
   TRIANGLE bucket). Then Triangle-kernel: SHAKE and RATTLE against the
   twin (the PyTorch solve) on the same card tensors, on the PME cube's
   and the PME dodecahedron's start frames (f32) and on GROMACS's water
   benchmark, 512,000 SPC waters laid out from the committed tile as the
   benchmark builds it (f32 and f64): the largest differences in float32
   ulps (gated in f32), each kernel's device ms, the whole call's, the
   twin's and the bound of its bytes; and on each frame the cluster-pair
   list's grid search against measuring every cluster pair (the same
   pairs, gated) and, on the two small frames, the stale-list check
   against every unlisted atom pair after random moves (gated).
16. the Lennard-Jones table kernel (csrc/lj_table.cu), which every
   neighbor_forces call on the card that its dispatch rule admits
   launches (a LennardJones alone, DistanceCutoff, Lorentz and geometric
   mixing, an orthorhombic or triclinic box, no gradient tracked). Its build is
   checked for spills before LJ-bench. Over LJ-bench, MC-LJ, Gradients
   and DPD, nonbonded.TABLE_LAUNCHES is set to 0 before each and read
   after it; the neighbor_forces calls on the card are counted as the
   rule admits or refuses them. Launch counts, gated: one per admitted
   call and none per refused one on every phase; LJ-bench: every force
   evaluation admitted (one launch each) and no autograd-engine call on
   the card; MC-LJ (energies only) and DPD (velocity-dependent): none
   admitted, no launch; Gradients: the gradient passes track epsilon and
   reach the engine, the central difference's passes (no gradient)
   launch the kernel. Then Table-kernel, on the Cell-kernel phase's
   frames: the kernel against the engine on the same card tensors
   (forces-only and with the virial, gated at TOL_TABLE), its device ms
   (torch.profiler), the whole call's, the engine's and the bound of its
   bytes.

The second-to-last line is a JSON object {"kernels": [...]}: the five
main-path instance families (K1a's launches those of the PME, Bonded-PME
and MTS-PME paths together; coul3-triclinic's those of PME-dodecahedron,
its production and resumed steps and the integrators phase), K1a on the
TIP4P-Ew-PME and on the LINCS-PME frame with those paths' launches, K1a
and K1c on each free-energy phase, on T-REMD-PME, H-REMD-FEP and the
Calculators phase with its launches (energy launches included), K1a's
energy and virial instance on the NPT path, coul3-triclinic's on the
production phase, then each kernel probe instance (wrong
physics on purpose, not on a main path; its launches are those of the
probe phase; LJ-bench, MC-LJ, Gradients, CellTiles-PME, CellTiles-LJ and
Mesh launch no pair kernel and have no entry of it; the Tuner's K1a
launches time candidates and are printed), then the cell-list kernel on
each Cell-kernel frame (its launches those of the five phases of 14, by
phase in launches_by_path), then each rigid-triangle kernel on each
Triangle-kernel frame (its launches those of the paths of 15, by path in
launches_by_path), then the table kernel on each Table-kernel frame (its
launches those of the four phases of 16, by phase in launches_by_path);
the last is
{"ok": true, "device": {...}}. Any failure raises and exits non-zero
before either is printed; so does a machine without a CUDA card.
"""

import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

N_WATERS = 5318          # 15,954 atoms, the 6mrr atom count
LIST_RADIUS = 1.15       # 1.0 nm cutoff + 0.15 nm skin
# rebuild cadence, the JAX package's system_from_pdb default: at 20 steps
# the lattice start, which heats the box well above 300 K before the
# thermostat catches it, moves unlisted atom pairs inside the cutoff and
# the stale-list check stops the run (PERF.md)
CADENCE = 10
DT, TEMP, FRICTION = 0.002, 300.0, 1.0
CHUNK = 100
SEED = 0
DEVICE = "cuda"
CUBE = (90.0, 90.0, 90.0)
DODECAHEDRON = (60.0, 60.0, 90.0)   # mollytpu_torch.models.waterbox

#: the main paths: label, nonbonded_method, cell angles, timed chunks,
#: and the kernel instance family each runs (pair_kernel.instance_family)
MAIN_PATHS = (("PME", "pme", CUBE, 2, "coul3-ortho"),
              ("RF-ortho", "cutoff", CUBE, 2, "coul2-ortho"),
              ("RF-dodecahedron", "cutoff", DODECAHEDRON, 2,
               "coul2-triclinic"),
              ("PME-dodecahedron", "pme", DODECAHEDRON, 2,
               "coul3-triclinic"))

#: the production phase on the PME-dodecahedron path's end state, through
#: simulate: loggers of T, KE, PE and E every PROD_LOG steps, of the
#: pressure, the volume and the coordinates and an XTC writer every
#: PROD_SLOW; then a checkpoint and RESUME_STEPS resumed steps against as
#: many uninterrupted ones
PROD_STEPS, PROD_LOG, PROD_SLOW, RESUME_STEPS = 200, 10, 50, 10
#: the XTC frames read back against the logged coordinates (the writer's
#: precision is 1e-3 nm); the resumed coordinates against the
#: uninterrupted run's; the logged PE against a direct call (PME's f32
#: index_add_ adds in no fixed order)
TOL_XTC, TOL_RESUME, TOL_PE_LOG = 1e-3, 1e-4, 1e-6
#: the integrators phase on the dodecahedron frame: steps per integrator,
#: Nose-Hoover's damping (ps); OverdampedLangevin on the Muller-Brown
#: surface, card against CPU in float64 with the same noise
INTEGRATOR_STEPS, NH_DAMPING = 100, 0.1
MB_N, MB_STEPS, TOL_MB = 8, 50, 1e-9

#: the alchemical main path: lambda windows, steps per window (warm-up,
#: sampled), steps between samples, the window that is timed and checked
#: against float64, and its kernel instance family
FEP_LAMS = (0.0, 0.25, 0.5, 0.75, 1.0)
FEP_WARMUP, FEP_STEPS, FEP_SAMPLE = 100, 200, 20
FEP_TIMED = 0.75
FEP_FAMILY = "lam-coul3-ortho"

#: kernel instances: Coulomb mode x box x energy x lambda (32), plus the
#: probes gather_only, distance_only, noocc for forces-only K1a and K1c
N_INSTANCES = 32 + 3 * 2
#: K1a's registers, forces-only / energy, in this design of the tile loop
#: (the box's minimum-image row read from constant memory per launch)
K1A_REGISTERS = ("50", "56")

#: the kernels line: one entry per instance family
FAMILIES = {
    "coul3-ortho": "pair_nonbonded K1a (LJ + Ewald real space, "
                   "orthorhombic)",
    "coul2-ortho": "pair_nonbonded K1b (LJ + reaction field, orthorhombic)",
    "coul2-triclinic": "pair_nonbonded K1b (LJ + reaction field, "
                       "triclinic)",
    "coul3-triclinic": "pair_nonbonded K1b (LJ + Ewald real space, "
                       "triclinic)",
    FEP_FAMILY: "pair_nonbonded K1c (soft-core LJ + soft-core Ewald real "
                "space at per-pair lambda, orthorhombic)",
}

#: the NPT phase on the PME box after its main path: the Monte Carlo
#: barostat at OpenMM's defaults (1 bar, an attempt every 25 steps,
#: isotropic, molecules scaled by their centres), warm-up and timed steps;
#: then C-rescale (tau 1 ps, every 10 steps) and the minimizer on the
#: lattice start
NPT_BAR, MC_EVERY, CRESCALE_EVERY, CRESCALE_TAU = 1.0, 25, 10, 1.0
NPT_WARMUP, NPT_STEPS, CRESCALE_STEPS, MIN_STEPS = 100, 200, 100, 100
#: C-rescale runs in pieces of this many steps with npt_resetup between
CRESCALE_PIECE = 2 * CADENCE
NPT_FAMILY = "coul3-ortho"
#: water's isothermal compressibility per bar (the JAX package's default
#: is ten times it; ROADMAP Queue 3)
WATER_COMPRESSIBILITY_PER_BAR = 4.6e-5
#: g/cm^3 per amu/nm^3
G_CM3_PER_AMU_NM3 = 1.66053906660e-3
#: the NPT path's volume gate: within 5% of the start
NPT_VOLUME_BAND = 0.05

#: the bonded slice: Bonded-PME is the PME cube with flexible H-O-H angles
#: (constraints="hbonds", rigid_water=False: 10,636 O-H constraints and
#: 5,318 harmonic angles), Langevin as the main paths; MTS-PME is
#: bench.py's MTS headline (bench.py:128-147) on the rigid PME box from the
#: PME path's end state: BAOAB-RESPA at 4 fs outer and 2 fs inner steps,
#: PME and its corrections once per outer step, the pair kernel and the
#: bonded lists twice, a rebuild every 5 outer steps
BONDED_FAMILY = "coul3-ortho"
MTS_DT, MTS_REBUILD, MTS_WARMUP, MTS_STEPS = 0.004, 5, 50, 100
#: the bonded phase: the card's f32 lists against a float64 evaluation of
#: the same lists on the CPU from the same coordinates (max|dF|/rms|F|;
#: relative energy and virial)
TOL_BONDED_FORCE, TOL_BONDED_REL = 1e-3, 1e-5

#: the setup-option paths (each at N_WATERS waters, Langevin as the main
#: paths): TIP4P-Ew-PME, the PME cube's lattice with four-site waters (M a
#: virtual site; 21,272 particles); LINCS-PME, the Bonded-PME box with its
#: O-H constraints on LINCS; GROMACS-PME, the TIP3P cube read from .gro /
#: .top with [ settles ], GMX_STEPS steps on the neighbor-table engine
TIP4P_FAMILY = LINCS_FAMILY = "coul3-ortho"
#: GROMACS-PME against system_from_pdb on the same coordinates, two f32
#: card paths that differ only in the neighbor engine's polynomial erfc
#: against CUDA's erfcf and PME's scatter order: 2.8e-6 to 3.2e-6 of
#: rms|F| and 6.8e-7 relative in the energy (three calls, PR 9). The
#: gates leave 30x and 15x; an LJ epsilon read 0.1% off moves the forces
#: by ~1e-3 of rms|F|. The list is system_from_gromacs's default (1.2 nm,
#: a rebuild every 10 steps) and a stale list fails the run.
GMX_STEPS, TOL_GMX_FORCE, TOL_GMX_ENERGY = 50, 1e-4, 1e-5
#: the gates: a site within SITE_TOL nm of the position its parents give
#: it after every chunk (the same float32 operations place it and check
#: it); LINCS's violation under LINCS_TOL nm after every chunk (order 4, 2
#: corrections in float32: tests/test_lincs.py's bound)
SITE_TOL, LINCS_TOL = 1e-6, 2e-5
#: the setup-option checks, float32 on the card against float64 on the
#: CPU: GB (OBC2, GBn2) on an open cluster of GB_WATERS TIP3P waters, a
#: CMAP list of CMAP_CHAINS chains, the global SHAKE sweeps on SHAKE_RINGS
#: six-rings, VSITES virtual sites of the four types; forces as max|dF|
#: over rms|F| (f32 sums over up to N = 3,000 partners, ~1e-5; CMAP's
#: float32 dihedral gradients, ~2e-4 for bond angles of 60-120 degrees)
#: and the energy relative
GB_WATERS, CMAP_CHAINS, SHAKE_RINGS, VSITES = 1000, 5000, 1000, 4000
TOL_OPTION_FORCE, TOL_OPTION_ENERGY = 1e-3, 1e-4
#: the global sweeps on the card (f32) against the CPU (f64), repeated
#: SHAKE_REPEATS times to show the spread of the card's unordered
#: index_add_ atomics: rings up to 9.64 nm from the origin, where an f32
#: ulp is 9.5e-7 nm, and 60 sweeps that each round every coordinate; the
#: reading was 4.964e-6 nm in two calls of PR 9, so 2e-5 nm (21 ulps)
#: leaves 4x; velocities 1.3e-4 nm/ps against 1e-3
SHAKE_REPEATS, TOL_SHAKE_POS, TOL_SHAKE_VEL = 5, 2e-5, 1e-3

#: the TPU kernel's probe sites the kernel probes replace
PROBE_SITES = {
    "gather_only": "mollytpu/ops/pallas_pairwise.py:685",
    "distance_only": "mollytpu/ops/pallas_pairwise.py:791",
    "noocc": "mollytpu/ops/pallas_pairwise.py:1178"}

# kernel against twin, both f32 on the same inputs: atomics and the tile
# loop reorder ~1e3-term sums of |F| up to ~1e3 kJ/mol/nm, so the force
# error is ~1e-6 of rms|F|; exact erfcf/expf on both sides (and the same
# Abramowitz-Stegun erfc and log/exp forms on the soft-core path). 1e-4
# leaves two decades; energy and virial sum ~1e7 pair terms: 1e-4
# relative (to max(1, |E|), the kernel keeps its sums across warps in
# double).
TOL_FORCE, TOL_ENERGY, TOL_VIRIAL = 1e-4, 1e-4, 1e-4
# f32 main path against a float64 evaluation of the same force field, over
# the atoms with no listed pair within NEAR_CUT nm of a cutoff: f32
# coordinates of a 5.4 nm box are 4.8e-7 nm apart, so the f32 minimum
# image and r^2 may put such a pair on the other side of the cutoff, where
# a truncated potential's force jumps (for an O-H pair under the reaction
# field by ~1 kJ/mol/nm, 1e-3 of rms|F|)
TOL_F64, NEAR_CUT = 1e-3, 2e-6
# the lambda instance at lambda 1 against K1a on one frame: the same pair
# terms but for the Abramowitz-Stegun erfc (absolute error < 1.5e-7, so
# ~1e-6 of a pair's screened term) against the exact erfcf, and rQ^(-1/6)
# through exp(-log(r^6)/6) against 1/r (a few ulps); 1e-5 leaves a decade
TOL_LAM1_FORCE, TOL_LAM1_ENERGY = 1e-5, 1e-5
# MBAR on the card against the same float64 solve on the CPU, in kT
TOL_MBAR = 1e-8

#: the free-energy phases after FEP-water, on the PME path's and
#: FEP-water's end states. The CV is the O-O distance from FEP-water's
#: solute oxygen to the oxygen nearest it at the phase's start.
#: Umbrella-MBAR: UMB_CENTERS windows of UMB_K kJ/mol/nm^2, each UMB_WARMUP
#: + UMB_STEPS steps from the previous window's end, the K window energies
#: every UMB_SAMPLE steps; the PMF on PMF_BINS (lo, hi, bins). UMB_STEPS
#: and AWH_ITERS were cut from 150 and 40 to keep the whole run near 500 s
#: with the replica, Monte Carlo, gradient and calculator phases
UMB_K = 2000.0
UMB_CENTERS = tuple(round(0.25 + 0.05 * k, 2) for k in range(8))
UMB_WARMUP, UMB_STEPS, UMB_SAMPLE = 50, 100, 10
PMF_BINS = (0.24, 0.66, 14)
#: a window's mean CV within UMB_SIGMAS standard deviations sqrt(kT / k)
#: of its centre
UMB_SIGMAS = 3.0
#: AWH over the umbrella windows (its PMF backend on AWH_GRID) and over
#: the lambda ladder: steps per segment, iterations; GridAWH on the CV:
#: (lo, hi, bins), updates of GRID_STEPS steps
AWH_MD, AWH_ITERS, AWH_GRID = 20, 25, (0.24, 0.64, 16)
GRID_AWH, GRID_UPDATES, GRID_STEPS = (0.24, 0.64, 16), 20, 20
#: the lambda ladder on FEP-water's inserted water (AWH-lambda starts at
#: rung LADDER_START); TSS: windows of TSS_WINDOW rungs, a replica from
#: each end of the ladder, steps per segment, cycles
N_LADDER, LADDER_START = 12, 8
TSS_WINDOW, TSS_STARTS, TSS_MD, TSS_CYCLES = 4, (0, 11), 20, 15
#: the last frame of each phase against float64 through the plain twins:
#: each state's energy relative (TOL_F64, as the main paths) and its
#: difference from state 0, U_k - U_0, in kJ/mol: the states share the f32
#: coordinates and all but the solute's or the bias's terms, so their
#: differences keep far less than the f32 total's rounding (~0.1 kJ/mol
#: of PME's f32 mesh sums at most); TOL_STATE_DIFF is 0.2 kT. A state
#: whose own terms are too large for f32 to hold U_k - U_0 to that (a
#: soft-core solute overlapping a solvent atom at a partly decoupled rung,
#: then taken at full sterics) is held to STATE_DIFF_ULPS f32 ulps of
#: |U_k - U_0| instead, the larger of the two: that replaces 0.5 kJ/mol
#: only above |U_k - U_0| = 2^18 kJ/mol. The readings it was set from,
#: TSS-lambda on an H100: 721.6 kJ/mol at a span of 1.25e9 kJ/mol (5.6
#: ulps) and 1.0 kJ/mol at 5.9e6 kJ/mol (2.0 ulps). A bfloat16 control,
#: the card's energies rounded to bfloat16, must fail the gate. A bias's
#: energy and forces relative to max(1, the float64 largest): the f32
#: distance carries ~5e-7 nm of coordinate rounding into k (d - d0).
TOL_STATE_DIFF, STATE_DIFF_ULPS, TOL_BIAS = 0.5, 16, 1e-4

# The kernel's bound: the largest of its bytes over the card's memory
# rate, its FP32 operations over the card's FP32 rate and its special-
# function operations over the special-function units' rate (H100 SXM at
# 700 W: 3.35 TB/s HBM3 and 67 TFLOP/s dense FP32, NVIDIA's datasheet; 16
# special-function results per SM per clock, CUDA C++ Programming Guide,
# at the 1.98 GHz that the 67 TFLOP/s assumes). Operations are counted per
# atom pair that this run's inputs make the kernel evaluate, from
# csrc/pair_nonbonded.cu with an FMA as 2 and sqrt, divide and rint as 1:
# every pair inside the cutoff pays the minimum image and r^2 (20
# orthorhombic, 26 triclinic), 1/r and 1/r^2 (3), its Coulomb term and the
# force accumulation (12); only the pairs with eps != 0 inside the LJ
# radius (lambda_s > 0 on the lambda path) pay the LJ term.
HBM_BYTES_PER_S, FP32_OPS_PER_S = 3.35e12, 67e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9
MIC_OPS = {False: 20, True: 26}
#: Coulomb none, plain, reaction field, Ewald (CUDA's erfcf ~20, expf ~3)
COUL_OPS = {0: 0, 1: 9, 2: 11, 3: 37}
#: LJ distance cutoff, shifted potential (+ the terms at rc), shifted
#: force (+ dU/dr at rc), no cutoff
LJ_OPS = {1: 18, 2: 27, 3: 38, 4: 18}
# the energy and virial instance adds per evaluated pair its Coulomb
# energy (none, plain, reaction field, Ewald) and the accumulation of the
# energy and the six virial entries (1 + 6 FMAs), and per pair that takes
# the LJ term the LJ energy (3)
COUL_ENERGY_OPS = {0: 0, 1: 2, 2: 3, 3: 2}
ACCUM_OPS, LJ_ENERGY_OPS = 13, 3
# K1c on the FEP path (Beutler soft-core LJ, Beutler soft-core Ewald):
# the lambda block 22 (min, roles, same-group rule, two schedules, lambda
# 0 rule), the soft-core Coulomb with the A&S screen 53 (sigma^6 shift,
# rQ^(-1/6) by log/exp, its force, the rational erfc and exp(-(a r)^2)),
# the Beutler LJ 32 (shift, R6, 1/R6, energy and force)
LAM_OPS, SC_EWALD_OPS, SC_LJ_OPS = 22, 53, 32

#: the small system's modes: (lj_mode, coul_mode, LJ radius, Coulomb
#: radius); radii differ both ways so each term's own mask is exercised
SMALL_MODES = ((1, 0, 0.9, 0.0), (2, 0, 0.9, 0.0), (3, 0, 0.9, 0.0),
               (1, 1, 0.8, 0.9), (2, 1, 0.9, 0.75), (3, 1, 0.8, 0.9),
               (1, 2, 0.9, 0.9), (2, 2, 0.8, 0.9), (3, 2, 0.9, 0.8),
               (4, 1, 0.0, 0.9), (4, 2, 0.0, 0.9), (1, 3, 0.9, 0.9))
#: K1b's other modes, timed on the water box in the cube at 1.0 nm radii:
#: (lj_mode, coul_mode); Ewald in the dodecahedron has its own main path
OTHER_MODES = ((1, 0), (2, 0), (3, 0), (1, 1), (2, 1), (3, 1), (4, 1),
               (2, 2), (3, 2), (4, 2))

#: K1c on the small system: the soft-core LJ kinds against every Coulomb
#: form of the lambda path, plus the mixed cases, at these lambdas
SMALL_LAMS = (0.0, 0.3, 0.5, 0.8, 1.0)
ALCH_COULS = ("none", "sc-beutler", "sc-gapsys", "sc-beutler-ewald",
              "sc-gapsys-ewald", "scaled", "rf-scaled", "ewald-scaled")
ALCH_CASES = ([(lj, c) for lj in ("beutler", "gapsys") for c in ALCH_COULS]
              + [("beutler-sp", "sc-beutler-ewald"),
                 ("lj", "sc-beutler-ewald"), ("lj", "sc-gapsys")])
SCHEDULERS = ("DefaultLambdaScheduler", "NAMDLambdaScheduler",
              "QuartersLambdaScheduler", "EleScaledLambdaScheduler")

#: LJ-bench: LAMMPS's in.lj (mollytpu_torch/models/ljbench.py), 20^3 fcc
#: cells (32,000 atoms), on the general pair path: the neighbor-table
#: engine over a CellListNeighborFinder, velocity Verlet (fix nve), no pair
#: kernel. in.lj rebuilds every 20 steps unchecked; the port's exact check
#: decides, and the run falls back to every 10 when a pair went missing
LJ_CELLS, LJ_RUN, LJ_SAMPLE = 20, 100, 10
LJ_WARMUP, LJ_TIMED = 100, 200
LJ_CADENCES = (20, 10)
#: the cell-list kernel (csrc/cell_neighbors.cu) against its twin
#: (find_plain) on the same card tensors: LJ-bench's end frame, and in.lj
#: at the benchmark cell's CELL_BIG^3 fcc cells (256,000 atoms) after
#: CELL_MELT NVE steps at the cell's rebuild every CELL_EVERY, in f32 and
#: on the same frame in f64
CELL_BIG, CELL_MELT, CELL_EVERY = 40, 100, 5
#: the Lennard-Jones table kernel (csrc/lj_table.cu) against the autograd
#: engine (neighbor_forces_plain) on the same card tensors, forces and
#: virial: max|dF| over rms|F| and max|dV| over max|V| (the reasons are in
#: tests/test_torch_lj_table_cuda.py, whose limits these are), on the
#: frames of the cell-list kernel's phase
TOL_TABLE = {"float32": 2e-5, "float64": 1e-12}
TABLE_INSTANCES = 8
#: the rigid-triangle kernel (csrc/rigid_triangles.cu) against its twin
#: (SHAKERattle's PyTorch solve, constraints._on_kernel off) on the same
#: card tensors: every atom of a frame moved by up to TRI_MOVE nm for a
#: step's SHAKE from the frame, standard-normal velocities for a RATTLE at
#: the moved frame. Gates, in units in the last place (ulps) of the
#: frame's largest float32 coordinate (positions; over DT for SHAKE's
#: velocities) or velocity (RATTLE): the kernel contracts products and
#: sums into FMAs and the twin rounds each, and the triclinic minimum image
#: is a matmul on the twin's side
TRI_MOVE, TRI_ULPS_X, TRI_ULPS_V = 0.004, 4, 32
#: Langevin's constraint solves per step: RATTLE after the kick and after
#: the O step, SHAKE after the drift (one launch each per TRIANGLE bucket)
TRI_PER_STEP = 3
#: GROMACS's water benchmark as the benchmark builds it: the SPC tile laid
#: out GMX_TILES^3 times (512,000 waters, 1,536,000 atoms), PME by
#: GROMACS's rules (ewald-rtol, fourierspacing, pme-order), a cluster-pair
#: list of radius GMX_RLIST around the GMX_RC cutoff
GMX_TILES, GMX_RC, GMX_RLIST = 8, 1.0, 1.2
GMX_RTOL, GMX_SPACING, GMX_ORDER = 1e-5, 0.12, 4
#: the cluster-pair list's grid search against measuring every cluster
#: pair (rows at a time), and the stale-list check against every unlisted
#: atom pair after every atom moved by GRID_MOVE nm x a standard normal
GRID_ROWS, GRID_MOVE = 512, 0.1
#: in.lj's gates: the lattice's pair energy per atom against the numpy sum
#: (f32, f64 on the card); f32 forces and energy against float64 on the
#: frame after 100 steps; the f32 NVE drift at most twice the f64 run's
#: plus 1e-3 epsilon per atom
TOL_LJ_E0_F32, TOL_LJ_E0_F64 = 1e-4, 1e-9
TOL_LJ_FORCE, TOL_LJ_ENERGY, LJ_DRIFT_SLACK = 1e-4, 1e-5, 1e-3
#: in.melt's size (10^3 cells, 4,000 atoms, velocity create 3.0): the
#: dense engine against the neighbor engine, and the other forms
MELT_CELLS, MELT_T, MELT_STEPS = 10, 3.0, 50
TOL_ENGINES, TOL_FORMS_F64 = 1e-5, 1e-4
#: DPD on the card against the CPU: a fluid of 1,536 unit masses at
#: density 3, 20 DPDVelocityVerlet steps in float64
DPD_N, DPD_STEPS, TOL_DPD = 1536, 20, 1e-9

REMD_TEMPS = (300.0, 300.6, 301.2, 301.8)
REMD_CYCLE, REMD_CYCLES = 50, 4
HREMD_LAMS, HREMD_CYCLES = (1.0, 0.75, 0.5, 0.25), 3
MC_MOVES, MC_SHIFT, TOL_MC_ENERGY = 500, 0.02, 1e-6
# in.lj's DistanceCutoff truncates: one pair crossing 0.85 nm between the
# two central-difference trajectories moves E by U(rc) ~ 0.016 kJ/mol,
# 816 of dE/d(epsilon) at h 1e-5 epsilon (measured on the H100); at 1e-8 a
# crossing is ~1e-3 as likely and float64 roundoff stays ~1e-8 relative
GRAD_STEPS, GRAD_H, TOL_GRAD = 20, 1e-8, 2e-3
TETHER_K, CALC_STEPS, TOL_CALC = 1000.0, 50, 1e-5
TOL_TETHER_FORCE, TOL_TETHER_ENERGY = 1e-2, 1e-4

#: the cell-tile engine (ops/celltiles.py) on the PME cube's start frame:
#: its pair forces, energy and virial against K1a's on the same frame
#: (f32 both: K1a's exact erfcf against the engines' Abramowitz-Stegun
#: erfc, under 1.5e-7 absolute, and f32 row sums of ~1e4 slots against
#: K1a's fixed-point and atomic sums), against the float64 tile engine
#: (TOL_F64 off the cutoff, as the main paths); then TILE_WARMUP +
#: TILE_STEPS Langevin steps at the main paths' cadence. The steps of
#: this phase, Mesh and CellTiles-LJ were cut from 100, 10 and 200 after
#: a whole run on a slow host took 598.0 s on an H100, above the 533.6 s
#: the run took before these phases
TOL_TILE_K1A = 1e-5
TILE_WARMUP, TILE_STEPS = 10, 40
#: LJ-bench on tiles: TILE_LJ_STEPS NVE steps from the lattice beside as
#: many on the cell list from the same state, the total energy every
#: LJ_SAMPLE steps; the tile forces against the cell-list engine's on the
#: tile run's end frame (the same f32 r^2 on both sides: TOL_ENGINES)
TILE_LJ_STEPS = 100
#: the replica mesh: one T-REMD cycle of MESH_CYCLE steps on the
#: CellTiles-PME end state through replica_mesh() and through mesh=None,
#: both under torch.use_deterministic_algorithms (PME's and SHAKE's
#: index_add_ sum in a fixed order there; the tile engine has no atomics,
#: K1 has float atomics and so is not on this phase's path)
MESH_CYCLE = 5
#: the launch tuner on the PME end state: the anchor skin 0.15 nm at the
#: main paths' cadence, then these skins
TUNE_SKIN, TUNE_SKINS = 0.15, (0.10, 0.20, 0.30)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def require_cuda():
    import torch
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA GPU is available; the port's "
                         "kernels run only on the card and there is no CPU "
                         "fallback")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line = card_line()
    print(f"card: {line}", flush=True)
    return line


def build_kernels():
    """Build csrc/pair_nonbonded.cu; print the time and, per instance
    (Coulomb mode, triclinic, energy, lambda, probe), ptxas's registers and
    spills, and K1a's registers against K1A_REGISTERS. Fails on a spill."""
    from mollytpu_torch.ops import native
    path, secs, log = native.build("pair_nonbonded")
    print(f"built {os.path.relpath(path)} in {secs:.1f} s" if secs else
          f"{os.path.relpath(path)} up to date (its ptxas log follows)",
          flush=True)
    inst, spill, regs_of, spills = None, "", {}, []
    for ln in log.splitlines():
        m = re.search(r"pair_nonbonded_kernelILi(\d)ELb([01])ELb([01])ELb"
                      r"([01])ELi(\d)E", ln)
        if "Compiling entry function" in ln and m:
            inst = m.groups()
        elif "spill" in ln:
            spill = ln.strip()
            if inst and re.search(r"[1-9]\d* bytes spill", spill):
                spills.append(inst)
        elif "registers" in ln and inst:
            regs = re.search(r"Used (\d+) registers", ln)
            regs_of[inst] = regs.group(1) if regs else ln.strip()
            print("  ptxas: instance coul={} triclinic={} energy={} "
                  "lambda={} probe={}: ".format(*inst)
                  + f"{regs_of[inst]} registers; {spill}", flush=True)
    # a library built before is checked from the log kept beside it
    if len(regs_of) != N_INSTANCES:
        raise RuntimeError(f"{len(regs_of)} kernel instances in the ptxas "
                           f"log, {N_INSTANCES} expected")
    if spills:
        raise RuntimeError(f"instances {spills} spill registers")
    k1a = (regs_of.get(("3", "0", "0", "0", "0")),
           regs_of.get(("3", "0", "1", "0", "0")))
    print(f"{len(regs_of)} instances, no spills; K1a registers forces-only "
          f"/ energy: {k1a[0]} / {k1a[1]} ({K1A_REGISTERS[0]} / "
          f"{K1A_REGISTERS[1]} in this design: "
          f"{'unchanged' if k1a == K1A_REGISTERS else 'CHANGED'})",
          flush=True)


def water_system(device, dtype, workdir, method, angles, rigid=True,
                 model="tip3p", algorithm="shake"):
    """The N_WATERS water box (seed SEED) in a cube or the dodecahedron:
    TIP3P, or TIP4P-Ew with its virtual site M; H-bond constraints (rigid
    water) on SHAKE or LINCS."""
    import mollytpu_torch as pt
    tag = "cube" if angles == CUBE else "dodeca"
    path = pt.water_box_pdb(os.path.join(workdir, f"water-{tag}-{model}.pdb"),
                            N_WATERS, seed=SEED, angles=angles, model=model)
    xml = pt.TIP4PEW_XML if model == "tip4pew" else pt.TIP3P_XML
    return pt.system_from_pdb(
        path, pt.ForceField(xml), nonbonded_method=method, dtype=dtype,
        device=device, constraints="hbonds", rigid_water=rigid,
        constraint_algorithm=algorithm, dist_neighbors=LIST_RADIUS,
        neighbor_n_steps=CADENCE)


def small_inters(lj_mode, coul_mode, lj_rc, coul_rc):
    import mollytpu_torch as pt
    cut = {1: pt.DistanceCutoff, 2: pt.ShiftedPotentialCutoff,
           3: pt.ShiftedForceCutoff}
    out = []
    if lj_mode:
        out.append(pt.LennardJones(
            cutoff=pt.NoCutoff() if lj_mode == 4 else cut[lj_mode](lj_rc),
            weight_special=0.5))
    if coul_mode == 1:
        out.append(pt.Coulomb(cutoff=pt.DistanceCutoff(coul_rc),
                              weight_special=0.8333))
    elif coul_mode == 2:
        out.append(pt.CoulombReactionField(dist_cutoff=coul_rc,
                                           weight_special=0.8333))
    elif coul_mode == 3:
        out.append(pt.CoulombEwald(dist_cutoff=coul_rc, alpha=3.0,
                                   weight_special=0.8333))
    return tuple(out)


def alch_inters(lj, coul, scheduler):
    """One combination of the lambda path on the small system: soft-core
    Beutler LJ (distance cutoff, or shifted potential for "beutler-sp"),
    Gapsys LJ (shifted force) or plain LJ, with a soft-core or scaled
    Coulomb form; radii differ so each term's own mask is exercised."""
    import mollytpu_torch as pt
    kw = dict(weight_special=0.5, scheduler=scheduler)
    if lj == "beutler":
        out = [pt.LennardJonesSoftCoreBeutler(
            cutoff=pt.DistanceCutoff(0.9), alpha=0.5, **kw)]
    elif lj == "beutler-sp":
        out = [pt.LennardJonesSoftCoreBeutler(
            cutoff=pt.ShiftedPotentialCutoff(0.85), alpha=0.5, **kw)]
    elif lj == "gapsys":
        out = [pt.LennardJonesSoftCoreGapsys(
            cutoff=pt.ShiftedForceCutoff(0.9), alpha=0.85, **kw)]
    else:
        out = [pt.LennardJones(cutoff=pt.DistanceCutoff(0.9),
                               weight_special=0.5)]
    kw = dict(weight_special=0.8333, scheduler=scheduler)
    forms = {
        "sc-beutler": lambda: pt.CoulombSoftCoreBeutler(
            cutoff=pt.DistanceCutoff(0.8), alpha=0.5, **kw),
        "sc-gapsys": lambda: pt.CoulombSoftCoreGapsys(
            cutoff=pt.DistanceCutoff(0.9), alpha=0.3, sigma_q=1.0, **kw),
        "sc-beutler-ewald": lambda: pt.CoulombSoftCoreBeutlerEwald(
            dist_cutoff=0.9, alpha_sc=0.5, alpha=3.0, **kw),
        "sc-gapsys-ewald": lambda: pt.CoulombSoftCoreGapsysEwald(
            dist_cutoff=0.9, alpha_sc=0.3, sigma_q=1.0, alpha=3.0, **kw),
        "scaled": lambda: pt.CoulombScaled(cutoff=pt.DistanceCutoff(0.8),
                                           **kw),
        "rf-scaled": lambda: pt.CoulombReactionFieldScaled(dist_cutoff=0.9,
                                                           **kw),
        "ewald-scaled": lambda: pt.CoulombEwaldScaled(dist_cutoff=0.9,
                                                      alpha=3.0, **kw),
    }
    if coul != "none":
        out.append(forms[coul]())
    return tuple(out)


def exclusion_system(device, box):
    """64 atoms with chain exclusions, 1-4 pairs and pairs whose id span
    exceeds the bitmap window, randomly placed (0.25 nm apart) in a 2.4 nm
    cube or a 2.6 nm 92/95/88 degree box; atoms 0-3 are alchemical INSERT,
    4-7 DELETE, the rest CORE atoms."""
    import numpy as np
    import torch
    import mollytpu_torch as pt
    n = 64
    if box == "cube":
        boundary = pt.cubic(2.4, dtype=torch.float64, device="cpu")
    else:
        boundary = pt.triclinic_from_lengths_angles(
            (2.6,) * 3, [math.radians(a) for a in (92.0, 95.0, 88.0)],
            dtype=torch.float64, device="cpu")
    h = boundary.box_matrix().numpy()
    rng = np.random.default_rng(SEED)
    pts = []
    while len(pts) < n:
        c = torch.as_tensor(rng.uniform(0.0, 1.0, 3) @ h)
        if pts and float(torch.linalg.vector_norm(boundary.displacement(
                torch.stack(pts), c[None]), dim=1).min()) <= 0.25:
            continue
        pts.append(c)
    x = torch.stack(pts)
    d = torch.linalg.vector_norm(boundary.displacement(
        x[:, None], x[None]), dim=-1).numpy()
    far = [(a, b) for a, b in zip(*np.nonzero((d > 0.05) & (d < 0.8)))
           if b - a > 31][:6]
    excl = ([(i, i + 1) for i in range(n - 1)]
            + [(i, i + 2) for i in range(n - 2)] + far[:3])
    spec = [(i, i + 3) for i in range(0, n - 3, 2)] + far[3:]
    q = rng.uniform(-0.5, 0.5, n)
    eps = rng.uniform(0.1, 0.3, n)
    eps[::5] = 0.0
    roles = np.full(n, pt.ALCH_CORE, dtype=np.int32)
    roles[:4] = pt.ALCH_INSERT
    roles[4:8] = pt.ALCH_DELETE
    atoms = pt.make_atoms(n=n, mass=10.0, charge=q - q.mean(),
                          sigma=rng.uniform(0.25, 0.35, n), epsilon=eps,
                          alch_role=roles, device=device)
    boundary = boundary.to(device=device, dtype=torch.float32)
    return pt.System(
        atoms=atoms, coords=x.to(device=device, dtype=torch.float32),
        boundary=boundary,
        exclusions=pt.Exclusions.build(n, excl, spec, device=device),
        neighbor_finder=pt.BlockPairFinder.setup(boundary, 1.0, n, atoms)
    ), len(far)


def kernel_vs_twin(spec, system, nb, exclude=None):
    """The kernel and its twin on this call's slot rows (kernel_inputs),
    forces-only and with energy + virial. Returns the kernel's forces-only
    max|dF| and the worst ratios over both launches (force over rms|F|,
    outside ``exclude``; energy and virial relative)."""
    import torch
    from mollytpu_torch.ops import pair_kernel as pk
    n = system.n_atoms
    nbk, lam_role, _ = pk.kernel_inputs(spec, system.coords, system.atoms,
                                        nb)
    out = {"df": 0.0, "ratio": 0.0, "de": 0.0, "dv": 0.0}
    for energy in (False, True):
        f, e, v = pk._pair_nonbonded_cuda(spec, nbk, system.boundary, n,
                                          energy, lam_role)
        f0, e0, v0 = pk.pair_nonbonded_plain(spec, nbk, system.boundary, n,
                                             energy, lam_role)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(f).all()):
            raise RuntimeError("kernel forces are not finite")
        err = (f - f0).abs().amax(dim=1)
        if exclude is not None:
            err = err[~exclude]
        df = float(err.max())
        # forces of 1 kJ/mol/nm at least: at lambda 0 every term may be off
        rms = max(1.0, float(f0.pow(2).sum(dim=1).mean().sqrt()))
        out["ratio"] = max(out["ratio"], df / rms)
        if energy:
            out["df_energy"] = df
            out["e"] = float(e0)
            out["de"] = abs(float(e) - float(e0)) / max(1.0, abs(float(e0)))
            out["dv"] = float((v - v0).abs().max()) / max(
                1.0, float(v0.abs().max()))
        else:
            out["df"], out["rms"] = df, rms
    out["ok"] = (out["ratio"] <= TOL_FORCE and out["de"] <= TOL_ENERGY
                 and out["dv"] <= TOL_VIRIAL)
    return out, nbk, lam_role


def compare(label, system, timing=False):
    """Kernel against twin on the same packed inputs, both modes; with
    ``timing`` also their CUDA-event times and the kernel's bound."""
    from mollytpu_torch.ops import pair_kernel as pk
    nb = system.neighbor_finder.find(system.coords, system.boundary,
                                     system.exclusions)
    spec = pk.build_fused_spec(system.pairwise_inters)
    n = system.n_atoms
    r, nbk, lam_role = kernel_vs_twin(spec, system, nb)
    line = (f"{label}: max|dF| {r['df']:.3e} rms|F| {r['rms']:.3e} ratio "
            f"{r['ratio']:.3e}; rel dE {r['de']:.3e} (E {r['e']:.6e}); rel "
            f"dvir {r['dv']:.3e}")
    print(line, flush=True)
    if not r["ok"]:
        raise RuntimeError(line + " exceeds the tolerance")
    out = {"max_abs_err": r["df"]}
    if timing:
        for energy in (False, True):
            t_d = device_ms(spec, nbk, system.boundary, n, lam_role, energy)
            t_k = _time(lambda: pk._pair_nonbonded_cuda(
                spec, nbk, system.boundary, n, energy, lam_role))
            t_p = _time(lambda: pk.pair_nonbonded_plain(
                spec, nbk, system.boundary, n, energy, lam_role))
            print(f"{label} energy={energy}: kernel {t_d:.4f} ms device "
                  f"(events over 25 back-to-back launches), {t_k:.4f} ms "
                  f"through the wrapper (median of 25 calls), plain twin "
                  f"{t_p:.4f} ms ({nb.n_pairs} cluster pairs, "
                  f"{nb.n_clusters} clusters)", flush=True)
            if not energy:
                out["ms"], out["plain_ms"] = t_d, t_p
            else:
                out["energy"] = dict(max_abs_err=r["df_energy"], ms=t_d,
                                     plain_ms=t_p)
        prof_ms, work = profiled(lambda: pk._pair_nonbonded_cuda(
            spec, nbk, system.boundary, n, False, lam_role), 25)
        line = (f"{label}: profiler kernel device time {prof_ms:.4f} ms per "
                f"forces-only call; {work:g} runtime calls that put work on "
                "the device per call")
        print(line, flush=True)
        # the force fill, the box row's copy and the launch, nothing else
        if work > 3:
            raise RuntimeError(line + ": more than the fill, the box row's "
                               "copy and the launch")
        out.update(bound(label, spec, nbk, system.boundary, n, lam_role))
        b = bound(f"{label} energy instance", spec, nbk, system.boundary, n,
                  lam_role, energy=True)
        out["energy"].update(bound_ms=b["bound_ms"], bound_by=b["bound_by"])
    return out


def pair_ops(spec, boundary):
    """(FP32 operations, special functions) per evaluated pair, and the
    same for the LJ term of a pair that takes it."""
    tri = getattr(boundary, "basis", None) is not None
    if spec.needs_lam:
        if (spec.lj_kind, spec.lj_mode, spec.coul_sc, spec.coul_mode) != (
                1, 1, 1, 3):
            raise ValueError("the lambda path's operations are counted for "
                             "the FEP combination only")
        # sqrt, 1/r; log and exp of rQ^(-1/6), 1/rQ, the A&S reciprocal
        # and exp(-(a r)^2); the Beutler LJ's 1/R6
        return (MIC_OPS[tri] + 3 + LAM_OPS + SC_EWALD_OPS + 12, 7), \
            (SC_LJ_OPS, 1)
    # sqrt, 1/r; the exponentials of erfcf and expf under Ewald
    return ((MIC_OPS[tri] + 3 + COUL_OPS[spec.coul_mode] + 12,
             4 if spec.coul_mode == 3 else 2),
            (LJ_OPS[spec.lj_mode] if spec.lj_mode else 0, 0))


def bound(label, spec, nb, boundary, n, lam_role=None, energy=False):
    """The least time the card could take for the forces-only launch, or
    with ``energy`` for the energy and virial launch."""
    from mollytpu_torch.ops import pair_kernel as pk
    family = pk.instance_family(spec, boundary)
    live, lj_live = pk.live_pair_count(spec, nb, boundary, n, lam_role)
    (ops_pair, sfu_pair), (ops_lj, sfu_lj) = pair_ops(spec, boundary)
    if energy:
        ops_pair += COUL_ENERGY_OPS[spec.coul_mode] + ACCUM_OPS
        ops_lj += LJ_ENERGY_OPS
    ops = live * ops_pair + lj_live * ops_lj
    sfu = live * sfu_pair + lj_live * sfu_lj
    nbytes = 4 * (nb.pos4.numel() + nb.lj2.numel() + nb.ids.numel()
                  + nb.bits.numel() + nb.pairs.numel() + 3 * n
                  + (lam_role.numel() if spec.needs_lam else 0)
                  + (2 * 7 if energy else 0))
    t_ops = max(ops / FP32_OPS_PER_S, sfu / SFU_OPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    by = "operations" if t_ops >= t_bytes else "bytes"
    ms = 1e3 * max(t_ops, t_bytes)
    print(f"{label} bound: {live:.0f} pairs inside {spec.cut_max} nm x "
          f"{ops_pair} FP32 ops + {lj_live:.0f} LJ pairs x {ops_lj} = "
          f"{ops:.4e} ops ({1e3 * ops / FP32_OPS_PER_S:.6f} ms at 67 "
          f"TFLOP/s); {sfu:.4e} special functions ({sfu_pair} + "
          f"{sfu_lj} per LJ pair; {1e3 * sfu / SFU_OPS_PER_S:.6f} ms); "
          f"{nbytes} bytes ({1e3 * t_bytes:.6f} ms at 3.35 TB/s); bound "
          f"{ms:.6f} ms by {by}", flush=True)
    return {"bound_ms": ms, "bound_by": by, "family": family,
            "bytes_ms": 1e3 * t_bytes, "live": live}


def _time(fn, warmup=3, reps=25):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(spec, nbk, boundary, n, lam_role=None, energy=False, probe="",
              lib=None, reps=25):
    """The kernel's own device time per launch: outputs allocated and
    zeroed once, CUDA events around ``reps`` back-to-back launches of the
    raw C entry point (after 3 warm-up launches), divided by ``reps``.
    ``lib`` is another build of the launcher (same C interface)."""
    import torch
    from mollytpu_torch.ops import native
    from mollytpu_torch.ops import pair_kernel as pk
    dev = nbk.pos4.device
    forces = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    ev = torch.zeros((7,), dtype=torch.float64, device=dev) if energy \
        else None
    args = pk.launch_args(spec, nbk, boundary, n, lam_role, forces, ev,
                          probe)
    fn = (lib or native.load("pair_nonbonded", pk._SIG)).pair_nonbonded_launch

    def launch():
        err = fn(*args[:-1])
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return burst_ms(launch, reps)


def burst_ms(fn, reps=25):
    """CUDA-event time per call of ``reps`` back-to-back calls of fn (after
    3 warm-up calls): the device's time when fn enqueues faster than the
    device runs it."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _dev_us(evt):
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def profiled(fn, reps, kernel="pair_nonbonded_kernel"):
    """torch.profiler over ``reps`` calls of fn (after one): (device ms per
    call of ``kernel``, the pair kernel by default, runtime calls per call
    that put work on the device: kernel launches, memsets and copies)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    kernel_us = sum(_dev_us(e) for e in avgs if kernel in e.key)
    work = sum(e.count for e in avgs if e.key.startswith(
        ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemsetAsync",
         "cudaMemcpyAsync", "cudaMemcpyToSymbolAsync")))
    return kernel_us / 1e3 / reps, work / reps


def probe_phase(label, system, full):
    """The roofline probes on the built frame (the port's counterpart of
    tools/pair_roofline.py): distance_only and noocc held against their
    twins, gather_only's forces zero; device times of the full kernel and
    of each kernel probe (device_ms, the full kernel first and last), and
    CUDA-event times of the per-call chain kernel_inputs + pair_nonbonded
    for the full kernel, preponly and nogather (25 back-to-back chains);
    then their differences. ``full`` is compare()'s result on the frame.
    Returns the probes' entries of the kernels line."""
    import torch
    from mollytpu_torch.ops import pair_kernel as pk
    spec = pk.build_fused_spec(system.pairwise_inters)
    box, n = system.boundary, system.n_atoms
    nb = system.neighbor_finder.find(system.coords, box, system.exclusions)
    nbk, lam_role, _ = pk.kernel_inputs(spec, system.coords, system.atoms,
                                        nb)
    pk.reset_launch_counts()
    entries = []
    t = {"full": device_ms(spec, nbk, box, n, lam_role)}
    for probe in pk.KERNEL_PROBES:
        f, _, _ = pk.pair_nonbonded(spec, nbk, box, n, False, lam_role,
                                    probe=probe)
        f0, _, _ = pk.pair_nonbonded_plain(spec, nbk, box, n, False,
                                           lam_role, probe=probe)
        torch.cuda.synchronize()
        df = float((f - f0).abs().max())
        rms = float(f0.pow(2).sum(dim=1).mean().sqrt())
        ok = df == 0.0 if probe == "gather_only" else df <= TOL_FORCE * rms
        line = (f"{label} probe {probe} against its twin: max|dF| {df:.3e}, "
                f"rms|F| {rms:.3e}" + (f", ratio {df / rms:.3e}" if rms
                                       else ""))
        print(line, flush=True)
        if not ok:
            raise RuntimeError(line + " exceeds the tolerance")
        t[probe] = device_ms(spec, nbk, box, n, lam_role, probe=probe)
        wrapper = _time(lambda: pk._pair_nonbonded_cuda(
            spec, nbk, box, n, False, lam_role, probe))
        plain = _time(lambda: pk.pair_nonbonded_plain(
            spec, nbk, box, n, False, lam_role, probe=probe), 1, 5)
        print(f"{label} probe {probe}: {t[probe]:.4f} ms device, "
              f"{wrapper:.4f} ms through the wrapper, twin {plain:.4f} ms",
              flush=True)
        # the least time of the probe's own work: its bytes; distance_only
        # also pays the minimum image, r^2 and the accumulation per live
        # pair, noocc the full pair terms
        tri = getattr(box, "basis", None) is not None
        bound_ms, by = full["bytes_ms"], "bytes"
        if probe == "distance_only":
            ops_ms = 1e3 * full["live"] * (MIC_OPS[tri] + 12) / FP32_OPS_PER_S
            bound_ms, by = max((bound_ms, by), (ops_ms, "operations"))
        elif probe == "noocc":
            bound_ms, by = full["bound_ms"], full["bound_by"]
        entries.append(dict(
            probe=probe, family=full["family"], max_abs_err=df,
            ms=t[probe], plain_ms=plain, bound_ms=bound_ms, bound_by=by))
    t["full again"] = device_ms(spec, nbk, box, n, lam_role)

    def chain(probe):
        def fn():
            nbc, lr, _ = pk.kernel_inputs(spec, system.coords, system.atoms,
                                          nb, probe=probe)
            pk.pair_nonbonded(spec, nbc, box, n, False, lr, probe=probe)
        return fn
    c = {p: burst_ms(chain(p)) for p in ("", "preponly", "nogather")}
    for e in entries:
        e["launches"] = pk.INSTANCE_LAUNCHES[f"{e['family']}+{e['probe']}"]
    full_ms = 0.5 * (t["full"] + t["full again"])
    print(f"{label} probes, device ms per launch (forces-only): full "
          f"{t['full']:.4f} and {t['full again']:.4f}, " + ", ".join(
              f"{p} {t[p]:.4f}" for p in pk.KERNEL_PROBES), flush=True)
    print(f"{label} roofline: pair terms (full - distance_only) "
          f"{full_ms - t['distance_only']:.4f} ms; slot test (distance_only"
          f" - gather_only) {t['distance_only'] - t['gather_only']:.4f} ms; "
          f"row loads + grid (gather_only) {t['gather_only']:.4f} ms; j-side "
          f"reduction (full - noocc) {full_ms - t['noocc']:.4f} ms",
          flush=True)
    print(f"{label} per-call chain kernel_inputs + pair_nonbonded, ms per "
          f"call over 25 back-to-back calls: full {c['']:.4f}, preponly "
          f"{c['preponly']:.4f}, nogather {c['nogather']:.4f}; launch + "
          f"kernel (full - preponly) {c[''] - c['preponly']:.4f}, the "
          f"coordinate gather (full - nogather) "
          f"{c[''] - c['nogather']:.4f}", flush=True)
    return entries


def small_modes(dev):
    """Every non-alchemical kernel mode against its twin on the 64-atom
    exclusion system, in the cube and in the skewed triclinic box."""
    for box in ("cube", "skewed"):
        system, n_far = exclusion_system(dev, box)
        print(f"exclusion system ({box}): 64 atoms, {n_far} far-window "
              "pairs", flush=True)
        for mode in SMALL_MODES:
            compare(f"exclusions64-{box} lj{mode[0]}/coul{mode[1]}",
                    system.update(pairwise_inters=small_inters(*mode)))


def small_alch_modes(dev):
    """K1c against its twin on the 64-atom exclusion system (4 INSERT, 4
    DELETE atoms), in the cube and the skewed box: every combination at
    five lambdas, each scheduler once, and the scaled-charge family
    alone on K1a/K1b. One line per combination: its worst ratios."""
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.free_energy import alchemy
    from mollytpu_torch.ops import pair_kernel as pk
    default = pt.DefaultLambdaScheduler()
    cases = [(lj, c, default, SMALL_LAMS) for lj, c in ALCH_CASES]
    cases += [("beutler", "sc-gapsys-ewald", getattr(alchemy, s)(),
               (0.4, 0.7)) for s in SCHEDULERS[1:]]
    cases += [("lj", c, default, (0.3, 0.8))
              for c in ("scaled", "rf-scaled", "ewald-scaled")]
    for box in ("cube", "skewed"):
        base, _ = exclusion_system(dev, box)
        nb = base.neighbor_finder.find(base.coords, base.boundary,
                                       base.exclusions)
        for lj, coul, sched, lams in cases:
            spec = pk.build_fused_spec(alch_inters(lj, coul, sched))
            worst = {"ratio": 0.0, "de": 0.0, "dv": 0.0}
            n_switch, families = 0, set()
            for lam in lams:
                system = pt.set_lambda(base.update(
                    pairwise_inters=alch_inters(lj, coul, sched)), lam)
                nbk, lam_role, _ = pk.kernel_inputs(
                    spec, system.coords, system.atoms, nb)
                near = gapsys_switch_atoms(spec, nbk, system.boundary,
                                           system.n_atoms, lam_role)
                n_switch += int(near.sum())
                r, _, _ = kernel_vs_twin(spec, system, nb, exclude=near)
                for k in worst:
                    worst[k] = max(worst[k], r[k])
                families.add(pk.instance_family(spec, system.boundary))
            line = (f"K1c {box} {lj}/{coul} "
                    f"{type(sched).__name__[:-len('LambdaScheduler')]} "
                    f"lambda {lams}: {'/'.join(sorted(families))}; worst "
                    f"dF/rms {worst['ratio']:.2e} dE {worst['de']:.2e} dvir "
                    f"{worst['dv']:.2e}; {n_switch} excluded at a Gapsys "
                    "switch")
            print(line, flush=True)
            if (worst["ratio"] > TOL_FORCE or worst["de"] > TOL_ENERGY
                    or worst["dv"] > TOL_VIRIAL):
                raise RuntimeError(line + " exceeds the tolerance")
            if spec.needs_lam != all(f.startswith("lam-") for f in families):
                raise RuntimeError(line + ": wrong kernel instance")
        torch.cuda.synchronize()


def _tile_pairs(spec, nb, boundary, n, lam_role=None):
    """Per chunk of listed tiles: the slot ids of both sides, r, and the
    pair parameters (sigma, eps, qq) and, given the lambda rows, the pair's
    (lambda_s, lambda_e), all (T, 32, 32)."""
    from mollytpu_torch.ops import pair_kernel as pk
    row, x, par, idc, bitc, chunks = pk._tiles(nb, boundary, 1024)
    lrc = None if lam_role is None else lam_role.view(-1, 32, 2)
    for I, J in chunks:
        _, r2, live, _ = pk._tile_geometry(spec, row, x[I], x[J], idc[I],
                                           idc[J], bitc[I], n)
        pi, pj = par[I], par[J]
        out = dict(
            ii=idc[I][:, :, None].expand_as(r2), jj=idc[J][:, None, :]
            .expand_as(r2), r=r2.sqrt(), live=live,
            sig=0.5 * (pi[:, :, None, 0] + pj[:, None, :, 0]),
            eps=pi[:, :, None, 1] * pj[:, None, :, 1],
            qq=pi[:, :, None, 2] * pj[:, None, :, 2])
        if lrc is not None:
            li, lj = lrc[I], lrc[J]
            out["lam_s"], out["lam_e"] = pk.pair_lambdas(
                spec, li[:, :, None, 0], lj[:, None, :, 0],
                li[:, :, None, 1], lj[:, None, :, 1])
        yield out


def _flag(flag, t, near):
    flag[t["ii"][near]] = True
    flag[t["jj"][near]] = True


def gapsys_switch_atoms(spec, nb, boundary, n, lam_role):
    """(n,) mask of the atoms in a live pair whose distance lies within
    NEAR_CUT of its Gapsys switch radius (r_LJ of the soft-core LJ, r_Q of
    the soft-core Coulomb): there f32 rounding may put the kernel and the
    twin on the two sides of the switch."""
    import torch
    flag = torch.zeros(n + 1, dtype=torch.bool, device=nb.pos4.device)
    if spec.lj_kind != 2 and spec.coul_sc != 2:
        return flag[:n]
    for t in _tile_pairs(spec, nb, boundary, n, lam_role):
        near = torch.zeros_like(t["live"])
        if spec.lj_kind == 2:
            # r_LJ = alpha (26 C12 (1 - l) / (7 C6))^(1/6), C12 / C6 = s^6
            r_lj = spec.lj_alpha * (26.0 / 7.0 * t["sig"] ** 6 * (
                1.0 - t["lam_s"])).clamp(min=0.0) ** (1.0 / 6.0)
            near |= (t["eps"] != 0) & ((t["r"] - r_lj).abs() < NEAR_CUT)
        if spec.coul_sc == 2:
            r_q = spec.coul_alpha_sc * (1.0 - t["lam_e"]).clamp(
                min=0.0) ** (1.0 / 6.0) * (1.0 + spec.coul_sigma_q
                                           * t["qq"].abs())
            near |= (t["r"] - r_q).abs() < NEAR_CUT
        _flag(flag, t, near & t["live"])
    return flag[:n]


def near_cutoff_atoms(spec, nb, boundary, n):
    """(n,) mask of the atoms in a listed pair whose distance lies within
    NEAR_CUT of one of the spec's cutoffs."""
    import torch
    radii = {spec.cut_max, spec.lj_rc, spec.coul_rc} - {0.0}
    flag = torch.zeros(n + 1, dtype=torch.bool, device=nb.pos4.device)
    for t in _tile_pairs(spec, nb, boundary, n):
        near = torch.zeros_like(t["live"])
        for rc in radii:
            near |= (t["r"] - rc).abs() < NEAR_CUT
        _flag(flag, t, near)
    return flag[:n]


def f64_system(sys32, coords32):
    """sys32 in float64 on its device at coords32, with a float64
    cluster-pair list built there."""
    import torch
    import mollytpu_torch as pt
    system = pt.System(
        atoms=sys32.atoms.to(dtype=torch.float64),
        coords=coords32.double(), boundary=sys32.boundary.to(
            dtype=torch.float64),
        pairwise_inters=sys32.pairwise_inters,
        specific_lists=tuple(s.to(dtype=torch.float64)
                             for s in sys32.specific_lists),
        general_inters=tuple(
            g if not hasattr(g, "moduli_x") else dataclasses.replace(
                g, moduli_x=g.moduli_x.double(),
                moduli_y=g.moduli_y.double(), moduli_z=g.moduli_z.double())
            for g in sys32.general_inters),
        exclusions=sys32.exclusions,
        neighbor_finder=pt.BlockPairFinder.setup(
            sys32.boundary.to(dtype=torch.float64), LIST_RADIUS,
            sys32.n_atoms, sys32.atoms.to(dtype=torch.float64)))
    nb = system.neighbor_finder.find(system.coords, system.boundary,
                                     system.exclusions)
    return system, nb


def f64_forces_energy(system, nb):
    """Forces and potential energy of a f64_system through the plain
    twins: the pair terms, their far-pair corrections, the bonded lists and
    the general interactions; with the kernel's spec and rows."""
    import mollytpu_torch as pt
    from mollytpu_torch.ops import pair_kernel as pk
    spec = pk.build_fused_spec(system.pairwise_inters)
    nbk, lam_role, charge = pk.kernel_inputs(spec, system.coords,
                                             system.atoms, nb)
    f, e, v = pk.pair_nonbonded_plain(spec, nbk, system.boundary,
                                      system.n_atoms, True, lam_role)
    f, e, v = pk.far_pair_corrections(spec, system.coords, system.boundary,
                                      system.atoms, system.exclusions, f, e,
                                      v, charge)
    f = f + pt.all_specific_forces(system.specific_lists, system.coords,
                                   system.boundary)[0]
    for sl in system.specific_lists:
        e = e + pt.specific_energy(sl, system.coords, system.boundary)
    for g in system.general_inters:
        fg, _ = g.force_virial(system.coords, system.boundary, system.atoms)
        f = f + fg
        e = e + g.energy(system.coords, system.boundary, system.atoms)
    return f, e, spec, nbk


def reference_forces(sys32, coords32):
    """Forces and potential energy of the full force field (bonded lists
    included) on coords32, evaluated in float64 through the plain twins on
    the card, and the atoms near a cutoff (near_cutoff_atoms)."""
    system, nb = f64_system(sys32, coords32)
    f, e, spec, nbk = f64_forces_energy(system, nb)
    near = near_cutoff_atoms(spec, nbk, system.boundary, system.n_atoms)
    vs = sys32.virtual_sites
    if vs is not None:
        vs = dataclasses.replace(vs, weights=vs.weights.double(), coef=None)
        f = vs.distribute_forces(system.coords, system.boundary, f)
        # a site near a cutoff makes its parents so
        near[vs.parents[near[vs.site_idx]].reshape(-1)] = True
    return f, e, near


def describe(system):
    box = system.boundary
    if hasattr(box, "basis"):
        shape = (f"rhombic dodecahedron of edge {float(box.basis[0, 0]):.4f}"
                 f" nm (widths {min(box.perp_widths()):.4f}-"
                 f"{max(box.perp_widths()):.4f} nm)")
    else:
        shape = f"{float(box.side_lengths[0]):.4f} nm cube"
    mesh = [g.mesh_dims for g in system.general_inters
            if hasattr(g, "mesh_dims")]
    bonded = ", ".join(f"{sl.kind} {sl.n_terms}"
                       for sl in system.specific_lists)
    return (f"{system.n_atoms} atoms in a {shape}, "
            f"{system.constraints[0].n_constraints} constraints, "
            + (f"PME mesh {mesh[0]}" if mesh else "reaction field")
            + f"; bonded lists: {bonded or 'none'}")


def check_state(label, system):
    """Finite coordinates, constraints held, temperature sane; returns
    (temperature, constraint violation)."""
    import torch
    import mollytpu_torch as pt
    if not bool(torch.isfinite(system.coords).all()):
        raise RuntimeError(f"{label}: non-finite coordinates after the run")
    viol = float(system.constraints[0].max_violation(system.coords,
                                                     system.boundary))
    temp = float(pt.temperature(system.masses, system.velocities,
                                system.n_dof))
    if not viol < 1e-4:
        raise RuntimeError(f"{label}: constraint violation {viol:.3e} nm")
    if not (temp == temp and temp < 1000.0):
        raise RuntimeError(f"{label}: temperature {temp} K")
    return temp, viol


def check_f64(label, system, f32, e32):
    """The f32 forces and energy against a float64 evaluation of the same
    force field through the plain twins, on the same coordinates."""
    f64, e64, near = reference_forces(system, system.coords)
    rms = float(f64.pow(2).sum(dim=1).mean().sqrt())
    err = (f32.double() - f64).abs().amax(dim=1) / rms
    df = float(err[~near].max())
    de = abs(float(e32) - float(e64)) / abs(float(e64))
    print(f"{label} vs float64 twins: max|dF|/rms|F| {df:.3e} over the "
          f"{int((~near).sum())} atoms with no pair within {NEAR_CUT} nm of "
          f"the cutoff ({float(err[near].max()) if near.any() else 0.0:.3e}"
          f" over the other {int(near.sum())}), rel dE {de:.3e} "
          f"(E {float(e64):.6e} kJ/mol)", flush=True)
    if df > TOL_F64 or de > TOL_F64:
        raise RuntimeError(f"{label}: forces disagree with the float64 "
                           "reference")


def main_path(label, system, n_chunks, family, after_chunk=None):
    """Drive the main path from the built system; check its gates, and
    ``after_chunk(system, aux)`` after the warm-up and each timed chunk."""
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.ops import constraints
    from mollytpu_torch.ops import pair_kernel as pk
    dev = system.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    system = system.update(
        velocities=pt.random_velocities(system.masses, TEMP, gen))
    sim = pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)

    pk.reset_launch_counts()
    tri0, n_tri = constraints.TRIANGLE_LAUNCHES, triangle_buckets(system)
    t0 = time.perf_counter()
    system, nb, aux = pt.simulate(system, sim, CHUNK, generator=gen)
    torch.cuda.synchronize()
    print(f"{label}: warm-up chunk of {CHUNK} steps: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if after_chunk is not None:
        after_chunk(system, aux)
    step, closest, elapsed = CHUNK, math.inf, 0.0
    for _ in range(n_chunks):
        # simulate()'s own loop, which also returns the stale-list check's
        # reading: the closest unlisted atom pair, or a lower bound on it
        # that is at least the cutoff
        t0 = time.perf_counter()
        system, nb, aux, near = pt.run_chunk(sim, system, nb, aux, step,
                                             CHUNK, generator=gen)
        torch.cuda.synchronize()
        elapsed += time.perf_counter() - t0
        closest = min(closest, near)
        step += CHUNK
        if after_chunk is not None:
            after_chunk(system, aux)
    launches = pk.LAUNCHES
    own = pk.INSTANCE_LAUNCHES[family]
    n_evals = 1 + step            # init_aux + one per step
    if launches != n_evals or own != n_evals:
        raise RuntimeError(
            f"{label}: pair kernel launched {launches} times ({own} of "
            f"instance {family}) for {n_evals} force evaluations")
    tri = constraints.TRIANGLE_LAUNCHES - tri0
    print(f"{label}: {tri} rigid-triangle kernel launches for {step} steps "
          f"({tri / step:g} a step, {n_tri} TRIANGLE bucket(s))", flush=True)
    if tri != TRI_PER_STEP * n_tri * step:
        raise RuntimeError(f"{label}: the rigid-triangle kernel launched "
                           f"{tri} times in {step} steps, "
                           f"{TRI_PER_STEP * n_tri * step} expected")
    temp, viol = check_state(label, system)
    ms = 1e3 * elapsed / (n_chunks * CHUNK)
    ns_day = pt.units.ps_per_step_to_ns_per_day(DT, ms * 1e-3)
    print(f"{label}: {step} steps, {launches} pair-kernel launches "
          f"(instance {family}) for {n_evals} force evaluations; "
          f"T {temp:.2f} K, max constraint violation {viol:.3e} nm, "
          f"{nb.n_pairs} cluster pairs; unlisted atom pairs at the timed "
          f"chunks' rebuilds at least {closest:.4f} nm apart", flush=True)
    print(f"{label}: {ms:.4f} ms/step, {ns_day:.4f} ns/day "
          f"({n_chunks * CHUNK} timed steps)", flush=True)
    check_f64(label, system, aux["forces"], pt.potential_energy(system, nb))
    return dict(launches=launches, ms=ms, ns_day=ns_day, system=system,
                nb=nb, aux=aux, sim=sim, gen=gen, step=step)


@contextlib.contextmanager
def uncounted():
    """Pair-kernel launches inside are not counted: the checks of a kernel
    against its twin in the middle of a main path."""
    from mollytpu_torch.ops import pair_kernel as pk
    saved = (pk.LAUNCHES, pk.INSTANCE_LAUNCHES.copy(),
             pk.ENERGY_LAUNCHES.copy())
    try:
        yield
    finally:
        pk.LAUNCHES = saved[0]
        for counter, old in zip((pk.INSTANCE_LAUNCHES, pk.ENERGY_LAUNCHES),
                                saved[1:]):
            counter.clear()
            counter.update(old)


def density(system):
    """g/cm^3 of the system in its box."""
    return (G_CM3_PER_AMU_NM3 * float(system.masses.double().sum())
            / float(system.boundary.volume()))


def minimize_phase(system):
    """SteepestDescentMinimizer on the lattice PME box, on one list:
    energy and max|F| before and after; gates: the energy fell, the
    coordinates are finite, the constraints hold, every evaluation
    launched the kernel, the list is not stale (the minimizer raises)."""
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.ops import pair_kernel as pk
    nb = system.neighbor_finder.find(system.coords, system.boundary,
                                     system.exclusions)
    with uncounted():
        f0, _ = pt.forces_virial(system, nb)
        f_max0 = float(torch.linalg.vector_norm(f0, dim=1).max())
    pk.reset_launch_counts()
    t0 = time.perf_counter()
    out, info = pt.SteepestDescentMinimizer(max_steps=MIN_STEPS).minimize(
        system, nb)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = pk.LAUNCHES
    f1, _ = pt.forces_virial(out, nb)
    f_max = float(torch.linalg.vector_norm(f1, dim=1).max())
    e0, e1 = float(info["energy_initial"]), float(info["energy_final"])
    accepted = len(set(info["energies"].tolist()) - {e0})
    temp, viol = check_state("Minimize", out)
    print(f"Minimize: {MIN_STEPS} iterations in {secs:.2f} s on one list "
          f"({accepted} moves accepted; {launches} pair-kernel launches for "
          f"{1 + 2 * MIN_STEPS} evaluations): energy {e0:.6e} -> "
          f"{e1:.6e} kJ/mol, max|F| {f_max0:.4e} -> {f_max:.4e} kJ/mol/nm; "
          f"max constraint violation {viol:.3e} nm; unlisted atom pairs at "
          f"least {info['closest_unlisted']:.4f} nm apart", flush=True)
    if not e1 < e0:
        raise RuntimeError("Minimize: the energy did not fall")
    if launches != 1 + 2 * MIN_STEPS:
        raise RuntimeError(f"Minimize: {launches} pair-kernel launches")


def moved_box_check(label, system, nb):
    """Right after an accepted volume move, before the next rebuild: the
    kernel against its twin at the moved box on the list built at the old
    one, forces-only and with energy (the kernel reads the call's box);
    the energy instance timed there, with its bound. Returns its entry of
    the kernels line."""
    from mollytpu_torch.ops import pair_kernel as pk
    spec = pk.build_fused_spec(system.pairwise_inters)
    n = system.n_atoms
    # a pair within NEAR_CUT of the cutoff may land on the other side of it
    # in the kernel's FMA-contracted r^2 than in the twin's: as in
    # check_f64, its atoms are left out of the force gate, and their error
    # is printed
    nbk, _, _ = pk.kernel_inputs(spec, system.coords, system.atoms, nb)
    near = near_cutoff_atoms(spec, nbk, system.boundary, n)
    r, nbk, _ = kernel_vs_twin(spec, system, nb, exclude=near)
    r_all, _, _ = kernel_vs_twin(spec, system, nb)
    line = (f"{label} kernel at the moved box (list built at the old one): "
            f"max|dF| {r['df']:.3e} forces-only, {r['df_energy']:.3e} with "
            f"energy, rms|F| {r['rms']:.3e}, ratio {r['ratio']:.3e} over the "
            f"{int((~near).sum())} atoms with no pair within {NEAR_CUT} nm "
            f"of the cutoff ({r_all['ratio']:.3e} over all); rel dE "
            f"{r['de']:.3e}; rel dvir {r['dv']:.3e}")
    print(line, flush=True)
    if not r["ok"]:
        raise RuntimeError(line + " exceeds the tolerance")
    t_d = device_ms(spec, nbk, system.boundary, n, energy=True)
    t_p = _time(lambda: pk.pair_nonbonded_plain(spec, nbk, system.boundary,
                                                n, True))
    print(f"{label} energy instance at the moved box: {t_d:.4f} ms device "
          f"(events over 25 back-to-back launches), plain twin {t_p:.4f} ms",
          flush=True)
    b = bound(f"{label} energy instance", spec, nbk, system.boundary, n,
              energy=True)
    return dict(max_abs_err=r["df_energy"], ms=t_d, plain_ms=t_p,
                bound_ms=b["bound_ms"], bound_by=b["bound_by"])


def npt_mc(run, line):
    """The NPT-PME main path from the PME path's end state: Langevin with
    the Monte Carlo barostat. Warm-up in pieces that end right after an
    attempt, until NPT_WARMUP steps are done and the first accepted move
    has been checked (moved_box_check), then NPT_STEPS timed steps with the
    drift check between chunks. Gates: launches (1 + steps + 3 per attempt,
    2 per attempt with energy), a move accepted, the volume band, the main
    path's state, stale-list and float64 gates."""
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.ops import pair_kernel as pk
    label = "NPT-PME (MC)"
    system, nb, gen, step = (run[k] for k in ("system", "nb", "gen", "step"))
    baro = pt.MonteCarloBarostat(NPT_BAR * pt.units.BAR, TEMP,
                                 n_steps=MC_EVERY, scale_molecules=True,
                                 coupling="isotropic")
    sim = pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION,
                      coupling=(baro,))
    vol0, rho0, first = float(system.boundary.volume()), density(system), \
        step
    pk.reset_launch_counts()
    aux = sim.init_aux(system, nb)
    closest, moved = math.inf, None
    t0 = time.perf_counter()
    while step - first < NPT_WARMUP or moved is None:
        if step - first >= 4 * NPT_WARMUP:
            raise RuntimeError(f"{label}: no move accepted in "
                               f"{step - first} steps")
        attempt = step + (-step) % MC_EVERY
        system, nb, aux, near = pt.run_chunk(sim, system, nb, aux, step,
                                             attempt - step + 1,
                                             generator=gen)
        closest, step = min(closest, near), attempt + 1
        if moved is None and int(aux["mc_baro"]["accepted"]):
            with uncounted():
                moved = moved_box_check(f"{label} step {attempt}", system,
                                        nb)
    torch.cuda.synchronize()
    print(f"{label}: warm-up of {step - first} steps in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    timed0 = step
    t0 = time.perf_counter()
    for _ in range(NPT_STEPS // CHUNK):
        system, nb, aux, near = pt.run_chunk(sim, system, nb, aux, step,
                                             CHUNK, generator=gen)
        closest, step = min(closest, near), step + CHUNK
        system, nb = pt.npt_resetup(sim, system, nb, step)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    n_steps = step - first
    attempts = sum(1 for s in range(first, step) if s % MC_EVERY == 0)
    state = {k: int(v) for k, v in aux["mc_baro"].items() if k != "scale"}
    launches, own = pk.LAUNCHES, pk.INSTANCE_LAUNCHES[NPT_FAMILY]
    energy = pk.ENERGY_LAUNCHES[NPT_FAMILY]
    want = 1 + n_steps + 3 * attempts
    if (state["attempted"] != attempts or launches != want or own != want
            or energy != 2 * attempts):
        raise RuntimeError(
            f"{label}: {launches} pair-kernel launches ({own} of instance "
            f"{NPT_FAMILY}, {energy} with energy) and {state['attempted']} "
            f"attempts for {n_steps} steps and {attempts} attempt steps "
            f"(want {want} launches, {2 * attempts} with energy)")
    temp, viol = check_state(label, system)
    vol = float(system.boundary.volume())
    ms = 1e3 * elapsed / (step - timed0)
    ns_day = pt.units.ps_per_step_to_ns_per_day(DT, ms * 1e-3)
    print(f"{label}: {n_steps} steps, {state['attempted']} attempts, "
          f"{state['accepted']} accepted, proposal scale "
          f"{float(aux['mc_baro']['scale']):.4f} nm^3; volume {vol0:.4f} -> "
          f"{vol:.4f} nm^3, density {rho0:.4f} -> {density(system):.4f} "
          f"g/cm^3; {launches} pair-kernel launches = 1 + {n_steps} steps + "
          f"3 x {attempts} attempts ({energy} with energy); T {temp:.2f} K, "
          f"max constraint violation {viol:.3e} nm; unlisted atom pairs at "
          f"the rebuilds at least {closest:.4f} nm apart", flush=True)
    print(f"{label}: {ms:.4f} ms/step, {ns_day:.4f} ns/day "
          f"({step - timed0} timed steps; card {line})", flush=True)
    if not state["accepted"]:
        raise RuntimeError(f"{label}: no move accepted")
    if abs(vol / vol0 - 1.0) > NPT_VOLUME_BAND:
        raise RuntimeError(f"{label}: the volume left the "
                           f"{NPT_VOLUME_BAND:.0%} band")
    with uncounted():
        check_f64(label, system, aux["forces"],
                  pt.potential_energy(system, nb))
    moved["launches"] = energy
    return dict(moved=moved, ms=ms, ns_day=ns_day, launches=launches,
                system=system, nb=nb, aux=aux, sim=sim, gen=gen, step=step)


def npt_crescale(run, line):
    """C-rescale on the NPT-MC end state: the virial instance on the main
    path every CRESCALE_EVERY steps (the step's evaluation and the
    recompute at the moved box, which refreshes the virial too), in pieces
    of CRESCALE_PIECE steps with npt_resetup between them, until
    CRESCALE_STEPS steps are done and the finder has been set up anew for
    a drifted box with CRESCALE_PIECE steps run after it. Gates: launches
    (1 + steps + one recompute per move, both evaluations of a move step
    with energy), a re-setup and the steps after it, the main
    path's state, stale-list and float64 gates; the instantaneous pressure
    is printed. No volume gate: without the constraint virial (as the JAX
    package) rigid water reads ~+13 kbar and the box expands."""
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.ops import pair_kernel as pk
    label = "NPT-PME (C-rescale)"
    system, nb, gen, first = (run[k] for k in ("system", "nb", "gen",
                                               "step"))
    baro = pt.CRescaleBarostat(
        NPT_BAR * pt.units.BAR, TEMP, CRESCALE_TAU,
        compressibility=WATER_COMPRESSIBILITY_PER_BAR / pt.units.BAR,
        n_steps=CRESCALE_EVERY, scale_molecules=True)
    sim = pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION,
                      coupling=(baro,))
    vol0 = float(system.boundary.volume())
    pk.reset_launch_counts()
    aux = sim.init_aux(system, nb)
    closest, step, resetups = math.inf, first, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while (step - first < CRESCALE_STEPS or not resetups
           or step - resetups[0] < CRESCALE_PIECE):
        if step - first >= 3 * CRESCALE_STEPS:
            raise RuntimeError(f"{label}: no re-setup in {step - first} "
                               "steps")
        system, nb, aux, near = pt.run_chunk(sim, system, nb, aux, step,
                                             CRESCALE_PIECE, generator=gen)
        closest, step = min(closest, near), step + CRESCALE_PIECE
        finder = system.neighbor_finder
        system, nb = pt.npt_resetup(sim, system, nb, step)
        if system.neighbor_finder is not finder:
            resetups.append(step)
    torch.cuda.synchronize()
    n_steps = step - first
    ms = 1e3 * (time.perf_counter() - t0) / n_steps
    moves = sum(1 for s in range(first, step) if s % CRESCALE_EVERY == 0)
    launches, energy = pk.LAUNCHES, pk.ENERGY_LAUNCHES[NPT_FAMILY]
    if (launches != 1 + n_steps + moves
            or pk.INSTANCE_LAUNCHES[NPT_FAMILY] != launches
            or energy != 2 * moves):
        raise RuntimeError(f"{label}: {launches} pair-kernel launches "
                           f"({energy} with energy) for {n_steps} "
                           f"steps and {moves} moves")
    temp, viol = check_state(label, system)
    with uncounted():
        _, vir = pt.forces_virial(system, nb, needs_virial=True)
        p_bar = float(pt.scalar_pressure(pt.kinetic_energy_tensor(
            system.masses, system.velocities), vir,
            system.boundary.volume())) / pt.units.BAR
        check_f64(label, system, aux["forces"],
                  pt.potential_energy(system, nb))
    print(f"{label}: {n_steps} steps in pieces of {CRESCALE_PIECE}, "
          f"{moves} box moves; neighbor finder set up anew for the drifted "
          f"box after steps {resetups}; volume {vol0:.4f} -> "
          f"{float(system.boundary.volume()):.4f} nm^3, density "
          f"{density(system):.4f} g/cm^3; instantaneous pressure "
          f"{p_bar:.1f} bar (no constraint virial, as the JAX package); "
          f"{launches} pair-kernel launches ({energy} with energy and "
          f"virial); T {temp:.2f} K, max constraint violation {viol:.3e} "
          f"nm; unlisted atom pairs at the rebuilds at least "
          f"{closest:.4f} nm apart; {ms:.4f} ms/step over an expanding box, "
          f"re-setups included ({line})", flush=True)
    return dict(ms=ms, launches=launches)


def steps_without_sync(label, run, start, n, unit="steps", note=""):
    """Step ``run``'s integrator n steps from ``start`` on its list under
    torch.cuda.set_sync_debug_mode("error"): a host sync anywhere in a step
    raises and fails the run. A known sync is made under the same mode
    first, to show that the mode catches one. The list is checked for stale
    pairs after, and the check's line printed, ``note`` after the steps.
    Returns the run's state after the steps."""
    import torch
    from mollytpu_torch.sim.coupling import virial_due
    from mollytpu_torch.sim.simulate import (list_check, list_cutoff,
                                             raise_if_overflow,
                                             raise_if_stale)
    sim, system, nb, aux, gen = (run[k] for k in (
        "sim", "system", "nb", "aux", "gen"))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        try:
            float(system.coords.sum())
        except RuntimeError:
            pass
        else:
            raise RuntimeError(f"{label} sync check: the sync debug mode let "
                               "a known host sync through")
        for step_n in range(start, start + n):
            try:
                system, aux = sim.step(
                    system, nb, aux, step_n, generator=gen,
                    needs_virial=virial_due(sim.coupling, step_n))
            except RuntimeError as err:
                raise RuntimeError(f"{label} sync check: a host sync in step "
                                   f"{step_n}") from err
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cutoff = list_cutoff(system)
    near, over = list_check(system, nb, cutoff)
    if over is not None:
        raise_if_overflow(over, start + n)
    raise_if_stale(near, cutoff)
    print(f"{label} sync check, {unit} {start}-{start + n - 1}{note} on one "
          "list under set_sync_debug_mode(\"error\"): no host sync (a known "
          "one made first was caught)", flush=True)
    return {**run, "system": system, "aux": aux, "step": start + n}


def sync_check(run):
    """One rebuild interval that holds a Monte Carlo attempt, stepped on one
    list under torch.cuda.set_sync_debug_mode("error") (steps_without_sync):
    the integrator, the barostat's attempt with its trial energies, the
    force recompute."""
    import mollytpu_torch as pt
    sim, system, nb, aux, gen, step = (run[k] for k in (
        "sim", "system", "nb", "aux", "gen", "step"))
    attempt = step + (-step) % MC_EVERY
    start = attempt - attempt % CADENCE
    if start > step:
        system, nb, aux, _ = pt.run_chunk(sim, system, nb, aux, step,
                                          start - step, generator=gen)
    elif start < step:
        raise RuntimeError("sync check: the attempt's interval has begun")
    steps_without_sync("NPT-PME (MC)", {**run, "system": system, "nb": nb,
                                        "aux": aux}, start, CADENCE,
                       note=f" (attempt at {attempt})")


def npt_components(run):
    """CUDA-event times (median of 20) of the NPT step's parts on the
    NPT-MC end state."""
    import mollytpu_torch as pt
    from mollytpu_torch import forces_virial
    sim, system, nb, aux, gen, step = (run[k] for k in (
        "sim", "system", "nb", "aux", "gen", "step"))
    baro = sim.coupling[0]
    attempt = step + (-step) % MC_EVERY
    parts = {
        "Langevin step without an attempt": lambda: sim.step(
            system, nb, aux, attempt + 1, generator=gen),
        "Langevin step with an attempt": lambda: sim.step(
            system, nb, aux, attempt, generator=gen),
        "MC attempt (barostat apply)": lambda: baro.apply(
            system, aux, DT, attempt, gen, neighbors=nb),
        "potential_energy (one trial energy)": lambda: pt.potential_energy(
            system, nb),
        "forces_virial (the recompute)": lambda: forces_virial(system, nb),
        "scale_coords_molecular": lambda: pt.scale_coords_molecular(
            system.boundary, system.coords, 1.001, system.masses,
            system.molecule_ids, system.n_molecules),
    }
    for name, fn in parts.items():
        print(f"NPT-PME (MC) component: {name}: {_time(fn, 2, 20):.4f} ms",
              flush=True)


def npt_phase(built, run, line):
    """The NPT phase on the PME box: the minimizer on the lattice start,
    the Monte Carlo barostat from the PME path's end state (with the kernel
    at the first moved box), the host-sync check, the step's components,
    then C-rescale. Returns the NPT-MC summary and the energy instance's
    entry."""
    minimize_phase(built)
    mc = npt_mc(run, line)
    sync_check(mc)
    npt_components(mc)
    crescale = npt_crescale(mc, line)
    return {"MC": {k: mc[k] for k in ("ms", "ns_day", "launches")},
            "C-rescale": crescale}, mc["moved"]


def synthetic_lists(system):
    """Every bonded kind over the frame's waters, one row per water: its
    oxygen O, hydrogens H1 and H2, and the oxygen O' of the water whose
    oxygen is nearest (minimum image). Bonds O-O', angles H1-O-O',
    torsions H2-H1-O-O', a restraint of O to a point 0.05 nm off it. The
    parameters keep every term finite (FENE's r0 twice |O-O'|) and the
    energies of one sign."""
    import torch
    import mollytpu_torch as pt
    x, box, dev = system.coords, system.boundary, system.device
    o = torch.arange(0, system.n_atoms, 3, device=dev)
    if not bool((system.masses[o] > 15.0).all()):
        raise RuntimeError("bonded phase: the frame is not O, H1, H2 waters")
    xo = x[o]
    near = torch.empty_like(o)
    for a in range(0, len(o), 1024):
        d = box.displacement(xo[a:a + 1024, None], xo[None])
        r2 = (d * d).sum(-1)
        rows = torch.arange(r2.shape[0], device=dev)
        r2[rows, rows + a] = math.inf
        near[a:a + 1024] = r2.argmin(dim=1)
    o2, h1, h2 = o[near], o + 1, o + 2
    d = box.displacement(x[o], x[o2])
    r = torch.sqrt((d * d).sum(-1))
    pme = next(g for g in system.general_inters if isinstance(g, pt.PME))
    q = system.atoms.charge
    one = torch.ones_like(r)
    kw = dict(dtype=x.dtype, device=dev)
    shift = torch.tensor([0.05, -0.05, 0.025], **kw)
    return (
        pt.harmonic_bonds(o, o2, k=1000.0 * one, r0=0.8 * r, **kw),
        pt.morse_bonds(o, o2, D=5.0 * one, a=2.0 * one, r0=0.9 * r, **kw),
        pt.fene_bonds(o, o2, k=30.0 * one, r0=2.0 * r, sigma=0.3 * one,
                      epsilon=one, **kw),
        pt.ewald_exclusions(o, o2, kqq=pme.coulomb_const * q[o] * q[h1],
                            alpha=pme.alpha * one, **kw),
        pt.harmonic_angles(h1, o, o2, k=300.0 * one, theta0=1.2 * one,
                           **kw),
        pt.cosine_angles(h1, o, o2, k=20.0 * one, theta0=1.0 * one, **kw),
        pt.urey_bradleys(h1, o, o2, kangle=300.0 * one, theta0=1.9 * one,
                         kbond=5000.0 * one, r0=0.3 * one, **kw),
        pt.periodic_torsions(h2, h1, o, o2, periodicity=3.0 * one,
                             phase=0.5 * one, k=5.0 * one, **kw),
        pt.rb_torsions(h2, h1, o, o2, coeffs=torch.tensor(
            [10.0, 1.8, 0.5, -2.4, 0.3, 0.1], **kw).expand(len(o), 6),
            **kw),
        pt.harmonic_torsions(h2, h1, o, o2, k=4.0 * one, theta0=0.5 * one,
                             **kw),
        pt.position_restraints(o, k=500.0 * one, x0=x[o] + shift, **kw))


def bonded_layer(label, system, lists):
    """Device ms per all_specific_forces call of ``lists`` (CUDA events,
    median of 20) and runtime calls per call that put work on the device
    (profiler), forces-only as on the main path."""
    import mollytpu_torch as pt

    def call():
        return pt.all_specific_forces(lists, system.coords, system.boundary)
    ms = _time(call, 3, 20)
    _, work = profiled(call, 10)
    rows = sum(sl.n_terms for sl in lists)
    print(f"{label}: all_specific_forces over {len(lists)} lists, {rows} "
          f"rows: {ms:.4f} ms per call (CUDA events, median of 20), "
          f"{work:g} runtime calls that put work on the device per call",
          flush=True)
    return {"ms": ms, "launches": work}


def bonded_phase(system):
    """Every bonded kind on the PME path's end state (synthetic_lists; on
    the lattice start an H1-O-O' angle would be straight, its torsions
    undefined): the card's f32
    forces, energy and virial against a float64 evaluation of the same
    lists on the CPU from the same coordinates; gates max|dF|/rms|F| <
    TOL_BONDED_FORCE and relative dE and dvirial < TOL_BONDED_REL. Then
    the layer's time and device calls per evaluation."""
    import torch
    import mollytpu_torch as pt
    lists = synthetic_lists(system)
    x, box = system.coords, system.boundary

    def evaluate(lists, x, box):
        f, v = pt.all_specific_forces(lists, x, box, needs_virial=True)
        return f, v, sum(pt.specific_energy(sl, x, box) for sl in lists)
    f, v, e = evaluate(lists, x, box)
    f64, v64, e64 = evaluate(
        tuple(sl.to("cpu", torch.float64) for sl in lists),
        x.detach().cpu().double(), box.to("cpu", torch.float64))
    rms = float(f64.pow(2).sum(dim=1).mean().sqrt())
    df = float((f.cpu().double() - f64).abs().max()) / rms
    de = abs(float(e) - float(e64)) / abs(float(e64))
    dv = float((v.cpu().double() - v64).abs().max()) / float(
        v64.abs().max())
    line = (f"Bonded phase: {len(lists)} kinds x {lists[0].n_terms} rows on "
            "the PME path's end state, card f32 against CPU float64: "
            f"max|dF|/rms|F| "
            f"{df:.3e} (rms|F| {rms:.4e}), rel dE {de:.3e} (E "
            f"{float(e64):.6e} kJ/mol), rel dvir {dv:.3e}")
    print(line, flush=True)
    if not (df < TOL_BONDED_FORCE and de < TOL_BONDED_REL
            and dv < TOL_BONDED_REL):
        raise RuntimeError(line + " exceeds the tolerance")
    # where the f32 error comes from: each kind alone, against the rms|F|
    # of all kinds together
    for sl in lists:
        fk = pt.specific_forces(sl, x, box)[0].cpu().double()
        fk64 = pt.specific_forces(sl.to("cpu", torch.float64),
                                  x.detach().cpu().double(),
                                  box.to("cpu", torch.float64))[0]
        print(f"Bonded phase {sl.kind}: max|dF| "
              f"{float((fk - fk64).abs().max()):.4e} kJ/mol/nm "
              f"({float((fk - fk64).abs().max()) / rms:.3e} of the rms|F| "
              f"above), max|F| {float(fk64.abs().max()):.4e}", flush=True)
    return bonded_layer("Bonded phase", system, lists)


def bonded_pme_path(dev, workdir):
    """The Bonded-PME main path: the PME cube with flexible H-O-H angles,
    the kernel against its twin on the built frame, the main path's run
    and gates (its float64 check with the angles), the bonded layer's cost
    per evaluation, and a rebuild interval stepped without a host sync."""
    import torch
    label = "Bonded-PME"
    t0 = time.perf_counter()
    system = water_system(dev, torch.float32, workdir, "pme", CUBE,
                          rigid=False)
    torch.cuda.synchronize()
    print(f"{label}: {describe(system)}; setup "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    compare(f"{label} water{system.n_atoms}", system)
    layer = bonded_layer(label, system, system.specific_lists)
    run = main_path(label, system, 2, BONDED_FAMILY)
    components(label, run)
    steps_without_sync(label, run, run["step"], CADENCE)
    return {**{k: run[k] for k in ("launches", "ms", "ns_day")},
            "layer": layer}


@contextlib.contextmanager
def counted_pme():
    """Counts PME force evaluations inside (a one-element list)."""
    import mollytpu_torch as pt
    calls, orig = [0], pt.PME.force_virial

    def counted(self, *args, **kwargs):
        calls[0] += 1
        return orig(self, *args, **kwargs)
    pt.PME.force_virial = counted
    try:
        yield calls
    finally:
        pt.PME.force_virial = orig


def mts_path(run, line):
    """The MTS-PME main path from the PME path's end state: BAOAB-RESPA
    (MTSLangevinIntegrator) at MTS_DT outer steps with the pair kernel and
    the bonded lists twice and PME with its corrections once per outer
    step (bench.py's fractions), a rebuild every MTS_REBUILD outer steps;
    MTS_WARMUP warm-up and MTS_STEPS timed outer steps, after the PME
    path's Langevin timed from the same state as a yardstick in the same
    call. Gates: K1a launched
    exactly 1 + 2 per outer step, PME evaluated 1 + 1 per outer step, the
    main path's state, stale-list and float64 gates; then a rebuild
    interval stepped without a host sync."""
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.ops import pair_kernel as pk
    label = "MTS-PME"
    system, nb, gen, step = (run[k] for k in ("system", "nb", "gen", "step"))
    if step % MTS_REBUILD:
        raise RuntimeError(f"{label}: start {step} is off the rebuild grid")
    system = system.update(neighbor_finder=dataclasses.replace(
        system.neighbor_finder, n_steps=MTS_REBUILD))
    sim = pt.MTSLangevinIntegrator(
        dt=MTS_DT, temperature=TEMP, friction=FRICTION,
        pi_fractions=(2,) * len(system.pairwise_inters),
        si_fractions=(2,) * len(system.specific_lists),
        gi_fractions=(1,) * len(system.general_inters))
    # the yardstick in this call: the PME path's Langevin at 2 fs from the
    # same state, as many inner steps as MTS_STEPS outer steps take
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pt.run_chunk(run["sim"], run["system"], nb, run["aux"], step,
                 2 * MTS_STEPS, generator=gen)
    torch.cuda.synchronize()
    ref_ms = 1e3 * (time.perf_counter() - t0) / (2 * MTS_STEPS)
    pk.reset_launch_counts()
    with counted_pme() as pme_calls:
        aux = sim.init_aux(system, nb)
        system, nb, aux, closest = pt.run_chunk(sim, system, nb, aux, step,
                                                MTS_WARMUP, generator=gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        system, nb, aux, near = pt.run_chunk(sim, system, nb, aux,
                                             step + MTS_WARMUP, MTS_STEPS,
                                             generator=gen)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    outer = MTS_WARMUP + MTS_STEPS
    launches, own = pk.LAUNCHES, pk.INSTANCE_LAUNCHES[BONDED_FAMILY]
    if (launches != 1 + 2 * outer or own != launches
            or pk.ENERGY_LAUNCHES[BONDED_FAMILY]
            or pme_calls[0] != 1 + outer):
        raise RuntimeError(
            f"{label}: {launches} pair-kernel launches ({own} of instance "
            f"{BONDED_FAMILY}) and {pme_calls[0]} PME evaluations for "
            f"{outer} outer steps (want {1 + 2 * outer} and {1 + outer})")
    temp, viol = check_state(label, system)
    ms = 1e3 * elapsed / MTS_STEPS
    ns_day = pt.units.ps_per_step_to_ns_per_day(MTS_DT, ms * 1e-3)
    print(f"{label}: {outer} outer steps ({2 * outer} inner) of "
          f"{MTS_DT * 1e3:g} fs, {launches} pair-kernel launches = 1 + 2 x "
          f"{outer}, {pme_calls[0]} PME evaluations = 1 + {outer}; T "
          f"{temp:.2f} K, max constraint violation {viol:.3e} nm; unlisted "
          f"atom pairs at the rebuilds at least {min(closest, near):.4f} nm "
          "apart", flush=True)
    ref_ns = pt.units.ps_per_step_to_ns_per_day(DT, ref_ms * 1e-3)
    print(f"{label}: {ms:.4f} ms per outer step ({ms / 2:.4f} per 2 fs), "
          f"{ns_day:.4f} ns/day ({MTS_STEPS} timed outer steps); Langevin "
          f"at 2 fs from the same start just before: {ref_ms:.4f} ms/step, "
          f"{ref_ns:.4f} ns/day ({2 * MTS_STEPS} steps; card {line})",
          flush=True)
    with uncounted():
        check_f64(label, system, aux["forces"],
                  pt.potential_energy(system, nb))
    start = step + outer
    steps_without_sync(label, {"sim": sim, "system": system, "nb": nb,
                               "aux": aux, "gen": gen}, start, MTS_REBUILD,
                       unit="outer steps",
                       note=f" ({2 * MTS_REBUILD} inner)")
    return dict(launches=launches, ms=ms, ns_day=ns_day, ref_ms=ref_ms)


def other_modes(label, system, modes):
    """K1b's other modes on the built water box at 1.0 nm radii: each
    against its twin, timed, with its bound."""
    for lj_mode, coul_mode in modes:
        compare(f"{label} other mode lj{lj_mode}/coul{coul_mode}",
                system.update(pairwise_inters=small_inters(
                    lj_mode, coul_mode, 1.0, 1.0)), timing=True)


def components(label, run, hamiltonian=None, lams=()):
    """CUDA-event times (median of 20) of the step's parts on the state the
    main path ended in, and a torch.profiler summary of 20 steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import mollytpu_torch as pt
    from mollytpu_torch import forces_virial
    from mollytpu_torch.ops import pair_kernel as pk
    from mollytpu_torch.ops.blockpairs import unlisted_min_distance
    system, nb, aux, sim, gen = (run[k] for k in ("system", "nb", "aux",
                                                  "sim", "gen"))
    spec = pk.build_fused_spec(system.pairwise_inters)
    nbk, lam_role, _ = pk.kernel_inputs(spec, system.coords, system.atoms,
                                        nb)
    c = system.constraints[0]
    solver = ("LINCS", "LINCS") if type(c).__name__ == "LINCS" else (
        "SHAKE", "RATTLE")
    x, v, m, box = system.coords, system.velocities, system.masses, \
        system.boundary
    parts = {
        "whole Langevin step": lambda: sim.step(system, nb, aux, run["step"],
                                                generator=gen),
        "forces_virial (all forces)": lambda: forces_virial(system, nb),
        "pair: gather + kernel + far pairs": lambda: pk.block_nonbonded(
            spec, x, box, system.atoms, system.exclusions, nb),
        "pair kernel alone": lambda: pk.pair_nonbonded(
            spec, nbk, box, system.n_atoms, False, lam_role),
        f"{solver[0]} (positions)": lambda: c.apply_position_constraints(
            x, x + DT * v, v, m, box, DT),
        f"{solver[1]} (velocities)": lambda: c.apply_velocity_constraints(
            x, v, m, box),
        "rebuild (find)": lambda: system.neighbor_finder.find(
            x, box, system.exclusions),
        "stale-list check": lambda: unlisted_min_distance(
            nb, x, box, spec.cut_max),
    }
    for g in system.general_inters:
        if isinstance(g, pt.PME):
            parts["PME force_virial"] = lambda pme=g: pme.force_virial(
                x, box, system.atoms)
    vs = system.virtual_sites
    if vs is not None:
        parts["virtual sites: place"] = lambda: vs.place(x, box)
        parts["virtual sites: distribute forces"] = \
            lambda: vs.distribute_forces(x, box, aux["forces"])
    if any(sl.n_terms for sl in system.specific_lists):
        parts["bonded lists (all_specific_forces)"] = \
            lambda: pt.all_specific_forces(system.specific_lists, x, box)
    if hamiltonian is not None:
        parts[f"cross-energy sample ({len(lams)} lambdas)"] = \
            lambda: hamiltonian.energies(system, lams, nb)
    for name, fn in parts.items():
        print(f"{label} component: {name}: {_time(fn, 2, 20):.4f} ms",
              flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s, a = system, aux
        for k in range(20):
            s, a = sim.step(s, nb, a, run["step"] + k, generator=gen)
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    launches = sum(e.count for e in avgs
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    device_ms = sum(_dev_us(e) for e in avgs) / 1e3
    top = sorted(avgs, key=_dev_us, reverse=True)[:5]
    print(f"{label} profile, 20 steps: {launches} kernel launches, "
          f"{device_ms:.3f} ms device time ({device_ms / 20:.4f} ms per "
          "step); top: " + "; ".join(
              f"{e.key[:48]} {_dev_us(e) / 1e3:.3f} ms" for e in top),
          flush=True)


def fep_system(system):
    """The PME water box with the water whose oxygen lies nearest the box
    centre inserted alchemically: its three atoms ALCH_INSERT, Beutler
    soft-core LJ + Beutler soft-core Ewald real space in place of LJ +
    Ewald (the JAX package's FEP production combination), PME on the
    scheduled charges; the Ewald exclusion and dispersion corrections stay.
    Built from public pieces, as a JAX user builds it with System.update.
    Returns (system at lambda 1, solute mask)."""
    import numpy as np
    import torch
    import mollytpu_torch as pt
    x = system.coords.double().cpu().numpy()
    mass = system.atoms.mass.double().cpu().numpy()
    centre = 0.5 * system.boundary.side_lengths.double().cpu().numpy()
    oxy = np.nonzero(mass > 2.0)[0]
    o = int(oxy[np.argmin(np.linalg.norm(x[oxy] - centre, axis=1))])
    if not (mass[o + 1] < 2.0 and mass[o + 2] < 2.0):
        raise RuntimeError(f"atom {o} is not followed by its two hydrogens")
    mask = torch.zeros(system.n_atoms, dtype=torch.bool,
                       device=system.device)
    mask[o:o + 3] = True
    # INSERT, not DELETE: the default scheduler turns a DELETE atom's
    # charges fully on at lambda 0.5 while its sterics are still off, and
    # a bare charged oxygen without LJ collapses onto solvent hydrogens;
    # INSERT couples the sterics first, then the charges
    roles = torch.where(mask, pt.ALCH_INSERT, pt.ALCH_CORE).to(torch.int32)
    atoms = dataclasses.replace(system.atoms, alch_role=roles)
    lj, coul = system.pairwise_inters
    sched = pt.DefaultLambdaScheduler()
    pair = (pt.LennardJonesSoftCoreBeutler(
                cutoff=pt.DistanceCutoff(1.0), alpha=0.5, use_neighbors=True,
                weight_special=lj.weight_special, scheduler=sched),
            pt.CoulombSoftCoreBeutlerEwald(
                dist_cutoff=1.0, error_tol=coul.error_tol, alpha=coul.alpha,
                alpha_sc=0.5, use_neighbors=True,
                weight_special=coul.weight_special, scheduler=sched))
    general = tuple(dataclasses.replace(g, scheduler=sched)
                    if isinstance(g, pt.PME) else g
                    for g in system.general_inters)
    out = system.update(atoms=atoms, pairwise_inters=pair,
                        general_inters=general)
    print(f"FEP-water: solute atoms {o}-{o + 2} (oxygen "
          f"{np.linalg.norm(x[o] - centre):.4f} nm from the box centre), "
          "ALCH_INSERT; Beutler soft-core LJ (alpha 0.5) + Beutler "
          "soft-core Ewald (alpha_sc 0.5), PME on scheduled charges",
          flush=True)
    return out, mask


def lambda1_check(pme_system, fep, mask):
    """At lambda 1 on every atom the lambda instance computes K1a's pair
    terms but for the A&S erfc: both kernels on the same frame. Then both
    timed on the same frame at lambda FEP_TIMED, forces-only and with
    energy."""
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.ops import pair_kernel as pk
    box, n = fep.boundary, fep.n_atoms
    nb = fep.neighbor_finder.find(fep.coords, box, fep.exclusions)
    spec_a = pk.build_fused_spec(pme_system.pairwise_inters)
    spec_c = pk.build_fused_spec(fep.pairwise_inters)

    # one list, its rows filled once per system: the timed calls below are
    # the kernels alone
    nb_a, _, _ = pk.kernel_inputs(spec_a, fep.coords, pme_system.atoms, nb)

    def rows(system):
        return pk.kernel_inputs(spec_c, system.coords, system.atoms, nb)[:2]

    def k1c(nb_lr, energy):
        return pk._pair_nonbonded_cuda(spec_c, nb_lr[0], box, n, energy,
                                       nb_lr[1])

    def k1a(energy):
        return pk._pair_nonbonded_cuda(spec_a, nb_a, box, n, energy)

    fc, ec, _ = k1c(rows(pt.set_lambda(fep, 1.0)), True)
    fa, ea, _ = k1a(True)
    torch.cuda.synchronize()
    rms = float(fa.pow(2).sum(dim=1).mean().sqrt())
    df = float((fc - fa).abs().max()) / rms
    de = abs(float(ec) - float(ea)) / abs(float(ea))
    line = (f"FEP-water lambda=1 check: lambda instance against K1a on one "
            f"frame: max|dF|/rms|F| {df:.3e} (tolerance {TOL_LAM1_FORCE}), "
            f"rel dE {de:.3e} (tolerance {TOL_LAM1_ENERGY}; E "
            f"{float(ea):.6e} kJ/mol)")
    print(line, flush=True)
    if df > TOL_LAM1_FORCE or de > TOL_LAM1_ENERGY:
        raise RuntimeError(line + " exceeds the tolerance")
    at = rows(pt.set_lambda(fep, FEP_TIMED, atom_mask=mask))
    for energy in (False, True):
        t_a = _time(lambda: k1a(energy))
        t_c = _time(lambda: k1c(at, energy))
        t_a2 = _time(lambda: k1a(energy))
        print(f"FEP-water timing energy={energy}: K1a {t_a:.4f} ms, lambda "
              f"instance at lambda {FEP_TIMED} {t_c:.4f} ms, K1a again "
              f"{t_a2:.4f} ms on the same frame and list ({nb.n_pairs} "
              "cluster pairs)", flush=True)


def fep_path(fep, mask):
    """The alchemical main path: every window from the built frame, warm-up
    then sampled steps, U(x; lambda_k) at every lambda every FEP_SAMPLE
    steps, then MBAR. Gates: launches, state, stale list, float64 at
    FEP_TIMED, MBAR on the card against the CPU, finite free energies."""
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.ops import pair_kernel as pk
    dev = fep.device
    sim = pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)
    ham = pt.LambdaHamiltonian(atom_mask=mask)
    pk.reset_launch_counts()
    n_force = n_energy = 0
    energies, timed = [], None
    t_start = time.perf_counter()
    for k, lam in enumerate(FEP_LAMS):
        gen = torch.Generator(device=dev).manual_seed(SEED + 1 + k)
        system = pt.set_lambda(fep, lam, atom_mask=mask)
        system = system.update(
            velocities=pt.random_velocities(system.masses, TEMP, gen))
        system, nb, aux = pt.simulate(system, sim, FEP_WARMUP, generator=gen)
        n_force += 1 + FEP_WARMUP
        step, closest, t_steps, t_samples, samples = FEP_WARMUP, math.inf, \
            0.0, 0.0, []
        for _ in range(FEP_STEPS // FEP_SAMPLE):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            system, nb, aux, near = pt.run_chunk(sim, system, nb, aux, step,
                                                 FEP_SAMPLE, generator=gen)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            samples.append(ham.energies(system, FEP_LAMS, nb))
            torch.cuda.synchronize()
            t_steps += t1 - t0
            t_samples += time.perf_counter() - t1
            closest = min(closest, near)
            step += FEP_SAMPLE
            n_force += FEP_SAMPLE
            n_energy += len(FEP_LAMS)
        energies.append(torch.stack(samples, dim=1).double())   # (K, S)
        temp, viol = check_state(f"FEP-water lambda={lam}", system)
        print(f"FEP-water lambda={lam}: {step} steps, T {temp:.2f} K, max "
              f"constraint violation {viol:.3e} nm, unlisted atom pairs at "
              f"the sampled chunks' rebuilds at least {closest:.4f} nm "
              f"apart; {len(samples)} samples of U at {len(FEP_LAMS)} "
              "lambdas", flush=True)
        if lam == FEP_TIMED:
            ms = 1e3 * t_steps / FEP_STEPS
            timed = dict(ms=ms, ns_day=pt.units.ps_per_step_to_ns_per_day(
                DT, ms * 1e-3), sample_ms=1e3 * t_samples / len(samples),
                system=system, nb=nb, aux=aux, sim=sim, gen=gen, step=step)
    wall = time.perf_counter() - t_start
    launches, own = pk.LAUNCHES, pk.INSTANCE_LAUNCHES[FEP_FAMILY]
    if launches != n_force + n_energy or own != launches:
        raise RuntimeError(
            f"FEP-water: pair kernel launched {launches} times ({own} of "
            f"instance {FEP_FAMILY}) for {n_force} force and {n_energy} "
            "cross-energy evaluations")
    print(f"FEP-water: {len(FEP_LAMS)} windows x ({FEP_WARMUP} + "
          f"{FEP_STEPS}) steps in {wall:.1f} s; {launches} pair-kernel "
          f"launches (instance {FEP_FAMILY}) for {n_force} force and "
          f"{n_energy} cross-energy evaluations", flush=True)
    check_f64(f"FEP-water lambda={FEP_TIMED}", timed["system"],
              timed["aux"]["forces"],
              pt.potential_energy(timed["system"], timed["nb"]))

    print(f"FEP-water lambda={FEP_TIMED}: {timed['ms']:.4f} ms/step, "
          f"{timed['ns_day']:.4f} ns/day ({FEP_STEPS} steps); "
          f"{timed['sample_ms']:.4f} ms per cross-energy sample "
          f"({len(FEP_LAMS)} lambdas)", flush=True)
    timed["launches"] = launches
    return timed, ham, torch.stack(energies)                  # (K, K, S)


def fep_mbar(e):
    """MBAR in float64 on the card from the (K, K, S) cross energies
    e[k, l, s] = U_l of sample s of window k, against the same solve on
    the CPU; the overlap of neighbouring windows and dG."""
    import torch
    import mollytpu_torch as pt
    if not bool(torch.isfinite(e).all()):
        raise RuntimeError("FEP-water: non-finite cross energies")
    kt = pt.units.KB * TEMP
    for k in range(len(FEP_LAMS) - 1):
        up = (e[k, k + 1] - e[k, k]) / kt
        down = (e[k + 1, k] - e[k + 1, k + 1]) / kt
        print(f"FEP-water overlap lambda {FEP_LAMS[k]} <-> "
              f"{FEP_LAMS[k + 1]}: u_(k+1) - u_k of window k's samples "
              f"mean {float(up.mean()):.4e} sd {float(up.std()):.4e} kT; "
              f"u_k - u_(k+1) of window k+1's mean {float(down.mean()):.4e}"
              f" sd {float(down.std()):.4e} kT", flush=True)
    inp = pt.assemble_mbar_inputs(e, temperature=[TEMP] * len(FEP_LAMS))
    t0 = time.perf_counter()
    f_card = pt.iterate_mbar(inp)
    torch.cuda.synchronize()
    t_mbar = time.perf_counter() - t0
    f_cpu = pt.iterate_mbar(pt.MBARInput(inp.u_kn.cpu(), inp.n_k.cpu()))
    diff = float((f_card.cpu() - f_cpu).abs().max())
    # the MBAR equations sum_n exp(f_k - u_kn) / sum_l N_l exp(f_l - u_ln)
    # = 1 for every state k
    log_d = torch.logsumexp(torch.log(inp.n_k.double())[:, None]
                            + f_card[:, None] - inp.u_kn, dim=0)
    resid = (f_card[:, None] - inp.u_kn - log_d).exp().sum(dim=1) - 1.0
    line = (f"FEP-water MBAR (float64, u_kn {tuple(inp.u_kn.shape)}): f_k "
            f"{[round(float(v), 6) for v in f_card.cpu()]} kT on the card "
            f"in {t_mbar:.3f} s; max |card - CPU| {diff:.3e} kT (tolerance "
            f"{TOL_MBAR}); MBAR equations' residual "
            f"{float(resid.abs().max()):.3e}")
    print(line, flush=True)
    if not bool(torch.isfinite(f_card).all()) or not diff <= TOL_MBAR:
        raise RuntimeError(line)
    dg = float(f_card[-1] - f_card[0]) * kt
    print(f"FEP-water: dG(lambda 0 -> 1) of inserting one TIP3P water "
          f"{dg:.4f} kJ/mol (not converged: {len(FEP_LAMS)} x {FEP_STEPS} "
          "steps)", flush=True)


@contextlib.contextmanager
def timed_calls(bucket, *targets):
    """Each (owner, attribute) callable timed into bucket[attribute]
    (seconds, summed), the card synchronised before and after every call:
    the split of an AWH or TSS iteration into its parts."""
    import torch
    saved = [(owner, name, getattr(owner, name)) for owner, name in targets]

    def wrap(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            bucket[name] = bucket.get(name, 0.0) + time.perf_counter() - t0
            return out
        return call

    for owner, name, fn in saved:
        setattr(owner, name, wrap(name, fn))
    try:
        yield bucket
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def check_bias_f64(label, bias, sys32, sys64):
    """A bias's f32 energy and autograd forces on the card against float64
    on the same coordinates."""
    e32 = float(bias.energy(sys32.coords, sys32.boundary, sys32.atoms))
    e64 = float(bias.energy(sys64.coords, sys64.boundary, sys64.atoms))
    f32, _ = bias.force_virial(sys32.coords, sys32.boundary, sys32.atoms)
    f64, _ = bias.force_virial(sys64.coords, sys64.boundary, sys64.atoms)
    scale = max(1.0, float(f64.abs().max()))
    df = float((f32.double() - f64).abs().max()) / scale
    de = abs(e32 - e64) / max(1.0, abs(e64))
    if df > TOL_BIAS or de > TOL_BIAS:
        raise RuntimeError(f"{label}: bias energy {e32:.6e} against float64 "
                           f"{e64:.6e} (rel {de:.3e}), forces max|dF| / "
                           f"max|F| {df:.3e} (tolerance {TOL_BIAS})")
    return df, de


def check_states_f64(label, space, system, nb):
    """The phase's last frame: the K-state energies on the card (f32
    through the kernel, the sweep of the phase) against a float64
    evaluation through the plain twins at each state's lambda plus its
    float64 bias; each state's bias against float64 (check_bias_f64)."""
    import numpy as np
    import torch
    import mollytpu_torch as pt
    e32 = space.state_energies(system, nb).cpu().numpy()
    sys64, nb64 = f64_system(system, system.coords)
    at_lam, e64, bias_err = {}, [], [0.0, 0.0]
    for k, st in enumerate(space.states):
        lam = float(st.lam)
        if lam not in at_lam:
            at_lam[lam] = float(f64_forces_energy(pt.set_lambda(
                sys64, lam, space.atom_mask), nb64)[1])
        e = at_lam[lam]
        b = space.biases[k] if space.biases is not None else None
        if b is not None:
            e += float(b.energy(sys64.coords, sys64.boundary, sys64.atoms))
            bias_err = [max(a, c) for a, c in zip(bias_err, check_bias_f64(
                f"{label} state {k}", b, system, sys64))]
        e64.append(e)
    e64 = np.array(e64)
    rel = float((np.abs(e32 - e64) / np.abs(e64)).max())
    d64 = e64 - e64[0]
    err = np.abs((e32 - e32[0]) - d64)
    tol = np.maximum(TOL_STATE_DIFF, STATE_DIFF_ULPS * np.spacing(
        np.abs(d64).astype(np.float32)).astype(np.float64))
    diff, worst = float(err.max()), float((err / tol).max())
    # the control: the same energies rounded to bfloat16
    e16 = torch.from_numpy(e32).to(torch.bfloat16).double().numpy()
    control = float((np.abs((e16 - e16[0]) - d64) / tol).max())
    line = (f"{label} last frame vs float64 twins: {space.n_states} state "
            f"energies ({len(at_lam)} lambdas) max rel dE {rel:.3e} "
            f"(tolerance {TOL_F64}), max |d(U_k - U_0)| {diff:.3e} kJ/mol, "
            f"{worst:.3f} of its tolerance (the larger of {TOL_STATE_DIFF} "
            f"kJ/mol and {STATE_DIFF_ULPS} f32 ulps of |U_k - U_0|, which "
            f"spans {float(np.ptp(d64)):.4f} kJ/mol); the bfloat16 control "
            f"reads {control:.3f} of it")
    if space.biases is not None:
        line += (f"; biases: max|dF|/max|F| {bias_err[0]:.3e}, rel dE "
                 f"{bias_err[1]:.3e} (tolerance {TOL_BIAS})")
    print(line, flush=True)
    if not (rel <= TOL_F64 and worst <= 1.0 < control):
        raise RuntimeError(line)


def count_launches(label, family, n_force, n_energy):
    """The phase's pair-kernel launches since the counts were set to 0:
    exactly one per force evaluation and one per lambda of each energy
    sweep, all of instance ``family``, the sweeps' with energy."""
    from mollytpu_torch.ops import pair_kernel as pk
    n = pk.LAUNCHES
    if (n != n_force + n_energy or pk.INSTANCE_LAUNCHES[family] != n
            or pk.ENERGY_LAUNCHES[family] != n_energy):
        raise RuntimeError(
            f"{label}: pair kernel launched {n} times ({dict(pk.INSTANCE_LAUNCHES)}, "
            f"with energy {dict(pk.ENERGY_LAUNCHES)}) for {n_force} force "
            f"evaluations and {n_energy} energy evaluations of instance "
            f"{family}")
    print(f"{label}: {n} pair-kernel launches (instance {family}) = "
          f"{n_force} force evaluations + {n_energy} energy evaluations",
          flush=True)
    return n


def umbrella_cv(system, o_c):
    """CalcSingleDist from oxygen o_c to the oxygen nearest it in
    ``system``, and their distance."""
    import torch
    import mollytpu_torch as pt
    x = system.coords.double()
    oxy = torch.nonzero(system.atoms.mass > 2.0).flatten()
    d = system.boundary.displacement(x[o_c], x[oxy]).norm(dim=1)
    d = torch.where(oxy == o_c, torch.inf, d)
    k = int(torch.argmin(d))
    return pt.CalcSingleDist(int(o_c), int(oxy[k])), float(d[k])


def umbrella_phase(start, cv, space, pme_ms):
    """Umbrella-MBAR: each window from the previous window's end (the
    first from ``start``), UMB_WARMUP steps through simulate, then
    UMB_STEPS in chunks of UMB_SAMPLE with the K window energies after
    each; gates: launches, state, windows sampled, float64 at the last
    frame; then MBAR and the PMF (umbrella_mbar)."""
    import torch
    import mollytpu_torch as pt
    sim = pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)
    base = start.general_inters
    from mollytpu_torch.ops import pair_kernel as pk
    pk.reset_launch_counts()
    n_force = n_sweep = 0
    energies, cvs, closest, t_md, t_sweep = [], [], math.inf, 0.0, 0.0
    sigma = math.sqrt(pt.units.KB * TEMP / UMB_K)
    t_start = time.perf_counter()
    state = start
    for k, centre in enumerate(UMB_CENTERS):
        gen = torch.Generator(device=start.device).manual_seed(SEED + 100 + k)
        biased, nb, aux = pt.simulate(space.apply_state(state, k), sim,
                                      UMB_WARMUP, generator=gen)
        n_force += 1 + UMB_WARMUP
        step, samples, xs = UMB_WARMUP, [], []
        for _ in range(UMB_STEPS // UMB_SAMPLE):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            biased, nb, aux, near = pt.run_chunk(sim, biased, nb, aux, step,
                                                 UMB_SAMPLE, generator=gen)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            unbiased = biased.update(general_inters=base)
            samples.append(space.state_energies(unbiased, nb))
            xs.append(cv.value(unbiased.coords, unbiased.boundary).double())
            torch.cuda.synchronize()
            t_md += t1 - t0
            t_sweep += time.perf_counter() - t1
            closest = min(closest, near)
            step += UMB_SAMPLE
            n_force += UMB_SAMPLE
            n_sweep += 1
        state = biased.update(general_inters=base)
        energies.append(torch.stack(samples, dim=1))             # (K, S)
        x = torch.stack(xs)
        cvs.append(x)
        temp, viol = check_state(f"Umbrella-MBAR window {k}", state)
        mean, sd = float(x.mean()), float(x.std())
        line = (f"Umbrella-MBAR window {k} (centre {centre} nm): CV mean "
                f"{mean:.4f} sd {sd:.4f} nm over {len(xs)} samples; T "
                f"{temp:.2f} K, max constraint violation {viol:.3e} nm")
        print(line, flush=True)
        if not abs(mean - centre) <= UMB_SIGMAS * sigma:
            raise RuntimeError(line + f": the mean is more than {UMB_SIGMAS}"
                               f" x {sigma:.4f} nm from the centre")
    wall = time.perf_counter() - t_start
    launches = count_launches("Umbrella-MBAR", "coul3-ortho", n_force, n_sweep)
    n_md = len(UMB_CENTERS) * UMB_STEPS
    ms = 1e3 * t_md / n_md
    bias = space.biases[-1]
    t_bias = _time(lambda: bias.force_virial(state.coords, state.boundary,
                                             state.atoms))
    print(f"Umbrella-MBAR: {len(UMB_CENTERS)} windows x ({UMB_WARMUP} + "
          f"{UMB_STEPS}) steps in {wall:.1f} s; biased MD {ms:.4f} ms/step "
          f"(the unbiased PME path {pme_ms:.4f} ms/step in this run; the "
          f"bias's autograd forces {t_bias:.4f} ms per call); "
          f"{1e3 * t_sweep / n_sweep:.4f} ms per sample of the "
          f"{len(UMB_CENTERS)} window energies (one energy launch, the "
          "bias energies and the CV); unlisted atom pairs at the sampled "
          f"chunks' rebuilds at least {closest:.4f} nm apart", flush=True)
    check_states_f64("Umbrella-MBAR", space, state, nb)
    umbrella_mbar(torch.stack(energies), torch.cat(cvs))
    return dict(launches=launches, ms=ms, wall=wall)


def umbrella_mbar(e, x):
    """MBAR in float64 on the card from e[k, l, s] = U_l of sample s of
    window k, against the same solve on the CPU; the PMF along the CV
    reweighted to the unbiased state (u_kn[0] less window 0's bias), with
    error bars. Gates: the card's f within TOL_MBAR of the CPU's, every f
    finite, every value and error bar finite in each sampled bin."""
    import numpy as np
    import torch
    import mollytpu_torch as pt
    k = len(UMB_CENTERS)
    inp = pt.assemble_mbar_inputs(e, temperature=[TEMP] * k)
    t0 = time.perf_counter()
    f_card = pt.iterate_mbar(inp)
    torch.cuda.synchronize()
    t_mbar = time.perf_counter() - t0
    f_cpu = pt.iterate_mbar(pt.MBARInput(inp.u_kn.cpu(), inp.n_k.cpu()))
    diff = float((f_card.cpu() - f_cpu).abs().max())
    log_d = torch.logsumexp(torch.log(inp.n_k.double())[:, None]
                            + f_card[:, None] - inp.u_kn, dim=0)
    resid = (f_card[:, None] - inp.u_kn - log_d).exp().sum(dim=1) - 1.0
    line = (f"Umbrella-MBAR MBAR (float64, u_kn {tuple(inp.u_kn.shape)}): "
            f"f_k {[round(float(v), 4) for v in f_card.cpu()]} kT on the "
            f"card in {t_mbar:.3f} s; max |card - CPU| {diff:.3e} kT "
            f"(tolerance {TOL_MBAR}); MBAR equations' residual "
            f"{float(resid.abs().max()):.3e}")
    print(line, flush=True)
    if not bool(torch.isfinite(f_card).all()) or not diff <= TOL_MBAR:
        raise RuntimeError(line)
    beta = 1.0 / (pt.units.KB * TEMP)
    target = inp.u_kn[0] - beta * 0.5 * UMB_K * (x - UMB_CENTERS[0]) ** 2
    lo, hi, n_bins = PMF_BINS
    edges = np.linspace(lo, hi, n_bins + 1)
    t0 = time.perf_counter()
    pmf = pt.pmf_with_uncertainty(inp, x, edges, TEMP, target_state_u=target)
    plain = pt.mbar_pmf(inp, x, edges, TEMP, target_state_u=target)
    torch.cuda.synchronize()
    t_pmf = time.perf_counter() - t0
    counts = np.bincount(np.clip(np.searchsorted(
        edges, x.cpu().numpy()) - 1, 0, n_bins - 1), minlength=n_bins)
    vals, sig = pmf.values.cpu().numpy(), pmf.uncertainties.cpu().numpy()
    sampled = counts > 0
    print("Umbrella-MBAR PMF (kJ/mol, min 0; O-O distance: -kT ln g(r) - "
          f"2kT ln r + const; {t_pmf:.3f} s on the card): " + "; ".join(
              f"{c:.3f} nm {v:.3f} +- {u:.3f} ({n})" for c, v, u, n in zip(
                  pmf.centers.cpu().numpy(), vals, sig, counts)), flush=True)
    ok = (np.isfinite(vals[sampled]).all() and np.isfinite(sig[sampled]).all()
          and np.isfinite(plain.values.cpu().numpy()[sampled]).all())
    if not ok:
        raise RuntimeError("Umbrella-MBAR: a PMF value or error bar in a "
                           "sampled bin is not finite")


def run_awh(label, awh, start, family, per_sweep, gen):
    """One AWHSimulation run from ``start`` with its parts timed; gates:
    launches (per iteration init_aux, the segment's steps and the sweep's
    ``per_sweep`` energy launches), state, finite f. Returns the final
    System."""
    import numpy as np
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.free_energy import awh as awh_mod
    from mollytpu_torch.ops import pair_kernel as pk
    pk.reset_launch_counts()
    bucket = {}
    t0 = time.perf_counter()
    with timed_calls(bucket, (awh_mod, "run_chunk"),
                     (pt.ExtendedStateSpace, "state_energies"),
                     (pt.AWHSimulation, "_process_sample"),
                     (pt.AWHSimulation, "_gibbs_sample_window"),
                     (pt.AWHSimulation, "_update_bias"),
                     (pt.AWHPMFBackend, "update")):
        final = awh.simulate(start, AWH_MD * AWH_ITERS, seed=SEED,
                             generator=gen)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = count_launches(label, family, AWH_ITERS * (1 + AWH_MD),
                              AWH_ITERS * per_sweep)
    temp, viol = check_state(label, final)
    f = awh.free_energies()
    st = awh.state
    host = sum(bucket.get(k, 0.0) for k in (
        "_process_sample", "_gibbs_sample_window", "_update_bias", "update"))
    md, sweep = bucket["run_chunk"], bucket["state_energies"]
    line = (f"{label}: {AWH_ITERS} iterations of {AWH_MD} steps in "
            f"{wall:.2f} s, per iteration {1e3 * wall / AWH_ITERS:.2f} ms: "
            f"MD {1e3 * md / AWH_ITERS:.2f} ms ({1e3 * md / (AWH_ITERS * AWH_MD):.4f}"
            f" ms/step), energy sweep {1e3 * sweep / AWH_ITERS:.2f} ms, host "
            f"estimator {1e3 * host / AWH_ITERS:.3f} ms, the rest (list "
            "builds, init_aux, host reads) "
            f"{1e3 * (wall - md - sweep - host) / AWH_ITERS:.2f} ms; T "
            f"{temp:.2f} K, max constraint violation {viol:.3e} nm; windows "
            f"visited {sorted(set(st.stats.active_state))}, stage "
            f"{'initial' if st.covering_stage else 'linear'}, N "
            f"{st.ref_size:g}; f {np.round(f, 4).tolist()} kT")
    print(line, flush=True)
    if not np.isfinite(f).all():
        raise RuntimeError(line + ": f is not finite")
    return final, dict(launches=launches, wall=wall,
                       ms=1e3 * md / (AWH_ITERS * AWH_MD))


def awh_umbrella_phase(start, cv, space):
    """AWH-umbrella: AWHSimulation over the umbrella windows with its PMF
    backend; the deconvolved PMF finite in every sampled bin; float64 at
    the last frame."""
    import numpy as np
    import torch
    import mollytpu_torch as pt
    st = pt.AWHState.create(space, first_state=1)
    backend = pt.AWHPMFBackend(st, grid=AWH_GRID, cv=cv)
    awh = pt.AWHSimulation(
        state=st, simulator=pt.Langevin(dt=DT, temperature=TEMP,
                                        friction=FRICTION),
        n_md_steps=AWH_MD, log_freq=1, pmf=backend)
    gen = torch.Generator(device=start.device).manual_seed(SEED + 200)
    final, out = run_awh("AWH-umbrella", awh, start, "coul3-ortho", 1, gen)
    res = backend.pmf(zero="min", kBT=pt.units.KB * TEMP)
    vals, counts = res.values(), backend.acc.counts
    print("AWH-umbrella deconvolved PMF (kJ/mol, min 0): " + "; ".join(
        f"{c:.3f} nm {v:.3f} ({n})" for c, v, n in zip(res.centers, vals,
                                                         counts)), flush=True)
    if not np.isfinite(vals[counts > 0]).all():
        raise RuntimeError("AWH-umbrella: the PMF is not finite in a "
                           "sampled bin")
    check_states_f64("AWH-umbrella", space, final, final.neighbor_finder.find(
        final.coords, final.boundary, final.exclusions))
    return out


def grid_awh_phase(start, cv):
    """GridAWH on the CV (GridBias forces on the card); gates: launches
    (per update init_aux and its steps), state, finite estimate, the last
    GridBias against float64 on the last frame."""
    import numpy as np
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.free_energy import awh as awh_mod
    lo, hi, n_bins = GRID_AWH
    grid = pt.GridAWH(cv=cv, simulator=pt.Langevin(
        dt=DT, temperature=TEMP, friction=FRICTION), temperature=TEMP,
        lo=lo, hi=hi, n_bins=n_bins, n_steps_per_update=GRID_STEPS)
    gen = torch.Generator(device=start.device).manual_seed(SEED + 250)
    from mollytpu_torch.ops import pair_kernel as pk
    pk.reset_launch_counts()
    bucket = {}
    t0 = time.perf_counter()
    with timed_calls(bucket, (awh_mod, "simulate")):
        final, st = grid.simulate(start, GRID_UPDATES, generator=gen)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = count_launches("GridAWH", "coul3-ortho",
                              GRID_UPDATES * (1 + GRID_STEPS), 0)
    temp, viol = check_state("GridAWH", final)
    centers, f = grid.pmf(st)
    md = bucket["simulate"]
    line = (f"GridAWH: {GRID_UPDATES} updates of {GRID_STEPS} steps in "
            f"{wall:.2f} s, per update {1e3 * wall / GRID_UPDATES:.2f} ms "
            f"(simulate {1e3 * md / GRID_UPDATES:.2f} ms, "
            f"{1e3 * md / (GRID_UPDATES * GRID_STEPS):.4f} ms/step with its "
            f"list build and init_aux); T {temp:.2f} K, max constraint "
            f"violation {viol:.3e} nm; visits {st.hist.astype(int).tolist()},"
            f" update size {st.update_size:g} kJ/mol; estimate (kJ/mol) "
            + "; ".join(f"{c:.3f} {v:.2f}" for c, v in zip(centers, f)))
    print(line, flush=True)
    if not np.isfinite(f).all():
        raise RuntimeError(line + ": the estimate is not finite")
    bias = pt.GridBias(cv=cv, centers=torch.as_tensor(
        st.centers, dtype=final.coords.dtype, device=final.device),
        values=torch.as_tensor(-st.f_est, dtype=final.coords.dtype,
                               device=final.device))
    sys64, _ = f64_system(final, final.coords)
    df, de = check_bias_f64("GridAWH", bias, final, sys64)
    print(f"GridAWH last frame: GridBias vs float64 max|dF|/max|F| "
          f"{df:.3e}, rel dE {de:.3e} (tolerance {TOL_BIAS})", flush=True)
    return dict(launches=launches, wall=wall,
                ms=1e3 * md / (GRID_UPDATES * GRID_STEPS))


def lambda_ladder(mask):
    import numpy as np
    import mollytpu_torch as pt
    return pt.ExtendedStateSpace.lambda_grid(
        np.linspace(0.0, 1.0, N_LADDER), temperature=TEMP, atom_mask=mask)


def awh_lambda_phase(start, mask):
    """AWH-lambda: AWHSimulation over the lambda ladder on the inserted
    water (K1c; each sweep one energy launch per lambda); float64 at the
    last frame."""
    import torch
    import mollytpu_torch as pt
    space = lambda_ladder(mask)
    awh = pt.AWHSimulation(
        state=pt.AWHState.create(space, first_state=LADDER_START),
        simulator=pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION),
        n_md_steps=AWH_MD, log_freq=1)
    gen = torch.Generator(device=start.device).manual_seed(SEED + 300)
    final, out = run_awh("AWH-lambda", awh, start, FEP_FAMILY, N_LADDER, gen)
    check_states_f64("AWH-lambda", space, final, final.neighbor_finder.find(
        final.coords, final.boundary, final.exclusions))
    return out


def tss_lambda_phase(start, mask):
    """TSS-lambda: TSSSimulation over the lambda ladder with TSS_WINDOW-
    rung windows and two replicas; gates: launches (per replica and cycle
    init_aux, the segment's steps and one energy launch per evaluation
    state of its window), each replica's state, finite f and jackknife;
    float64 at replica 0's last frame."""
    import numpy as np
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.free_energy import tss as tss_mod
    space = lambda_ladder(mask)
    state = pt.TSSState(space, graph=pt.tss_grid_graph(
        (N_LADDER,), window_size=TSS_WINDOW),
        history_forgetting=pt.TSSHistoryForgetting())
    sim = pt.TSSSimulation(
        state, start, pt.Langevin(dt=DT, temperature=TEMP,
                                  friction=FRICTION),
        n_md_steps=TSS_MD, n_cycles=TSS_CYCLES, log_freq=1,
        n_replicas=len(TSS_STARTS), first_states=list(TSS_STARTS))
    gens = [torch.Generator(device=start.device).manual_seed(SEED + 400 + i)
            for i in range(len(TSS_STARTS))]
    from mollytpu_torch.ops import pair_kernel as pk
    pk.reset_launch_counts()
    bucket = {}
    t0 = time.perf_counter()
    with timed_calls(bucket, (tss_mod, "run_chunk"),
                     (pt.ExtendedStateSpace, "state_energies"),
                     (pt.TSSState, "apply_observations")):
        sim.run(seed=SEED, generators=gens)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    windows = [w for ws in state.stats["replica_update_windows"] for w in ws]
    n_eval = sum(len(state.windows[w].evaluation_state_indices)
                 for w in windows)
    launches = count_launches("TSS-lambda", FEP_FAMILY,
                              len(windows) * (1 + TSS_MD), n_eval)
    for i, r in enumerate(sim.replicas):
        temp, viol = check_state(f"TSS-lambda replica {i}", r.sys)
        print(f"TSS-lambda replica {i}: rung {r.state_index}, window "
              f"{r.window}; T {temp:.2f} K, max constraint violation "
              f"{viol:.3e} nm", flush=True)
    f = pt.tss_free_energies(state)
    # the delete-one-epoch jackknife is defined once every window has
    # samples in two retained epochs (tss_free_energy_uncertainties raises
    # otherwise): two walkers over seven windows may not get there in
    # TSS_CYCLES cycles
    histories = [est.history for est in state.estimators]
    retained = histories[0].retained_epoch_indices(state.iteration)
    epochs_hit = [sum(h.sample_count(epoch_indices=[e]) > 0
                      for e in retained) for h in histories]
    jk = None
    if len(retained) >= 2 and min(epochs_hit) >= 2:
        jk = pt.tss_free_energy_uncertainties(state)
    n_seg = len(windows)
    md, sweep = bucket["run_chunk"], bucket["state_energies"]
    host = bucket["apply_observations"]
    line = (f"TSS-lambda: {TSS_CYCLES} cycles x {len(TSS_STARTS)} replicas "
            f"of {TSS_MD} steps in {wall:.2f} s, per replica iteration "
            f"{1e3 * wall / n_seg:.2f} ms: MD {1e3 * md / n_seg:.2f} ms "
            f"({1e3 * md / (n_seg * TSS_MD):.4f} ms/step), energy sweep "
            f"{1e3 * sweep / n_seg:.2f} ms ({n_eval / n_seg:.2f} lambdas on "
            f"average), host estimator {1e3 * host / n_seg:.3f} ms per "
            f"replica ({1e3 * host / TSS_CYCLES:.3f} ms per cycle), the "
            f"rest {1e3 * (wall - md - sweep - host) / n_seg:.2f} ms; "
            f"windows visited {sorted(set(windows))}, retained epochs with "
            f"samples per window {epochs_hit}; f {np.round(f, 4).tolist()} "
            "kT; jackknife standard errors " + (
                f"{np.round(jk.standard_errors, 4).tolist()} kT over epochs "
                f"{jk.epoch_indices}" if jk is not None else
                "undefined (a window has samples in fewer than two "
                "retained epochs)"))
    print(line, flush=True)
    if not (np.isfinite(f).all() and (jk is None or (
            np.isfinite(jk.free_energies).all()
            and np.isfinite(jk.standard_errors).all()))):
        raise RuntimeError(line + ": a free energy or error is not finite")
    r0 = sim.replicas[0].sys
    check_states_f64("TSS-lambda", space, r0, r0.neighbor_finder.find(
        r0.coords, r0.boundary, r0.exclusions))
    return dict(launches=launches, wall=wall,
                ms=1e3 * md / (n_seg * TSS_MD))


def free_energy_phases(pme_end, fep_end, mask, pme_ms):
    """The five free-energy phases; returns each one's launches, biased
    ms/step and wall time."""
    o_c = int(mask.nonzero()[0])
    out = {}
    cv, d0 = umbrella_cv(pme_end, o_c)
    print(f"Free-energy phases: CV O-O distance from atom {cv.i} (FEP-water's"
          f" solute oxygen) to atom {cv.j}, {d0:.4f} nm on the PME path's "
          "end state", flush=True)
    import mollytpu_torch as pt
    space = pt.ExtendedStateSpace.umbrella_windows(
        [pt.BiasPotential(bias=pt.SquareBias(k=UMB_K, cv0=c), cv=cv)
         for c in UMB_CENTERS], temperature=TEMP)
    for label, run in (
            ("Umbrella-MBAR", lambda: umbrella_phase(pme_end, cv, space,
                                                     pme_ms)),
            ("AWH-umbrella", lambda: awh_umbrella_phase(pme_end, cv, space)),
            ("GridAWH", lambda: grid_awh_phase(pme_end, cv)),
            ("AWH-lambda", lambda: awh_lambda_phase(fep_end, mask)),
            ("TSS-lambda", lambda: tss_lambda_phase(fep_end, mask))):
        t0 = time.perf_counter()
        out[label] = run()
        print(f"{label}: phase wall time {time.perf_counter() - t0:.1f} s",
              flush=True)
    return out


def lattice_energy():
    """E_pair / N (epsilon) of in.lj's fcc lattice, summed over lattice
    vectors with numpy in reduced units (independent of the port)."""
    import numpy as np
    a = (4.0 / 0.8442) ** (1.0 / 3.0)
    basis = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    r = np.arange(-4, 5)
    cells = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 1, 3)
    d = np.linalg.norm(((cells + basis[None]) * a).reshape(-1, 3), axis=1)
    d = d[(d > 0) & (d < 2.5)]
    return 0.5 * float(np.sum(4.0 * (d ** -12 - d ** -6)))


def total_energy(system, nb):
    """(potential, kinetic) energy in kJ/mol, device scalars."""
    import mollytpu_torch as pt
    return (pt.potential_energy(system, nb),
            pt.kinetic_energy(system.masses, system.velocities))


def lj_nve(system, cadence, label):
    """in.lj's run 100 from the built state at a rebuild ``cadence``, in
    chunks of LJ_SAMPLE steps (run_chunk: its rebuilds, the stale-list
    check and the overflow check); the total energy at every chunk end.
    Returns (final system, list, aux, [(E_pot, E_kin)] per sample)."""
    import dataclasses as dc
    import mollytpu_torch as pt
    from mollytpu_torch.models import ljbench
    system = system.update(neighbor_finder=dc.replace(
        system.neighbor_finder, n_steps=cadence))
    sim = ljbench.lj_bench_integrator()
    nb = pt.find_neighbors(system.neighbor_finder, system.coords,
                           system.boundary, system.exclusions)
    aux = sim.init_aux(system, nb)
    samples = [total_energy(system, nb)]
    for step in range(0, LJ_RUN, LJ_SAMPLE):
        system, nb, aux, _ = pt.run_chunk(sim, system, nb, aux, step,
                                          LJ_SAMPLE)
        samples.append(total_energy(system, nb))
    return system, nb, aux, [(float(a), float(b)) for a, b in samples]


def lj_f64_check(label, sys32, f32, e32, sys64):
    """The f32 forces and pair energy at sys32's frame against a float64
    evaluation of the same frame (sys64's parameters), over the atoms with
    no pair within NEAR_CUT of the cutoff, where the f32 r^2 may put the
    pair on the other side of lj/cut's force jump."""
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.models import ljbench
    s64 = sys64.update(coords=sys32.coords.double())
    nb = pt.find_neighbors(s64.neighbor_finder, s64.coords, s64.boundary,
                           s64.exclusions)
    f64, _ = pt.forces_virial(s64, nb)
    e64 = pt.potential_energy(s64, nb)
    n = s64.n_atoms
    safe = torch.clamp(nb.idx, max=n - 1).long()
    dr = s64.boundary.mic_parts(tuple(s64.coords[:, k][safe]
                                      - s64.coords[:, k][:, None]
                                      for k in range(3)))
    r = torch.sqrt(dr[0] ** 2 + dr[1] ** 2 + dr[2] ** 2)
    close = (nb.idx < n) & ((r - ljbench.CUTOFF).abs() < NEAR_CUT)
    near = close.any(dim=1)
    near[safe[close]] = True
    rms = float(f64.pow(2).sum(dim=1).mean().sqrt())
    err = (f32.double() - f64).abs().amax(dim=1) / rms
    df = float(err[~near].max())
    de = abs(float(e32) - float(e64)) / abs(float(e64))
    print(f"{label}: f32 vs float64 on the frame: max|dF|/rms|F| {df:.3e} "
          f"over the {int((~near).sum())} atoms with no pair within "
          f"{NEAR_CUT} nm of the cutoff ({int(near.sum())} others, "
          f"{float(err[near].max()) if near.any() else 0.0:.3e}), rms|F| "
          f"{rms:.4f} kJ/mol/nm, rel dE {de:.3e}", flush=True)
    if df > TOL_LJ_FORCE or de > TOL_LJ_ENERGY:
        raise RuntimeError(f"{label}: f32 disagrees with float64")


def lj_components(label, system, nb, aux, cadence):
    """CUDA-event times (median of 20) of the step's parts and a
    torch.profiler summary of 20 steps: (ms per part, launches per step,
    device-busy share)."""
    import time as _t
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import mollytpu_torch as pt
    from mollytpu_torch.models import ljbench
    from mollytpu_torch.sim.simulate import list_check
    sim = ljbench.lj_bench_integrator()
    x, box = system.coords, system.boundary
    inters = system.pairwise_inters
    parts = {
        "whole step": lambda: sim.step(system, nb, aux, 0),
        "neighbor_forces": lambda: pt.neighbor_forces(
            inters, system.atoms, x, box, nb),
        "find (per rebuild)": lambda: system.neighbor_finder.find(
            x, box, system.exclusions),
        "stale check (per rebuild)": lambda: list_check(
            system, nb, ljbench.CUTOFF, nb),
    }
    ms = {}
    for name, fn in parts.items():
        ms[name] = _time(fn, 2, 20)
        print(f"{label} component: {name}: {ms[name]:.4f} ms", flush=True)
    ms["rest of the step"] = ms["whole step"] - ms["neighbor_forces"]
    print(f"{label} component: rest of the step (whole - neighbor_forces): "
          f"{ms['rest of the step']:.4f} ms; per step at a rebuild every "
          f"{cadence}: find + check "
          f"{(ms['find (per rebuild)'] + ms['stale check (per rebuild)']) / cadence:.4f}"
          " ms", flush=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = _t.perf_counter()
        s, a = system, aux
        for k in range(20):
            s, a = sim.step(s, nb, a, k)
        torch.cuda.synchronize()
        wall = (_t.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    launches = sum(e.count for e in avgs
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    # the device's own events (kernels, copies, fills): an operator's row
    # repeats the time of the kernels it launched
    device = [e for e in avgs
              if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy = sum(_dev_us(e) for e in device) / 1e3
    top = sorted(device, key=_dev_us, reverse=True)[:5]
    print(f"{label} profile, 20 steps: {launches / 20:g} kernel launches "
          f"per step, {busy / 20:.4f} ms device time per step ({wall / 20:.4f}"
          f" ms per step under the profiler); top: " + "; ".join(
              f"{e.key[:40]} {_dev_us(e) / 1e3:.3f} ms" for e in top),
          flush=True)
    return ms, launches / 20, busy / 20


@contextlib.contextmanager
def cell_finds(label):
    """Over the block, with neighbors.FIND_LAUNCHES set to 0 first, counts
    the cell finder's finds on card tensors and its twin's (find_plain)
    calls on card tensors. Gates after it: every such find launched the
    cell-list kernel once, and none took the twin. Yields the counts
    (``launches`` is filled in at the end)."""
    import mollytpu_torch as pt
    from mollytpu_torch.ops import neighbors
    cls = pt.CellListNeighborFinder
    real = {name: getattr(cls, name) for name in ("find", "find_plain")}
    counts = {"finds": 0, "twin": 0}

    def counting(name, key):
        def call(self, coords, *args, **kw):
            counts[key] += int(coords.is_cuda)
            return real[name](self, coords, *args, **kw)
        return call

    neighbors.FIND_LAUNCHES = 0
    cls.find = counting("find", "finds")
    cls.find_plain = counting("find_plain", "twin")
    try:
        yield counts
    finally:
        cls.find, cls.find_plain = real["find"], real["find_plain"]
    counts["launches"] = neighbors.FIND_LAUNCHES
    print(f"{label}: cell-list kernel launches over the phase "
          f"{counts['launches']} for {counts['finds']} finds on the card, "
          f"{counts['twin']} twin calls on the card", flush=True)
    if (counts["launches"] != counts["finds"] or counts["twin"]
            or not counts["finds"]):
        raise RuntimeError(f"{label}: a cell-list find on the card did not "
                           "launch the kernel once")


def cell_kernel_check(label, system):
    """The cell-list kernel on ``system``'s frame against its twin on the
    same card tensors: find (the kernel) and find_plain give the same idx,
    special and overflow element for element, no overflow, rows listed
    (gated). Times: the kernel's device ms per find (torch.profiler over
    25 finds), the whole find's (CUDA events around 25 back-to-back finds),
    the twin's (median of 25) and the bound of the bytes: the (N, K) int32
    idx and bool flags written, the coordinates, the sorted order (int64),
    the cell starts and the partner tables read."""
    import torch
    f, x, box, ex = (system.neighbor_finder, system.coords, system.boundary,
                     system.exclusions)

    def find():
        return f.find(x, box, ex)

    def twin():
        return f.find_plain(x, box, ex)

    got, want = find(), twin()
    n, k = got.idx.shape
    mismatches = int((got.idx != want.idx).sum()
                     + (got.special != want.special).sum())
    err = float((got.idx.long() - want.idx.long()).abs().max())
    over, over_twin = int(got.overflow), int(want.overflow)
    listed = int((got.idx < n).sum())
    del got, want
    find_ms = burst_ms(find)
    kernel_ms, calls = profiled(find, 25, kernel="cell_neighbors_kernel")
    plain_ms = _time(twin)
    torch.cuda.empty_cache()
    width = sum(int(table.shape[1]) for pairs, table in (
        (ex.excl_i, ex.excl_table), (ex.spec_i, ex.spec_table))
        if pairs.numel())
    n_bytes = (n * k * 5 + n * (3 * x.element_size() + 8 + 4 * width)
               + 4 * (math.prod(f.grid_dims) + 1))
    bound_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    print(f"{label}: cell-list kernel against its twin on the same card "
          f"tensors: {mismatches} of {2 * n * k} table elements differ, "
          f"overflow {over} / {over_twin}, {listed} pairs listed (K "
          f"{k}, capacity {f.cell_capacity}, grid {f.grid_dims}); "
          f"cell_neighbors_kernel {kernel_ms:.4f} ms, the whole find "
          f"{find_ms:.4f} ms ({calls:g} device calls), the twin "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({n_bytes / 1e6:.1f} "
          "MB over 3.35 TB/s)", flush=True)
    if mismatches or over != over_twin or over or listed < n:
        raise RuntimeError(f"{label}: the cell-list kernel's table differs "
                           "from the twin's")
    if not kernel_ms > 0.0:
        raise RuntimeError(f"{label}: the profiler saw no "
                           "cell_neighbors_kernel")
    return dict(max_abs_err=err, ms=kernel_ms, find_ms=find_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes")


def big_lj_frames(dev):
    """in.lj at CELL_BIG^3 fcc cells after CELL_MELT NVE steps at a rebuild
    every CELL_EVERY (f32), and that frame in float64."""
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.models import ljbench
    t0 = time.perf_counter()
    big = ljbench.lj_bench_system(CELL_BIG, torch.float32, dev, SEED,
                                  n_steps=CELL_EVERY)
    sim = ljbench.lj_bench_integrator()
    nb = pt.find_neighbors(big.neighbor_finder, big.coords, big.boundary,
                           big.exclusions)
    big, _, _, _ = pt.run_chunk(sim, big, nb, sim.init_aux(big, nb), 0,
                                CELL_MELT)
    big64 = ljbench.lj_bench_system(CELL_BIG, torch.float64, dev, SEED,
                                    n_steps=CELL_EVERY)
    big64 = big64.update(coords=big.coords.double())
    del nb
    torch.cuda.empty_cache()
    print(f"in.lj at {big.n_atoms} atoms melted {CELL_MELT} steps; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return big, big64


def cell_kernel_phase(lj_end, frames):
    """Cell-kernel: cell_kernel_check on LJ-bench's end frame (f32), on
    in.lj at CELL_BIG^3 fcc cells after CELL_MELT NVE steps (f32), and on
    that frame in float64 (``frames``, as big_lj_frames gives them).
    Returns {frame: the kernels-line numbers}."""
    big, big64 = frames
    out = {}
    for frame, system in (
            (f"LJ-bench's end frame, {lj_end.n_atoms:,} atoms, f32", lj_end),
            (f"in.lj at {big.n_atoms:,} atoms melted {CELL_MELT} steps, "
             "f32", big),
            (f"in.lj at {big.n_atoms:,} atoms melted {CELL_MELT} steps, "
             "f64", big64)):
        out[frame] = cell_kernel_check(f"Cell-kernel ({frame})", system)
    return out


@contextlib.contextmanager
def table_calls(label, kernel):
    """Over the block, with nonbonded.TABLE_LAUNCHES set to 0 first, counts
    the neighbor_forces calls on card coordinates that the dispatch rule
    admits (lj_table_admits) and refuses, and the autograd engine's
    calls on card coordinates. Gates after it: every admitted call
    launched the table kernel once and no refused one launched it; with
    ``kernel`` True every call was admitted and the engine never ran on
    the card, with False none was admitted (None: either). Yields the
    counts."""
    import mollytpu_torch as pt
    from mollytpu_torch.ops import nonbonded
    real = (nonbonded.neighbor_forces, nonbonded.neighbor_forces_plain)
    counts = {"admitted": 0, "refused": 0, "engine": 0}

    def forces(inters, atoms, coords, boundary, neighbors, *args, **kw):
        if coords.is_cuda:
            counts["admitted" if nonbonded.lj_table_admits(
                inters, atoms, coords, boundary, neighbors)
                else "refused"] += 1
        return real[0](inters, atoms, coords, boundary, neighbors, *args,
                       **kw)

    def engine(inters, atoms, coords, *args, **kw):
        counts["engine"] += int(coords.is_cuda)
        return real[1](inters, atoms, coords, *args, **kw)

    nonbonded.TABLE_LAUNCHES = 0
    nonbonded.neighbor_forces = pt.neighbor_forces = forces
    nonbonded.neighbor_forces_plain = engine
    try:
        yield counts
    finally:
        nonbonded.neighbor_forces = pt.neighbor_forces = real[0]
        nonbonded.neighbor_forces_plain = real[1]
    counts["launches"] = nonbonded.TABLE_LAUNCHES
    print(f"{label}: table-kernel launches over the phase "
          f"{counts['launches']} for {counts['admitted']} admitted "
          f"neighbor_forces calls on the card ({counts['refused']} refused, "
          f"{counts['engine']} autograd-engine calls on the card)",
          flush=True)
    ok = counts["launches"] == counts["admitted"]
    if kernel is True:
        ok = ok and counts["admitted"] > 0 and not (counts["refused"]
                                                    or counts["engine"])
    elif kernel is False:
        ok = ok and counts["admitted"] == 0
    if not ok:
        raise RuntimeError(f"{label}: the table kernel's launches do not "
                           "follow the dispatch rule")


def table_build():
    """Build csrc/lj_table.cu; print each instance's registers and spills
    from ptxas's log (a spill fails the run)."""
    from mollytpu_torch.ops import native
    path, secs, log = native.build("lj_table")
    inst, regs_of, spills = None, {}, []
    for ln in log.splitlines():
        m = re.search(r"lj_table_kernelI([fd])Lb([01])ELb([01])E", ln)
        if "Compiling entry function" in ln and m:
            inst = m.groups()
        elif "spill" in ln and inst and re.search(r"[1-9]\d* bytes spill",
                                                  ln):
            spills.append(inst)
        elif "registers" in ln and inst:
            regs = re.search(r"Used (\d+) registers", ln)
            regs_of[inst] = regs.group(1) if regs else ln.strip()
    built = f"built in {secs:.1f} s" if secs else "up to date"
    print(f"{os.path.relpath(path)}: {built}; registers (type, triclinic, "
          "virial): " + ", ".join(f"{t} {b} {v}: {r}" for (t, b, v), r in
                                  sorted(regs_of.items())), flush=True)
    if len(regs_of) != TABLE_INSTANCES or spills:
        raise RuntimeError(f"lj_table: {len(regs_of)} instances in the ptxas "
                           f"log ({TABLE_INSTANCES} expected), spills in "
                           f"{spills}")


def table_kernel_check(label, system):
    """The table kernel on ``system``'s frame against the autograd engine
    on the same card tensors, forces-only and with the virial (gated at
    TOL_TABLE). Times: the kernel's device ms per call (torch.profiler
    over 25 forces-only calls), the whole call's (CUDA events around 25
    back-to-back calls), the engine's
    (median of 25) and the bound of the bytes: the live table slots and
    the sentinel that ends each row, the coordinates, sigma, epsilon and
    lambda read once and the forces written once."""
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.ops import nonbonded
    x, box, atoms = system.coords, system.boundary, system.atoms
    inters = system.pairwise_inters
    nb = pt.find_neighbors(system.neighbor_finder, x, box, system.exclusions)
    if not nonbonded.lj_table_admits(inters, atoms, x, box, nb):
        raise RuntimeError(f"{label}: the dispatch rule refuses the frame")
    errs = {}
    for virial in (False, True):
        f, v = nonbonded.neighbor_forces(inters, atoms, x, box, nb,
                                         needs_virial=virial)
        f0, v0 = nonbonded.neighbor_forces_plain(inters, atoms, x, box, nb,
                                                 needs_virial=virial)
        rms = float(f0.double().pow(2).sum(dim=1).mean().sqrt())
        errs["forces" if not virial else "forces (virial call)"] = float(
            (f.double() - f0.double()).abs().max()) / rms
        if virial:
            errs["virial"] = float((v.double() - v0.double()).abs().max()) \
                / float(v0.double().abs().max())
    del f, v, f0, v0

    def kernel():
        return nonbonded.lj_table_forces(inters[0], atoms, x, box, nb)

    def engine():
        return nonbonded.neighbor_forces_plain(inters, atoms, x, box, nb)

    call_ms = burst_ms(kernel)
    kernel_ms, calls = profiled(kernel, 25, kernel="lj_table_kernel")
    engine_ms = _time(engine)
    torch.cuda.empty_cache()
    n = system.n_atoms
    live = int((nb.idx < n).sum())
    size = x.element_size()
    n_bytes = 4 * (live + n) + n * size * (3 + 2 + (atoms.lam is not None)
                                           + 3)
    bound_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    tol = TOL_TABLE[str(x.dtype).split(".")[-1]]
    print(f"{label}: table kernel against the autograd engine on the same "
          "card tensors: " + ", ".join(f"{k} {e:.3e}" for k, e in
                                       errs.items())
          + f" (limit {tol:g}); {live} live slots of {nb.idx.numel()} (K "
          f"{nb.idx.shape[1]}); lj_table_kernel {kernel_ms:.4f} ms; the "
          f"whole call {call_ms:.4f} ms ({calls:g} device calls), the "
          f"engine {engine_ms:.4f} ms; bound {bound_ms:.4f} ms "
          f"({n_bytes / 1e6:.1f} MB over 3.35 TB/s)", flush=True)
    if not max(errs.values()) <= tol:
        raise RuntimeError(f"{label}: the table kernel disagrees with the "
                           "engine")
    if not kernel_ms > 0.0:
        raise RuntimeError(f"{label}: the profiler saw no lj_table_kernel")
    return dict(max_abs_err=max(errs.values()), ms=kernel_ms,
                call_ms=call_ms, plain_ms=engine_ms, bound_ms=bound_ms,
                bound_by="bytes")


def table_kernel_phase(lj_end, frames):
    """Table-kernel: table_kernel_check on LJ-bench's end frame (f32) and
    on the Cell-kernel phase's in.lj at 256,000 atoms (f32 and f64).
    Returns {frame: the kernels-line numbers}."""
    big, big64 = frames
    out = {}
    for frame, system in (
            (f"LJ-bench's end frame, {lj_end.n_atoms:,} atoms, f32", lj_end),
            (f"in.lj at {big.n_atoms:,} atoms melted {CELL_MELT} steps, "
             "f32", big),
            (f"in.lj at {big.n_atoms:,} atoms melted {CELL_MELT} steps, "
             "f64", big64)):
        out[frame] = table_kernel_check(f"Table-kernel ({frame})", system)
    return out


def lj_bench_path(dev, line):
    """LJ-bench: LAMMPS's in.lj at 32,000 atoms on the general pair path.
    Gates: the lattice energy (f32 and f64), no overflow and no stale list
    at any rebuild (run_chunk raises), f32 against float64 after in.lj's
    100 steps, the NVE drift against the f64 run's, finite coordinates
    and T < 1000 K, no pair-kernel launch, no host sync between two
    rebuilds; then the timed run and its components."""
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.models import ljbench
    from mollytpu_torch.ops import pair_kernel as pk
    label = "LJ-bench"
    t0 = time.perf_counter()
    sys32 = ljbench.lj_bench_system(LJ_CELLS, torch.float32, dev, SEED)
    sys64 = ljbench.lj_bench_system(LJ_CELLS, torch.float64, dev, SEED)
    f = sys32.neighbor_finder
    print(f"{label}: {sys32.n_atoms} atoms in a "
          f"{float(sys32.boundary.side_lengths[0]):.4f} nm cube (in.lj, "
          f"{LJ_CELLS}^3 fcc cells); CellListNeighborFinder radius "
          f"{f.dist_cutoff:.4f} nm, grid {f.grid_dims}, cell capacity "
          f"{f.cell_capacity}, {f.max_neighbors} neighbors per row "
          f"(Poisson mean + 6 sigma); setup "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    k1 = (pk.LAUNCHES, dict(pk.INSTANCE_LAUNCHES))
    ref = lattice_energy()
    e0 = {}
    for name, s in (("f32", sys32), ("f64", sys64)):
        nb = pt.find_neighbors(s.neighbor_finder, s.coords, s.boundary,
                               s.exclusions)
        e0[name] = float(pt.potential_energy(s, nb)) / s.n_atoms \
            / ljbench.EPSILON
    d32, d64 = (abs(e0[k] / ref - 1.0) for k in ("f32", "f64"))
    print(f"{label}: step-0 E_pair/N {e0['f32']:.9f} (f32), "
          f"{e0['f64']:.12f} (f64) epsilon against the numpy lattice sum "
          f"{ref:.12f} (LAMMPS prints -6.7733681): relative {d32:.3e}, "
          f"{d64:.3e}", flush=True)
    if d32 > TOL_LJ_E0_F32 or d64 > TOL_LJ_E0_F64:
        raise RuntimeError(f"{label}: the step-0 lattice energy is off")
    for cadence in LJ_CADENCES:
        try:
            out32, nb32, aux32, en32 = lj_nve(sys32, cadence, label)
            break
        except pt.StaleNeighborList as err:
            print(f"{label}: at a rebuild every {cadence} steps the stale-"
                  f"list check stopped in.lj's run: {err}", flush=True)
    else:
        raise RuntimeError(f"{label}: stale at every cadence tried")
    out64, _, _, en64 = lj_nve(sys64, cadence, label)
    drift = {}
    for name, en in (("f32", en32), ("f64", en64)):
        e_tot = [a + b for a, b in en]
        drift[name] = max(abs(e - e_tot[0]) for e in e_tot) \
            / sys32.n_atoms / ljbench.EPSILON
    temp = {}
    for name, s in (("0", sys32), (str(LJ_RUN), out32)):
        temp[name] = float(pt.temperature(s.masses, s.velocities, s.n_dof))
    print(f"{label}: run {LJ_RUN} at a rebuild every {cadence} steps: T "
          f"{temp['0']:.3f} K at step 0, {temp[str(LJ_RUN)]:.3f} K at step "
          f"{LJ_RUN}; E_pair/N {en32[0][0] / sys32.n_atoms:.6f} and "
          f"{en32[-1][0] / sys32.n_atoms:.6f} epsilon at steps 0 and "
          f"{LJ_RUN}; NVE drift max|E(t) - E(0)|/N, E sampled every "
          f"{LJ_SAMPLE} steps: f32 {drift['f32']:.3e}, f64 "
          f"{drift['f64']:.3e} epsilon (gate: f32 <= 2 f64 + "
          f"{LJ_DRIFT_SLACK})", flush=True)
    if not bool(torch.isfinite(out32.coords).all()) or not (
            temp[str(LJ_RUN)] < 1000.0):
        raise RuntimeError(f"{label}: the state after the run is bad")
    if drift["f32"] > 2.0 * drift["f64"] + LJ_DRIFT_SLACK:
        raise RuntimeError(f"{label}: f32 drift beyond twice f64's")
    lj_f64_check(label, out32, aux32["forces"],
                 pt.potential_energy(out32, nb32), sys64)
    run = {"sim": ljbench.lj_bench_integrator(), "system": out32,
           "nb": nb32, "aux": aux32, "gen": None}
    start = LJ_RUN + (-LJ_RUN) % cadence
    if start > LJ_RUN:
        run["system"], run["nb"], run["aux"], _ = pt.run_chunk(
            run["sim"], out32, nb32, aux32, LJ_RUN, start - LJ_RUN)
    steps_without_sync(label, run, start, cadence - 1,
                       note=" (between two rebuilds)")

    # the timed run, from the in.lj end state
    sim = ljbench.lj_bench_integrator()
    system, nb, aux = out32, nb32, aux32
    system, nb, aux, _ = pt.run_chunk(sim, system, nb, aux, LJ_RUN,
                                      LJ_WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    system, nb, aux, _ = pt.run_chunk(sim, system, nb, aux,
                                      LJ_RUN + LJ_WARMUP, LJ_TIMED)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / LJ_TIMED
    if (pk.LAUNCHES, dict(pk.INSTANCE_LAUNCHES)) != k1:
        raise RuntimeError(f"{label}: the pair kernel was launched")
    n = system.n_atoms
    per_s = 1e3 / ms
    tau_day = 86400.0 * per_s * 0.005
    print(f"card: {line}; {label}: {ms:.4f} ms/step over {LJ_TIMED} steps "
          f"after {LJ_WARMUP} (rebuild every {cadence}): {per_s:.2f} "
          f"timesteps/s, {n * per_s / 1e3:.1f} katom-step/s, "
          f"{tau_day:.1f} tau/day, "
          f"{pt.units.ps_per_step_to_ns_per_day(ljbench.DT, ms * 1e-3):.4f}"
          f" ns/day; pair-kernel launches over the phase: 0", flush=True)
    comps, calls, dev_ms = lj_components(label, system, nb, aux, cadence)
    print(f"{label}: device busy {dev_ms / ms:.3f} of the step "
          f"({dev_ms:.4f} ms device time per {ms:.4f} ms step)", flush=True)
    return {"ms": ms, "cadence": cadence, "calls": calls,
            "busy": dev_ms / ms, "tau_day": tau_day, "components": comps,
            "end": system, "liquid64": out64}


def melt_frame(dev):
    """in.melt's size: 10^3 fcc cells (4,000 atoms) at 3.0 epsilon / kB,
    melted by MELT_STEPS f32 steps (a rebuild every 5): the frame of the
    engine and form checks, with per-atom sigma and epsilon (so that the
    mixing rules differ), charges, Buckingham parameters, lambdas, roles
    and type ids from a seeded generator."""
    import dataclasses as dc
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.models import ljbench
    s = ljbench.lj_bench_system(MELT_CELLS, torch.float32, dev, SEED,
                                n_steps=5, t_reduced=MELT_T)
    sim = ljbench.lj_bench_integrator()
    s, _, _ = pt.simulate(s, sim, MELT_STEPS)
    n = s.n_atoms
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=dev)

    atoms = dc.replace(
        s.atoms, sigma=uniform(0.32, 0.36), epsilon=uniform(0.8, 1.2),
        charge=uniform(-0.5, 0.5), lam=uniform(0.2, 1.0),
        alch_role=torch.randint(0, 3, (n,), generator=gen, device=dev,
                                dtype=torch.int32),
        atom_type=torch.randint(0, 3, (n,), generator=gen, device=dev,
                                dtype=torch.int32),
        buck_A=uniform(2e5, 3e5), buck_B=uniform(30.0, 35.0),
        buck_C=uniform(4e-3, 6e-3))
    return s.update(atoms=atoms)


def form_inters():
    """The forms the general path adds, each with a 0.85 nm cutoff whose
    force goes to zero there (a truncated force jumps, which f32 and f64
    may put on either side): the nine potentials, the two new cutoffs,
    the three new mixing rules and an NBFix table."""
    import mollytpu_torch as pt
    from mollytpu_torch.models import ljbench
    rc = ljbench.CUTOFF
    sf = pt.ShiftedForceCutoff(rc)
    table = pt.ExceptionTable((0, 1), (1, 2), (0.30, 0.36))
    eps = pt.ExceptionTable((0, 1), (1, 2), (1.5, 0.5))
    kw = dict(use_neighbors=True)
    forms = {
        "AshbaughHatch": pt.AshbaughHatch(cutoff=sf, **kw),
        "SoftSphere": pt.SoftSphere(cutoff=sf, **kw),
        "Mie": pt.Mie(m=6.0, n=10.0, cutoff=sf, **kw),
        "Buckingham": pt.Buckingham(cutoff=sf, **kw),
        "DoubleExponential": pt.DoubleExponential(16.5, 4.5, cutoff=sf,
                                                  **kw),
        "DoubleExponentialSoftCore": pt.DoubleExponentialSoftCore(
            16.5, 4.5, cutoff=sf, **kw),
        "Gravity": pt.Gravity(G=1e-3, cutoff=sf, **kw),
        "Yukawa": pt.Yukawa(cutoff=sf, kappa=2.0, **kw),
        "DPDInteraction": pt.DPDInteraction(r_c=rc, dt=ljbench.DT, **kw),
        "CubicSplineCutoff": pt.LennardJones(
            cutoff=pt.CubicSplineCutoff(0.7, rc), **kw),
        "PolynomialCutoff": pt.LennardJones(
            cutoff=pt.PolynomialCutoff(0.7, rc), **kw),
        "NBFix": pt.LennardJones(
            cutoff=sf, sigma_mixing=pt.MixingException(pt.LorentzMixing(),
                                                       table),
            epsilon_mixing=pt.MixingException(pt.GeometricMixing(), eps),
            **kw),
    }
    for rule in ("WaldmanHaglerMixing", "FenderHalseyMixing",
                 "InverseMixing"):
        r = getattr(pt, rule)()
        forms[rule] = pt.LennardJones(cutoff=sf, sigma_mixing=r,
                                      epsilon_mixing=r, **kw)
    return forms


def forms_phase(dev):
    """On in.melt's frame: the dense engine against the neighbor engine for
    in.lj's LJ (f32), then each form: f32 against f64 (neighbor engine)
    and the neighbor engine against the dense one (f32)."""
    import dataclasses as dc
    import torch
    import mollytpu_torch as pt
    t0 = time.perf_counter()
    frame = melt_frame(dev)
    n = frame.n_atoms
    frame64 = frame.update(
        atoms=frame.atoms.to(dtype=torch.float64),
        coords=frame.coords.double(),
        boundary=frame.boundary.to(dtype=torch.float64),
        velocities=frame.velocities.double())
    nb = pt.find_neighbors(frame.neighbor_finder, frame.coords,
                           frame.boundary, frame.exclusions)
    nb64 = pt.find_neighbors(frame64.neighbor_finder, frame64.coords,
                             frame64.boundary, frame64.exclusions)
    print(f"forms: in.melt frame, {n} atoms after {MELT_STEPS} steps at "
          f"{MELT_T} epsilon / kB; {time.perf_counter() - t0:.1f} s",
          flush=True)

    def forces(s, inter, table, dense):
        inter = dc.replace(inter, use_neighbors=not dense)
        f, _ = pt.forces_virial(s.update(pairwise_inters=(inter,)),
                                None if dense else table, step_n=3)
        return f.double()

    def ratio(a, b):
        rms = max(1.0, float(b.pow(2).sum(dim=1).mean().sqrt()))
        return float((a - b).abs().max()) / rms, rms

    lj = frame.pairwise_inters[0]
    eng, rms = ratio(forces(frame, lj, nb, True), forces(frame, lj, nb,
                                                          False))
    print(f"forms: in.lj's LJ, dense engine against the cell-list engine "
          f"(f32): max|dF|/rms|F| {eng:.3e} (rms|F| {rms:.3f})", flush=True)
    if eng > TOL_ENGINES:
        raise RuntimeError("forms: the engines disagree")
    worst = {}
    for name, inter in form_inters().items():
        f32 = forces(frame, inter, nb, False)
        f64 = forces(frame64, inter, nb64, False)
        dense = forces(frame, inter, nb, True)
        r64, rms = ratio(f32, f64)
        rdense, _ = ratio(dense, f32)
        worst[name] = (r64, rdense)
        print(f"forms: {name}: f32 vs f64 {r64:.3e}, neighbor vs dense "
              f"(f32) {rdense:.3e} of rms|F| {rms:.4f}", flush=True)
        if not (r64 <= TOL_FORMS_F64 and rdense <= TOL_ENGINES):
            raise RuntimeError(f"forms: {name} disagrees")
    return worst


def dpd_card_phase(dev):
    """DPD: the pair noise's bits on the card equal the CPU's for the same
    (i, j, step); 20 DPDVelocityVerlet steps in float64 on the card match
    the CPU's to TOL_DPD nm."""
    import numpy as np
    import torch
    import mollytpu_torch as pt
    d = pt.DPDInteraction()
    rng = np.random.default_rng(SEED)
    i = rng.integers(0, 1 << 20, 200_000)
    j = rng.integers(0, 1 << 20, 200_000)
    for step in (0, 12345):
        xi = {name: d._xi(torch.as_tensor(i, device=where),
                          torch.as_tensor(j, device=where), step).cpu()
              for name, where in (("card", dev), ("cpu", "cpu"))}
        same = bool(torch.equal(xi["card"].view(torch.int32),
                                xi["cpu"].view(torch.int32)))
        print(f"DPD: xi bits on the card vs the CPU at step {step}, "
              f"{len(i)} pairs: {'equal' if same else 'DIFFERENT'}",
              flush=True)
        if not same:
            raise RuntimeError("DPD: the card's noise differs from the CPU's")
    side = (DPD_N / 3.0) ** (1.0 / 3.0)
    x = rng.uniform(0.0, side, (DPD_N, 3))
    v = rng.normal(size=(DPD_N, 3))
    out = []
    for where in (dev, torch.device("cpu")):
        s = pt.System(
            atoms=pt.make_atoms(n=DPD_N, mass=1.0, dtype=torch.float64,
                                device=where),
            coords=torch.as_tensor(x, device=where),
            boundary=pt.cubic(side, dtype=torch.float64, device=where),
            velocities=torch.as_tensor(v, device=where),
            pairwise_inters=(pt.DPDInteraction(),),
            neighbor_finder=pt.CellListNeighborFinder.setup(
                pt.cubic(side, dtype=torch.float64, device=where), 1.8,
                DPD_N, n_steps=5))
        o, _, _ = pt.simulate(s, pt.DPDVelocityVerlet(dt=0.01), DPD_STEPS)
        out.append(o.coords.cpu())
    dx = float((out[0] - out[1]).abs().max())
    print(f"DPD: {DPD_N} particles, {DPD_STEPS} DPDVelocityVerlet steps in "
          f"float64, card vs CPU: max|dx| {dx:.3e} nm", flush=True)
    if not dx <= TOL_DPD:
        raise RuntimeError("DPD: the card's trajectory differs from the CPU's")


def pme_evaluation_times(label, system):
    """CUDA-event times (median of 20) of one PME evaluation on the frame:
    forces, and forces with the virial, with the box's cached influence
    function, and with it recomputed (a new box object per call: every
    evaluation did so before the cache)."""
    import torch
    import mollytpu_torch as pt
    (pme,) = [g for g in system.general_inters if isinstance(g, pt.PME)]
    x, box, atoms = system.coords, system.boundary, system.atoms
    out = {}
    for virial in (False, True):
        cached = _time(lambda: pme.force_virial(x, box, atoms, virial), 2, 20)
        fresh = _time(lambda: pme.force_virial(
            x, dataclasses.replace(box), atoms, virial), 2, 20)
        influence = _time(lambda: pme._make_influence(box, torch.float32),
                          2, 20)
        out[virial] = cached
        print(f"{label} PME (mesh {pme.mesh_dims}) force_virial"
              f"{' with the virial' if virial else ''}: {cached:.4f} ms "
              f"with the box's cached influence function, {fresh:.4f} ms "
              f"recomputing it ({influence:.4f} ms for the influence "
              "function alone)", flush=True)
    return out


def production_phase(run, workdir):
    """The production run on the PME-dodecahedron path's end state through
    simulate with loggers and an XTC writer (module constants PROD_*), then
    a checkpoint: the generator's state after the load, and RESUME_STEPS
    resumed steps against as many uninterrupted ones. Gates: each log's
    record count, finite records, the first PE record against a direct
    potential_energy call, the XTC read back against the logged
    coordinates, the state, exact pair-kernel launch counts, the resumed
    coordinates. Returns the timing and the launch counts."""
    import numpy as np
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.ops import pair_kernel as pk
    label = "PME-dodecahedron production"
    sim, system, nb, aux, gen, step = (run[k] for k in (
        "sim", "system", "nb", "aux", "gen", "step"))
    xtc = os.path.join(workdir, "production.xtc")
    loggers = {
        "T": pt.TemperatureLogger(PROD_LOG),
        "KE": pt.KineticEnergyLogger(PROD_LOG),
        "PE": pt.PotentialEnergyLogger(PROD_LOG),
        "E": pt.TotalEnergyLogger(PROD_LOG),
        "P": pt.ScalarPressureLogger(PROD_SLOW),
        "V": pt.VolumeLogger(PROD_SLOW),
        "x": pt.CoordinatesLogger(PROD_SLOW),
        "xtc": pt.TrajectoryWriter(PROD_SLOW, xtc)}
    pe0 = float(pt.potential_energy(system, nb, step))
    pk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    system, nb, aux, logs = pt.simulate(
        system, sim, PROD_STEPS, generator=gen, neighbors=nb, aux=aux,
        init_step=step, loggers=loggers)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / PROD_STEPS
    # per step one force evaluation, on the steps before a pressure record
    # with the virial; per PE and E record one energy evaluation; a
    # pressure record at the first step refreshes the continued run's
    # virial
    steps = range(step, step + PROD_STEPS + 1)
    n_fast = sum(1 for k in steps if k % PROD_LOG == 0)
    n_slow = sum(1 for k in steps if k % PROD_SLOW == 0)
    n_virial = sum(1 for k in steps[:-1] if (k + 1) % PROD_SLOW == 0)
    refresh = int(step % PROD_SLOW == 0)
    want = PROD_STEPS + 2 * n_fast + refresh
    want_energy = n_virial + 2 * n_fast + refresh
    family = "coul3-triclinic"
    launches, own = pk.LAUNCHES, pk.INSTANCE_LAUNCHES[family]
    energy = pk.ENERGY_LAUNCHES[family]
    if launches != want or own != want or energy != want_energy:
        raise RuntimeError(
            f"{label}: {launches} pair-kernel launches ({own} of {family}, "
            f"{energy} with energy) for {PROD_STEPS} steps and the records "
            f"(want {want}, {want_energy} with energy)")
    counts = {"T": n_fast, "KE": n_fast, "PE": n_fast, "E": n_fast,
              "P": n_slow, "V": n_slow, "x": n_slow, "xtc": n_slow}
    for name, n in counts.items():
        rec = logs[name]
        if rec.shape[0] != n or not bool(torch.isfinite(
                rec.double()).all()):
            raise RuntimeError(f"{label}: log {name} holds {rec.shape[0]} "
                               f"records (want {n}) or a non-finite one")
    de = abs(float(logs["PE"][0]) - pe0) / abs(pe0)
    if de > TOL_PE_LOG:
        raise RuntimeError(f"{label}: the first PE record "
                           f"{float(logs['PE'][0])} against a direct call "
                           f"{pe0} (rel {de:.3e})")
    temp, viol = check_state(label, system)
    t0 = time.perf_counter()
    frames = pt.read_xtc_coords(xtc)
    read_s = time.perf_counter() - t0
    dx = float(np.abs(frames - logs["x"].numpy()).max()) \
        if frames.shape == tuple(logs["x"].shape) else math.inf
    if dx > TOL_XTC:
        raise RuntimeError(f"{label}: the XTC read back ({frames.shape}) "
                           f"differs from the logged coordinates by {dx} nm")
    loggers["xtc"] = pt.TrajectoryWriter(PROD_SLOW,
                                         os.path.join(workdir, "t.xtc"))
    record_ms = {name: statistics.median(
        _host_ms(lambda: lg.observe(system, nb, aux, 0)) for _ in range(3))
        for name, lg in loggers.items()}
    xtc_ms = record_ms["xtc"]
    per_step = {name: ms_ / loggers[name].interval
                for name, ms_ in record_ms.items()}
    print(f"{label}: ms per record (median of 3, host clock): " + ", ".join(
        f"{name} {ms_:.3f}" for name, ms_ in record_ms.items())
        + f"; per step at these intervals: loggers "
        f"{sum(v for k, v in per_step.items() if k != 'xtc'):.3f} ms, XTC "
        f"writer {per_step['xtc']:.3f} ms", flush=True)
    print(f"{label}: {PROD_STEPS} steps from step {step}, {ms:.4f} ms/step "
          f"with the loggers (T, KE, PE, E every {PROD_LOG} steps; P, V, "
          f"coordinates and the XTC writer every {PROD_SLOW}) against "
          f"{run['ms']:.4f} ms/step bare; {xtc_ms:.2f} ms per XTC frame "
          f"({system.n_atoms} atoms, host clock), the file read back in "
          f"{read_s:.2f} s, {frames.shape[0]} frames within {dx:.2e} nm of "
          f"the logged coordinates; {launches} pair-kernel launches "
          f"({energy} with energy: PE and E records, the pressure's virial "
          f"steps); first PE record {float(logs['PE'][0]):.6e} against a "
          f"direct call {pe0:.6e} (rel {de:.2e}); mean T "
          f"{float(logs['T'].mean()):.2f} K, mean P "
          f"{float(logs['P'].mean()) / pt.units.BAR:.1f} bar; final T "
          f"{temp:.2f} K, constraint violation {viol:.3e} nm", flush=True)
    step += PROD_STEPS
    resumed = resume_check(label, sim, system, nb, aux, gen, step, workdir)
    return dict(ms=ms, xtc_ms=xtc_ms, launches=own - energy + resumed,
                energy_launches=energy)


def _host_ms(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def resume_check(label, sim, system, nb, aux, gen, step, workdir):
    """save_checkpoint at ``step``, load_checkpoint into the system, and
    RESUME_STEPS resumed steps against as many uninterrupted ones: the
    generator's state after the load identical to the saved one, the
    coordinates within TOL_RESUME. Returns the pair-kernel launches."""
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.ops import pair_kernel as pk
    path = os.path.join(workdir, "production.npz")
    pt.save_checkpoint(path, system, step, gen, aux=aux)
    state = gen.get_state()
    pk.reset_launch_counts()
    loaded, step_n, gen2, extra = pt.load_checkpoint(path, system)
    if step_n != step or not torch.equal(gen2.get_state(), state):
        raise RuntimeError(f"{label}: the checkpoint's step or generator "
                           "state differs from the saved one")
    full, _, _ = pt.simulate(system, sim, RESUME_STEPS, generator=gen,
                             neighbors=nb, aux=aux, init_step=step)
    back, _, _ = pt.simulate(loaded, sim, RESUME_STEPS, generator=gen2,
                             aux=extra["aux"], init_step=step_n)
    dx = float((back.coords - full.coords).abs().max())
    if pk.LAUNCHES != 2 * RESUME_STEPS or not dx <= TOL_RESUME:
        raise RuntimeError(f"{label}: resumed coordinates {dx} nm from the "
                           f"uninterrupted run's, {pk.LAUNCHES} launches")
    print(f"{label}: checkpoint at step {step}, generator state identical "
          f"after the load ({state.numel()} bytes); {RESUME_STEPS} resumed "
          f"steps within {dx:.3e} nm of {RESUME_STEPS} uninterrupted ones",
          flush=True)
    return pk.LAUNCHES


def integrators_phase(run):
    """Each new integrator for INTEGRATOR_STEPS steps through simulate from
    the PME-dodecahedron path's end state: the state gates, no stale list,
    exactly one pair-kernel launch per step and one for the first forces;
    ms/step on the host clock. Returns the launches."""
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.ops import pair_kernel as pk
    system, gen, step = run["system"], run["gen"], run["step"]
    sims = {
        "Verlet": pt.Verlet(dt=DT),
        "StormerVerlet": pt.StormerVerlet(dt=DT),
        "NoseHoover": pt.NoseHoover(dt=DT, temperature=TEMP,
                                    damping=NH_DAMPING),
        "LangevinSplitting BAOAB": pt.LangevinSplitting(
            dt=DT, temperature=TEMP, friction=FRICTION, splitting="BAOAB"),
        "LangevinSplitting BAOOAB": pt.LangevinSplitting(
            dt=DT, temperature=TEMP, friction=FRICTION, splitting="BAOOAB"),
    }
    total = 0
    for name, sim in sims.items():
        pk.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _, aux = pt.simulate(system, sim, INTEGRATOR_STEPS,
                                  generator=gen, init_step=step)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / INTEGRATOR_STEPS
        want = 1 + INTEGRATOR_STEPS
        own = pk.INSTANCE_LAUNCHES["coul3-triclinic"]
        if pk.LAUNCHES != want or own != want:
            raise RuntimeError(f"integrators phase, {name}: {pk.LAUNCHES} "
                               f"pair-kernel launches for {want} force "
                               "evaluations")
        temp, viol = check_state(f"integrators phase, {name}", out)
        extra = (f", zeta {float(aux['nh_zeta']):.4f} 1/ps"
                 if "nh_zeta" in aux else "")
        print(f"integrators phase, {name}: {INTEGRATOR_STEPS} steps, "
              f"{ms:.4f} ms/step (setup of the list and first forces "
              f"included), {pk.LAUNCHES} launches; T {temp:.2f} K, "
              f"constraint violation {viol:.3e} nm{extra}", flush=True)
        total += own
    return total


def muller_brown_phase(dev):
    """OverdampedLangevin on the Muller-Brown surface, MB_N particles in
    float64, MB_STEPS steps on the card and on the CPU from the same start
    with the same injected noise: coordinates within TOL_MB."""
    import torch
    import mollytpu_torch as pt
    gen = torch.Generator().manual_seed(SEED)
    x0 = torch.rand((MB_N, 3), generator=gen, dtype=torch.float64)
    x0 = x0 * torch.tensor([2.0, 2.0, 0.0], dtype=torch.float64) \
        + torch.tensor([-1.2, -0.2, 0.0], dtype=torch.float64)
    noise = [torch.randn((MB_N, 3), generator=gen, dtype=torch.float64)
             for _ in range(MB_STEPS)]
    sim = pt.OverdampedLangevin(dt=1e-4, temperature=100.0, friction=10.0,
                                remove_cm=False)
    outs = []
    for device in (dev, torch.device("cpu")):
        system = pt.System(
            atoms=pt.make_atoms(n=MB_N, mass=1.0, dtype=torch.float64,
                                device=device),
            coords=x0.to(device), boundary=pt.rectangular(
                [math.inf] * 3, dtype=torch.float64, device=device),
            general_inters=(pt.MullerBrown(),))
        out, _, _ = pt.simulate(system, sim, MB_STEPS,
                                noise=lambda k: noise[k].to(device))
        outs.append(out.coords.cpu())
    dx = float((outs[0] - outs[1]).abs().max())
    moved = float((outs[1] - x0).abs().max())
    print(f"OverdampedLangevin on Muller-Brown ({MB_N} particles, float64, "
          f"{MB_STEPS} steps, the same noise): card against CPU {dx:.3e} nm "
          f"(the particles moved up to {moved:.3e} nm)", flush=True)
    if not dx <= TOL_MB:
        raise RuntimeError("Muller-Brown: the card's trajectory differs from "
                           "the CPU's")


def site_check(label, system, aux):
    """TIP4P-Ew-PME's gate after a chunk: every site on the position its
    parents give it within SITE_TOL nm, and its force row exactly 0 (moved
    onto its parents). Returns the largest site offset (nm)."""
    vs = system.virtual_sites
    off = float((vs.positions(system.coords, system.boundary)
                 - system.coords[vs.site_idx]).abs().max())
    f_site = float(aux["forces"][vs.site_idx].abs().max())
    if not off <= SITE_TOL or f_site != 0.0:
        raise RuntimeError(f"{label}: a site {off:.3e} nm off its average3 "
                           f"position, site force {f_site:.3e}")
    return off


def tip4p_path(dev, workdir, line, pme):
    """TIP4P-Ew-PME: the PME cube's lattice with four-site waters (M a
    virtual site), the main path with its gates, the site gate after every
    chunk, PME per evaluation with the charged sites, and a rebuild
    interval without a host sync. ``pme`` is the TIP3P PME path's run."""
    import torch
    label = "TIP4P-Ew-PME"
    t0 = time.perf_counter()
    system = water_system(dev, torch.float32, workdir, "pme", CUBE,
                          model="tip4pew")
    torch.cuda.synchronize()
    vs = system.virtual_sites
    print(f"{label}: {describe(system)}; {vs.n_sites} virtual sites, "
          f"n_dof {system.n_dof}; setup {time.perf_counter() - t0:.1f} s",
          flush=True)
    if (system.n_atoms, vs.n_sites, system.n_dof) != (
            4 * N_WATERS, N_WATERS, 6 * N_WATERS - 3):
        raise RuntimeError(f"{label}: {system.n_atoms} particles, "
                           f"{vs.n_sites} sites, n_dof {system.n_dof}")
    stats = compare(f"{label} water{system.n_atoms}", system, timing=True)
    if stats["family"] != TIP4P_FAMILY:
        raise RuntimeError(f"{label} runs instance {stats['family']}")
    offsets = []
    run = main_path(label, system, 2, TIP4P_FAMILY, after_chunk=lambda s, a:
                    offsets.append(site_check(label, s, a)))
    print(f"{label}: after each of {len(offsets)} chunks every site within "
          f"{max(offsets):.3e} nm of its average3 position and every site "
          f"force row 0; {run['ms']:.4f} ms/step, {run['ns_day']:.4f} ns/day "
          f"against TIP3P PME's {pme['ms']:.4f} ms/step, "
          f"{pme['ns_day']:.4f} ns/day in this call ({system.n_atoms} "
          f"against {3 * N_WATERS} particles); card {line}", flush=True)
    pme_eval = pme_evaluation_times(label, run["system"])
    components(label, run)
    steps_without_sync(label, run, run["step"], CADENCE)
    return {**{k: run[k] for k in ("launches", "ms", "ns_day")},
            "stats": stats, "pme_ms": pme_eval[False]}


def lincs_check(label, system):
    """LINCS-PME's gate after a chunk: the largest constraint violation
    under LINCS_TOL nm. Returns it."""
    viol = float(system.constraints[0].max_violation(system.coords,
                                                     system.boundary))
    if not viol < LINCS_TOL:
        raise RuntimeError(f"{label}: LINCS violation {viol:.3e} nm")
    return viol


def lincs_times(label, system):
    """CUDA-event times (median of 20) of LINCS on the frame, positions and
    velocities, and of cluster SHAKE / RATTLE on the same O-H pairs."""
    import torch
    import mollytpu_torch as pt
    (lincs,) = system.constraints
    shake = pt.SHAKERattle.build(
        torch.stack([lincs.idx_i, lincs.idx_j], 1).cpu().numpy(),
        lincs.dists.cpu().numpy(), dtype=torch.float32, device=system.device)
    x, v, m, box = (system.coords, system.velocities, system.masses,
                    system.boundary)
    moved = x + DT * v
    out, ms = {}, {}
    for name, c in (("LINCS", lincs), ("SHAKE", shake)):
        ms[name] = (_time(lambda: c.apply_position_constraints(
            x, moved, v, m, box, DT), 2, 20), _time(
            lambda: c.apply_velocity_constraints(x, v, m, box), 2, 20))
        out[name] = c.apply_position_constraints(x, moved, v, m, box, DT)[0]
    diff = float((out["LINCS"] - out["SHAKE"]).abs().max())
    print(f"{label}: per call on the same frame and {lincs.n_constraints} "
          f"O-H pairs, LINCS positions {ms['LINCS'][0]:.4f} ms, velocities "
          f"{ms['LINCS'][1]:.4f} ms; SHAKE positions {ms['SHAKE'][0]:.4f} "
          f"ms, RATTLE velocities {ms['SHAKE'][1]:.4f} ms; the two projected "
          f"positions {diff:.3e} nm apart", flush=True)
    return ms


def lincs_pme_path(dev, workdir, line):
    """LINCS-PME: the Bonded-PME box (flexible angles) with its 10,636 O-H
    constraints on LINCS, the main path with the LINCS gate after every
    chunk, LINCS against SHAKE per call, and a rebuild interval without a
    host sync."""
    import torch
    label = "LINCS-PME"
    t0 = time.perf_counter()
    system = water_system(dev, torch.float32, workdir, "pme", CUBE,
                          rigid=False, algorithm="lincs")
    torch.cuda.synchronize()
    kinds = [(type(c).__name__, c.n_constraints) for c in system.constraints]
    print(f"{label}: {describe(system)}; solvers {kinds}; setup "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if kinds != [("LINCS", 2 * N_WATERS)]:
        raise RuntimeError(f"{label}: constraints split as {kinds}")
    stats = compare(f"{label} water{system.n_atoms}", system, timing=True)
    if stats["family"] != LINCS_FAMILY:
        raise RuntimeError(f"{label} runs instance {stats['family']}")
    viol = []
    run = main_path(label, system, 2, LINCS_FAMILY, after_chunk=lambda s, a:
                    viol.append(lincs_check(label, s)))
    print(f"{label}: LINCS violation after each of {len(viol)} chunks at "
          f"most {max(viol):.3e} nm (gate {LINCS_TOL} nm); card {line}",
          flush=True)
    ms = lincs_times(label, run["system"])
    components(label, run)
    steps_without_sync(label, run, run["step"], CADENCE)
    return {**{k: run[k] for k in ("launches", "ms", "ns_day")},
            "stats": stats, "lincs_ms": ms}


def gromacs_path(dev, workdir, line):
    """GROMACS-PME: the TIP3P cube written as .gro / .top with [ settles ],
    built by system_from_gromacs (the neighbor-table engine over a cell
    list, no pair kernel); its forces term by term against
    system_from_pdb's on the same coordinates; GMX_STEPS Langevin steps."""
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.ops import pair_kernel as pk
    label = "GROMACS-PME"
    t0 = time.perf_counter()
    pdb = pt.water_box_pdb(os.path.join(workdir, "water-gmx.pdb"), N_WATERS,
                           seed=SEED)
    gro, top = pt.water_box_gromacs(pdb, os.path.join(workdir, "water.gro"),
                                    os.path.join(workdir, "water.top"))


    system = pt.system_from_gromacs(gro, top, nonbonded_method="pme",
                                    use_settles=True, dtype=torch.float32,
                                    device=dev)
    torch.cuda.synchronize()
    print(f"{label}: {system.n_atoms} atoms, "
          f"{system.constraints[0].n_constraints} settle constraints, "
          f"n_dof {system.n_dof}, a cell list of grid "
          f"{system.neighbor_finder.grid_dims}; setup "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    own = water_system(dev, torch.float32, workdir, "pme", CUBE).update(
        coords=system.coords)
    x, box = system.coords, system.boundary
    nb_g = system.neighbor_finder.find(x, box, system.exclusions)
    nb_p = own.neighbor_finder.find(x, box, own.exclusions)
    launches0 = pk.LAUNCHES
    f_g = pt.forces_virial(system.update(general_inters=()), nb_g)[0]
    with uncounted():
        f_p = pt.forces_virial(own.update(general_inters=()), nb_p)[0]
    parts = [("LJ + Ewald real space (the GROMACS system's neighbor "
              "engine takes the polynomial erfc of approximate_pme=True, "
              "the pair kernel CUDA's erfcf)", f_g, f_p)]
    for gg, gp in zip(system.general_inters, own.general_inters):
        parts.append((type(gg).__name__,
                      gg.force_virial(x, box, system.atoms)[0],
                      gp.force_virial(x, box, own.atoms)[0]))
    total_g = sum(p[1] for p in parts)
    total_p = sum(p[2] for p in parts)
    rms = float(total_p.pow(2).sum(dim=1).mean().sqrt())
    for name, fa, fb in parts:
        print(f"{label} vs system_from_pdb on the same coordinates, "
              f"{name}: max|dF| {float((fa - fb).abs().max()):.3e} "
              f"kJ/mol/nm", flush=True)
    df = float((total_g - total_p).abs().max()) / rms
    with uncounted():
        e_p = float(pt.potential_energy(own, nb_p))
    e_g = float(pt.potential_energy(system, nb_g))
    de = abs(e_g - e_p) / abs(e_p)
    c_g, c_p = system.constraints[0], own.constraints[0]
    dd = float((c_g.dists - c_p.dists).abs().max())
    print(f"{label} vs system_from_pdb: all forces max|dF|/rms|F| {df:.3e}, "
          f"rel dE {de:.3e} (E {e_p:.6e} kJ/mol); the settle lengths "
          f"{dd:.3e} nm from the rigid-water triangles'", flush=True)
    if df > TOL_GMX_FORCE or de > TOL_GMX_ENERGY or dd > 1e-6:
        raise RuntimeError(f"{label}: the GROMACS system disagrees with "
                           "system_from_pdb's")
    sim = pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    start = system.update(velocities=pt.random_velocities(
        system.masses, TEMP, gen))
    t0 = time.perf_counter()
    out, _, _ = pt.simulate(start, sim, GMX_STEPS, generator=gen)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / GMX_STEPS
    temp, viol = check_state(label, out)
    if pk.LAUNCHES != launches0:
        raise RuntimeError(f"{label}: the pair kernel was launched")
    cadence = system.neighbor_finder.n_steps
    print(f"{label}: {GMX_STEPS} steps (list radius "
          f"{system.neighbor_finder.dist_cutoff} nm, rebuild every "
          f"{cadence}, the list builds included) {ms:.4f} "
          f"ms/step, T {temp:.2f} K, constraint violation {viol:.3e} nm, no "
          f"pair-kernel launch; card {line}", flush=True)
    return {"ms": ms, "cadence": cadence}


def _option_diff(label, f32, f64, e32, e64):
    """Card float32 against CPU float64: max|dF| over rms|F| and the
    relative energy; gated at TOL_OPTION_FORCE and TOL_OPTION_ENERGY."""
    f64 = f64.to(f32.device)
    rms = float(f64.pow(2).sum(dim=1).mean().sqrt())
    df = float((f32.double() - f64).abs().max()) / rms
    de = abs(float(e32) - float(e64)) / max(1.0, abs(float(e64)))
    if df > TOL_OPTION_FORCE or de > TOL_OPTION_ENERGY:
        raise RuntimeError(f"{label}: card against float64 CPU: "
                           f"max|dF|/rms|F| {df:.3e}, rel dE {de:.3e}")
    return df, de


def gb_check(dev, workdir):
    """OBC2 and GBn2 on an open cluster of GB_WATERS TIP3P waters
    (nonbonded_method="none"): the implicit-solvent term's energy and
    forces in float32 on the card against float64 on the CPU."""
    import torch
    import mollytpu_torch as pt
    path = pt.water_box_pdb(os.path.join(workdir, "gb.pdb"), GB_WATERS,
                            seed=SEED)
    with open(path) as f:
        lines = [ln for ln in f if not ln.startswith("CRYST1")]
    with open(path, "w") as f:
        f.write("".join(lines))
    for model in ("obc2", "gbn2"):
        built = {}
        for device, dtype in ((dev, torch.float32),
                              (torch.device("cpu"), torch.float64)):
            s = pt.system_from_pdb(path, pt.ForceField(pt.TIP3P_XML),
                                   nonbonded_method="none", dtype=dtype,
                                   device=device, implicit_solvent=model)
            (gb,) = [g for g in s.general_inters
                     if "ImplicitSolvent" in type(g).__name__]
            f, _ = gb.force_virial(s.coords, s.boundary, s.atoms)
            built[dtype] = (f, gb.energy(s.coords, s.boundary, s.atoms), gb,
                            s)
        f32, e32, gb, s = built[torch.float32]
        f64, e64, _, _ = built[torch.float64]
        df, de = _option_diff(f"GB {model}", f32, f64, e32, e64)
        ms = _time(lambda: gb.force_virial(s.coords, s.boundary, s.atoms),
                   1, 5)
        print(f"Setup option GB {type(gb).__name__} ({model}, "
              f"{s.n_atoms}-atom open cluster): card f32 against CPU f64 "
              f"max|dF|/rms|F| {df:.3e}, rel dE {de:.3e} (E "
              f"{float(e64):.6e} kJ/mol); {ms:.4f} ms per force evaluation",
              flush=True)


def cmap_check(dev):
    """A CMAP list over random five-atom chains on a random 24 x 24 grid:
    float32 on the card against float64 on the CPU."""
    import numpy as np
    import torch
    import mollytpu_torch as pt
    rng = np.random.default_rng(SEED)
    table = pt.cmap_coefficients(rng.normal(size=(24, 24)))[None]
    # bonds of 0.15 nm, each at 60-120 degrees to the one before (a
    # near-straight angle makes a dihedral's gradient blow up in float32)
    x = [rng.uniform(0.5, 5.5, (CMAP_CHAINS, 3))]
    bond = None
    for _ in range(4):
        v = rng.normal(size=(CMAP_CHAINS, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        while bond is not None:
            bad = np.abs((v * bond).sum(axis=1)) > 0.5
            if not bad.any():
                break
            w = rng.normal(size=(int(bad.sum()), 3))
            v[bad] = w / np.linalg.norm(w, axis=1, keepdims=True)
        bond = v
        x.append(x[-1] + 0.15 * v)
    coords = np.stack(x, axis=1).reshape(-1, 3)
    idx = np.arange(5 * CMAP_CHAINS).reshape(-1, 5).T
    maps = np.zeros(CMAP_CHAINS, dtype=np.int64)
    out = {}
    for device, dtype in ((dev, torch.float32),
                          (torch.device("cpu"), torch.float64)):
        sl = pt.make_cmap_list(*idx, maps, table, 24, dtype=dtype,
                               device=device)
        box = pt.cubic(6.0, dtype=dtype, device=device)
        xt = torch.as_tensor(coords, dtype=dtype, device=device)
        out[dtype] = (pt.specific_forces(sl, xt, box)[0],
                      pt.specific_energy(sl, xt, box), sl, xt, box)
    f32, e32, sl, xt, box = out[torch.float32]
    df, de = _option_diff("CMAP", f32, out[torch.float64][0], e32,
                          out[torch.float64][1])
    ms = _time(lambda: pt.specific_forces(sl, xt, box), 2, 20)
    print(f"Setup option CMAP ({CMAP_CHAINS} chains, 24 x 24 grid): card "
          f"f32 against CPU f64 max|dF|/rms|F| {df:.3e}, rel dE {de:.3e}; "
          f"{ms:.4f} ms per force evaluation", flush=True)


def global_shake_check(dev):
    """The global SHAKE / RATTLE sweeps on SHAKE_RINGS six-rings (a graph
    with no cluster shape): float32 on the card against float64 on the
    CPU, positions and velocities."""
    import numpy as np
    import torch
    import mollytpu_torch as pt
    rng = np.random.default_rng(SEED)
    ang = np.arange(6) * np.pi / 3
    ring = 0.14 * np.stack([np.cos(ang), np.sin(ang), 0 * ang], 1)
    centres = rng.uniform(0.5, 9.5, (SHAKE_RINGS, 3))
    coords = (centres[:, None] + ring[None]).reshape(-1, 3)
    pairs = np.array([(6 * r + i, 6 * r + (i + 1) % 6)
                      for r in range(SHAKE_RINGS) for i in range(6)])
    dists = np.full(len(pairs), 0.14)
    masses = np.tile([12.0, 1.0], 3 * SHAKE_RINGS)
    vels = rng.normal(scale=1.0, size=coords.shape)
    out = {}
    for device, dtype in ((dev, torch.float32),
                          (torch.device("cpu"), torch.float64)):
        c = pt.SHAKERattle.build(pairs, dists, dtype=dtype, device=device)
        if c.clusters:
            raise RuntimeError("the rings were split into clusters")
        t = [torch.as_tensor(a, dtype=dtype, device=device)
             for a in (coords, vels, masses)]
        box = pt.cubic(10.0, dtype=dtype, device=device)
        runs = []
        for _ in range(SHAKE_REPEATS if dtype == torch.float32 else 1):
            xn, _ = c.apply_position_constraints(
                t[0], t[0] + DT * t[1], t[1], t[2], box, DT)
            runs.append((xn, c.apply_velocity_constraints(xn, t[1], t[2],
                                                          box)))
        out[dtype] = (runs, c, t, box)
    runs, c, t, box = out[torch.float32]
    (x64, v64), = out[torch.float64][0]
    dx = [float((xn.double().cpu() - x64).abs().max()) for xn, _ in runs]
    dv = [float((vn.double().cpu() - v64).abs().max()) for _, vn in runs]
    viol = max(float(c.max_violation(xn, box)) for xn, _ in runs)
    ms = _time(lambda: c.apply_position_constraints(
        t[0], t[0] + DT * t[1], t[1], t[2], box, DT), 1, 5)
    print(f"Setup option global SHAKE ({SHAKE_RINGS} six-rings, "
          f"{c.n_constraints} constraints, {c.n_iters} sweeps): card f32 "
          f"against CPU f64 over {SHAKE_REPEATS} card calls, positions "
          f"{min(dx):.3e}-{max(dx):.3e} nm (gate {TOL_SHAKE_POS}), "
          f"velocities {min(dv):.3e}-{max(dv):.3e} nm/ps (gate "
          f"{TOL_SHAKE_VEL}); violation {viol:.3e} nm; {ms:.4f} ms per "
          "SHAKE call", flush=True)
    if max(dx) > TOL_SHAKE_POS or max(dv) > TOL_SHAKE_VEL:
        raise RuntimeError("global SHAKE: card against float64 CPU")


def vsite_types_check(dev):
    """The four virtual-site types, outOfPlane among them, placed and their
    forces distributed: float32 on the card against float64 on the CPU."""
    import numpy as np
    import torch
    import mollytpu_torch as pt
    rng = np.random.default_rng(SEED)
    n = 4 * VSITES
    coords = rng.uniform(0.0, 4.0, (n, 3))
    kinds = ("one", "average2", "average3", "outOfPlane")
    specs = [(4 * g + 3, kinds[g % 4], (4 * g, 4 * g + 1, 4 * g + 2)[
        :{"one": 1, "average2": 2}.get(kinds[g % 4], 3)],
        tuple(rng.uniform(-0.5, 1.0, 3))) for g in range(VSITES)]
    forces = rng.normal(size=(n, 3))
    out = {}
    for device, dtype in ((dev, torch.float32),
                          (torch.device("cpu"), torch.float64)):
        vs = pt.VirtualSites.build(specs, dtype=dtype, device=device)
        box = pt.cubic(4.0, dtype=dtype, device=device)
        x = vs.place(torch.as_tensor(coords, dtype=dtype, device=device), box)
        f = vs.distribute_forces(x, box, torch.as_tensor(
            forces, dtype=dtype, device=device))
        out[dtype] = (x, f)
    dx = float((out[torch.float32][0].double().cpu()
                - out[torch.float64][0]).abs().max())
    df = float((out[torch.float32][1].double().cpu()
                - out[torch.float64][1]).abs().max())
    print(f"Setup option virtual sites ({VSITES} sites of the four types): "
          f"card f32 against CPU f64 placement {dx:.3e} nm, distributed "
          f"forces {df:.3e} kJ/mol/nm", flush=True)
    if dx > 1e-5 or df > 1e-4:
        raise RuntimeError("virtual sites: card against float64 CPU")


def setup_options_phase(dev, workdir):
    gb_check(dev, workdir)
    cmap_check(dev)
    global_shake_check(dev)
    vsite_types_check(dev)


# --- slice 11: replica exchange, Monte Carlo, gradients, calculators -------


def recording(cls):
    """``cls`` (a REMD class) with each exchange's inputs and outputs and
    H-REMD's self and cross energies kept, for the host's recomputation."""

    @dataclasses.dataclass(frozen=True)
    class Recording(cls):
        log: list = dataclasses.field(default_factory=list)

        def exchange(self, *args):
            out = super().exchange(*args)
            self.log.append(("exchange", args, out))
            return out

        def energies(self, *args):
            out = super().energies(*args)
            self.log.append(("energies", args, out))
            return out

    return Recording


def check_exchanges(label, remd, temps=None, beta=None):
    """Each recorded exchange against the host's recomputation in float64
    from the printed energies and uniforms: the same swaps (read from the
    rows each slot received, which a gather copies exactly), and the
    velocities rescaled by exactly sqrt(T_i / T_j) (T-REMD; H-REMD: not
    rescaled). Returns the last exchange's (pre-exchange coords, self
    energies as floats)."""
    import numpy as np
    import torch
    from mollytpu_torch.sim.remd import exchange_pairs
    from mollytpu_torch.units import KB
    cross, last, n_acc = None, None, 0
    for kind, args, out in remd.log:
        if kind == "energies":
            cross = [o.double().cpu().numpy() for o in out]
            continue
        if temps is not None:
            coords, vels, pes, c, u = args
            e = pes.double().cpu().numpy()
        else:
            _, coords, vels, c, u = args[:5]
            e = out[2].double().cpu().numpy()
        u = u.double().cpu().numpy()
        r = len(u)
        partner, lower, valid = exchange_pairs(r, c)
        if temps is not None:
            b = 1.0 / (KB * np.asarray(temps, dtype=np.float64))
            delta = (b - b[partner]) * (e[partner] - e)
            what = "U_i(x_i)"
        else:
            es, ec = cross
            if not np.array_equal(es, e):
                raise RuntimeError(f"{label} cycle {c}: the recorded self "
                                   "energies are not the history's")
            delta = beta * (ec + ec[partner] - es - es[partner])
            what = (f"U_i(x_partner) {[float(x) for x in ec]!r} kJ/mol, "
                    "U_i(x_i)")
        u_pair = np.where(lower, u, u[partner])
        accept = np.asarray(valid) & (u_pair < np.exp(np.minimum(-delta,
                                                                 0.0)))
        expect = [partner[i] if accept[i] else i for i in range(r)]
        perm = [next((j for j in range(r)
                      if torch.equal(out[0][i], coords[j])), -1)
                for i in range(r)]
        perm_t = torch.as_tensor(perm, device=vels.device)
        if temps is not None:
            t = torch.as_tensor(temps, dtype=torch.float64,
                                device=vels.device)
            want_v = vels[perm_t] * torch.sqrt(t / t[perm_t]).to(
                vels.dtype)[:, None, None]
        else:
            want_v = vels[perm_t]
        n_acc += int(sum(accept[i] for i in range(r) if lower[i]))
        print(f"{label} cycle {c}: {what} {[float(x) for x in e]!r} kJ/mol, "
              f"uniforms {[float(x) for x in u]!r}; host float64: swap "
              f"{[(i, partner[i]) for i in range(r) if lower[i] and accept[i]]}"
              f"; slots received {perm}", flush=True)
        if perm != expect:
            raise RuntimeError(f"{label} cycle {c}: slots received {perm}, "
                               f"the host's recomputation gives {expect}")
        if not torch.equal(out[1], want_v):
            raise RuntimeError(f"{label} cycle {c}: the velocities are not "
                               "the partner's " + (
                                   "rescaled by sqrt(T_i / T_j)"
                                   if temps is not None else "unscaled"))
        last = (coords, e)
    return last, n_acc


def remd_f64(label, template, coords, energies, lams=None, mask=None):
    """Each replica's last-cycle energy (f32, the kernel's energy
    instance) against a float64 evaluation through the plain twins on the
    same coordinates (at its lambda for H-REMD)."""
    import mollytpu_torch as pt
    worst = 0.0
    for i in range(coords.shape[0]):
        sys64, nb64 = f64_system(template, coords[i])
        if lams is not None:
            sys64 = pt.set_lambda(sys64, lams[i], atom_mask=mask)
        e64 = float(f64_forces_energy(sys64, nb64)[1])
        worst = max(worst, abs(float(energies[i]) - e64) / abs(e64))
    print(f"{label}: the last cycle's {coords.shape[0]} replica energies "
          f"against float64 twins: max rel dE {worst:.3e} (tolerance "
          f"{TOL_F64})", flush=True)
    if worst > TOL_F64:
        raise RuntimeError(f"{label}: a replica energy disagrees with "
                           "float64")


def t_remd_phase(pme_end, pme_ms):
    """T-REMD-PME: four replicas of the PME path's end state on the
    REMD_TEMPS ladder, Langevin at each rung's temperature, REMD_CYCLES
    cycles of REMD_CYCLE steps. Gates: K1a launched exactly once per force
    evaluation (each segment's init_aux and steps) plus once with energy
    per replica per cycle, no stale list (run_chunk raises), the exchanges
    against the host's float64 recomputation, the last cycle's energies
    against float64, each replica's state."""
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.ops import pair_kernel as pk
    from mollytpu_torch.sim import remd as remd_mod
    label = "T-REMD-PME"
    r = len(REMD_TEMPS)
    remd = recording(pt.ReplicaExchangeMD)(
        temperatures=list(REMD_TEMPS),
        simulator=pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION),
        cycle_length=REMD_CYCLE)
    gen = torch.Generator(device=pme_end.device).manual_seed(SEED + 600)
    pk.reset_launch_counts()
    bucket = {}
    t0 = time.perf_counter()
    with timed_calls(bucket, (remd_mod, "run_segments"),
                     (remd_mod, "potential_energy"),
                     (type(remd), "exchange")):
        ens, info = remd.simulate(pme_end, REMD_CYCLES, generator=gen)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_seg = r * REMD_CYCLES
    launches = count_launches(label, "coul3-ortho",
                              n_seg * (1 + REMD_CYCLE), n_seg)
    (coords, pes), n_acc = check_exchanges(label, remd, temps=REMD_TEMPS)
    remd_f64(label, ens.template, coords, pes)
    for i in range(r):
        check_state(f"{label} replica {i}", ens.replica(i))
    md_ms = 1e3 * bucket["run_segments"] / (n_seg * REMD_CYCLE)
    ex_ms = 1e3 * (bucket["potential_energy"] + bucket["exchange"]) \
        / REMD_CYCLES
    print(f"{label}: {r} replicas on {list(REMD_TEMPS)} K, {REMD_CYCLES} "
          f"cycles of {REMD_CYCLE} steps in {wall:.2f} s; exchange rate "
          f"{info['exchange_rate']:.3f} ({n_acc} of "
          f"{REMD_CYCLES * (r // 2)} attempts); {md_ms:.4f} ms per replica-"
          f"step (each segment's list, init_aux and stale checks included)"
          f" beside the PME path's {pme_ms:.4f} ms/step; {ex_ms:.4f} ms per "
          f"exchange ({r} energies "
          f"{1e3 * bucket['potential_energy'] / REMD_CYCLES:.4f} ms + the "
          f"sweep {1e3 * bucket['exchange'] / REMD_CYCLES:.4f} ms)",
          flush=True)
    return dict(launches=launches, ms=md_ms, exchange_ms=ex_ms, wall=wall)


def h_remd_phase(fep_end, mask):
    """H-REMD-FEP: four replicas of FEP-water's end state on the
    HREMD_LAMS ladder of the inserted water, HREMD_CYCLES cycles of
    REMD_CYCLE steps; each exchange's self and cross energies on lists
    built for them. Gates: K1c launched exactly once per force evaluation
    plus twice with energy per replica per cycle, the exchanges against
    the host's float64 recomputation, the last cycle's self energies
    against float64, each replica's state."""
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.ops import pair_kernel as pk
    from mollytpu_torch.sim import remd as remd_mod
    label = "H-REMD-FEP"
    r = len(HREMD_LAMS)
    cls = recording(pt.HamiltonianReplicaExchangeMD)
    remd = cls(lambdas=list(HREMD_LAMS),
               simulator=pt.Langevin(dt=DT, temperature=TEMP,
                                     friction=FRICTION),
               cycle_length=REMD_CYCLE, atom_mask=mask)
    gen = torch.Generator(device=fep_end.device).manual_seed(SEED + 700)
    pk.reset_launch_counts()
    bucket = {}
    t0 = time.perf_counter()
    with timed_calls(bucket, (remd_mod, "run_segments"), (cls, "_energy"),
                     (cls, "exchange")):
        ens, info = remd.simulate(fep_end, HREMD_CYCLES, generator=gen)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_seg = r * HREMD_CYCLES
    launches = count_launches(label, FEP_FAMILY, n_seg * (1 + REMD_CYCLE),
                              2 * n_seg)
    (coords, e_self), n_acc = check_exchanges(
        label, remd, beta=1.0 / (pt.units.KB * TEMP))
    remd_f64(label, ens.template, coords, e_self, HREMD_LAMS, mask)
    for i in range(r):
        check_state(f"{label} replica {i}", ens.replica(i))
    hist = info["energies"].double().cpu().tolist()
    md_ms = 1e3 * bucket["run_segments"] / (n_seg * REMD_CYCLE)
    print(f"{label}: {r} replicas at lambda {list(HREMD_LAMS)}, "
          f"{HREMD_CYCLES} cycles of {REMD_CYCLE} steps in {wall:.2f} s; "
          f"exchange rate {info['exchange_rate']:.3f} ({n_acc} of "
          f"{HREMD_CYCLES * (r // 2)}); {md_ms:.4f} ms per replica-step; "
          f"{1e3 * bucket['exchange'] / HREMD_CYCLES:.4f} ms per exchange "
          f"({2 * r} list builds and energies "
          f"{1e3 * bucket['_energy'] / HREMD_CYCLES:.4f} ms); the "
          f"({HREMD_CYCLES}, {r}) self-energy history (kJ/mol): {hist!r}",
          flush=True)
    return dict(launches=launches, ms=md_ms, wall=wall,
                exchange_ms=1e3 * bucket["exchange"] / HREMD_CYCLES)


def mc_lj_phase(end):
    """MC-LJ: MetropolisMonteCarlo on LJ-bench's 32,000-atom end state at
    its kinetic temperature, random_normal_translation(MC_SHIFT), MC_MOVES
    moves on one neighbor table built at the start. Gates: acceptance in
    (0.05, 1], the running energy after the last move against a fresh
    potential_energy (TOL_MC_ENERGY relative), no pair-kernel launch, the
    table not stale at the end (MetropolisMonteCarlo raises)."""
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.ops import pair_kernel as pk
    from mollytpu_torch.sim.simulate import list_check, list_cutoff
    label = "MC-LJ"
    nb = pt.find_neighbors(end.neighbor_finder, end.coords, end.boundary,
                           end.exclusions)
    temp = float(pt.temperature(end.masses, end.velocities, end.n_dof))
    mc = pt.MetropolisMonteCarlo(
        temperature=temp, trial_move=pt.random_normal_translation(MC_SHIFT))
    gen = torch.Generator(device=end.device).manual_seed(SEED + 800)
    k1 = (pk.LAUNCHES, dict(pk.INSTANCE_LAUNCHES))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, info = mc.simulate(end, MC_MOVES, generator=gen, neighbors=nb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rate = float(info["acceptance_rate"])
    e_run = float(info["energies"][-1])
    e_new = float(pt.potential_energy(final, nb))
    rel = abs(e_run - e_new) / abs(e_new)
    closest, _ = list_check(final, nb, list_cutoff(final))
    line = (f"{label}: {MC_MOVES} moves on {end.n_atoms} atoms at "
            f"{temp:.3f} K (LJ-bench's end state), shift "
            f"{MC_SHIFT} nm, one table: acceptance {rate:.4f}; running "
            f"energy {e_run:.6f} against a fresh potential_energy "
            f"{e_new:.6f} kJ/mol (rel {rel:.3e}); closest pair missing "
            f"from the table inside the cutoff at the end {float(closest)}"
            f" nm (inf: none); {1e3 * wall / MC_MOVES:.4f} ms per move")
    print(line, flush=True)
    if not (0.05 < rate <= 1.0) or rel > TOL_MC_ENERGY:
        raise RuntimeError(line)
    if (pk.LAUNCHES, dict(pk.INSTANCE_LAUNCHES)) != k1:
        raise RuntimeError(f"{label}: the pair kernel was launched")
    return dict(ms=1e3 * wall / MC_MOVES, rate=rate)


def gradient_phase(start64, pme_end):
    """Gradients: dE_final/d(epsilon) through GRAD_STEPS velocity Verlet
    steps of simulate_differentiable on in.lj's float64 liquid (the
    neighbor-table engine, its list rebuilt on the cadence), with and
    without per-step checkpointing, against the central difference on
    the card (TOL_GRAD); the peak memory of each. Then a gradient asked
    for through the pair kernel (the PME end state's cluster-pair list)
    must raise NotImplementedError, with no launch."""
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.models import ljbench
    from mollytpu_torch.ops import pair_kernel as pk
    label = "Gradients"
    sim = ljbench.lj_bench_integrator()
    n = start64.n_atoms

    def loss(eps, remat=True):
        s = start64.update(atoms=dataclasses.replace(
            start64.atoms, epsilon=eps.expand(n)))
        final = pt.simulate_differentiable(s, sim, GRAD_STEPS, remat=remat)
        nb = pt.find_neighbors(final.neighbor_finder, final.coords.detach(),
                               final.boundary, final.exclusions)
        return pt.potential_energy(final, nb)

    eps0 = float(ljbench.EPSILON)
    grads, peaks, secs = {}, {}, {}
    for remat in (True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        eps = torch.tensor(eps0, dtype=torch.float64, device=start64.device,
                           requires_grad=True)
        (g,) = torch.autograd.grad(loss(eps, remat), eps)
        grads[remat] = float(g)
        torch.cuda.synchronize()
        secs[remat] = time.perf_counter() - t0
        peaks[remat] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    h = GRAD_H * eps0
    with torch.no_grad():
        fd = (float(loss(torch.tensor(eps0 + h, dtype=torch.float64,
                                      device=start64.device)))
              - float(loss(torch.tensor(eps0 - h, dtype=torch.float64,
                                        device=start64.device)))) / (2 * h)
    rel = abs(grads[True] - fd) / abs(fd)
    same = abs(grads[True] - grads[False]) / abs(grads[False])
    line = (f"{label}: in.lj's float64 liquid ({n} atoms), dE/d(epsilon) "
            f"after {GRAD_STEPS} velocity Verlet steps: "
            f"{grads[True]!r} with remat, {grads[False]!r} without (rel "
            f"{same:.3e}), central difference (h {h:g}) {fd!r}: rel "
            f"{rel:.3e} (tolerance {TOL_GRAD}); peak memory over the "
            f"forward and backward {peaks[True]:.3f} GiB with remat, "
            f"{peaks[False]:.3f} GiB without; {secs[True]:.2f} s and "
            f"{secs[False]:.2f} s")
    print(line, flush=True)
    if not (rel <= TOL_GRAD and same <= 1e-9):
        raise RuntimeError(line)
    nb = pt.find_neighbors(pme_end.neighbor_finder, pme_end.coords,
                           pme_end.boundary, pme_end.exclusions)
    x = pme_end.coords.clone().requires_grad_(True)
    k1 = pk.LAUNCHES
    try:
        pt.forces(pme_end.update(coords=x), nb)
    except NotImplementedError as err:
        print(f"{label}: a gradient through the pair kernel raised "
              f"NotImplementedError ({err}), no launch", flush=True)
    else:
        raise RuntimeError(f"{label}: a gradient through the pair kernel "
                           "did not raise")
    if pk.LAUNCHES != k1:
        raise RuntimeError(f"{label}: the refused call launched the kernel")
    return dict(peaks=peaks, rel=rel, secs=secs)


def calculator_phase(pme_end):
    """Calculators on the PME path's end state: Calculator's energy and
    forces against potential_energy and forces_virial on the same
    coordinates (one K1a energy launch, one forces launch); an
    ExternalCalculator wrapping a numpy harmonic tether (TETHER_K) on
    every oxygen joins the general interactions for CALC_STEPS Langevin
    steps, its forces and energy at the end against
    add_position_restraints' with the same k and references; NPT
    (C-rescale) with it and no fn_virial raises. Returns the phase's K1a
    launches and the ms/step the host round trip adds."""
    import numpy as np
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.ops import pair_kernel as pk
    label = "Calculators"
    nb = pt.find_neighbors(pme_end.neighbor_finder, pme_end.coords,
                           pme_end.boundary, pme_end.exclusions)
    with uncounted():
        e_ref = float(pt.potential_energy(pme_end, nb))
        f_ref = pt.forces_virial(pme_end, nb)[0]
    calc = pt.Calculator(pme_end)
    pk.reset_launch_counts()
    e = float(calc.energy(pme_end.coords))
    count_launches(f"{label} energy", "coul3-ortho", 0, 1)
    f = calc.forces(pme_end.coords)
    count_launches(f"{label} energy + forces", "coul3-ortho", 1, 1)
    de = abs(e - e_ref) / abs(e_ref)
    df = float((f - f_ref).abs().max() / f_ref.abs().max())
    line = (f"{label}: Calculator energy {e:.6f} against potential_energy "
            f"{e_ref:.6f} kJ/mol (rel {de:.3e}), forces max|dF|/max|F| "
            f"{df:.3e} (tolerance {TOL_CALC})")
    print(line, flush=True)
    if de > TOL_CALC or df > TOL_CALC:
        raise RuntimeError(line)

    oxy = np.nonzero(pme_end.atom_data.element == "O")[0]
    x0 = pme_end.coords.double().cpu().numpy()[oxy]

    def tether(c, box):
        d = x0 - c[oxy]
        d -= box * np.round(d / box)
        f = np.zeros_like(c)
        f[oxy] = TETHER_K * d
        return 0.5 * TETHER_K * float(np.sum(d * d)), f

    ext = pt.ExternalCalculator(fn=tether, n_atoms=pme_end.n_atoms)
    tethered = pme_end.update(general_inters=pme_end.general_inters
                              + (ext,))
    restrained = pt.add_position_restraints(pme_end, TETHER_K,
                                            atom_selector=oxy)
    sim = pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)
    ms = {"plain": [], "tethered": []}
    # in turns, plain, tethered, tethered, plain: the host's speed drifts
    for name in ("plain", "tethered", "tethered", "plain"):
        system = tethered if name == "tethered" else pme_end
        gen = torch.Generator(device=pme_end.device).manual_seed(SEED + 900)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run, _, _ = pt.simulate(system, sim, CALC_STEPS, generator=gen)
        torch.cuda.synchronize()
        ms[name].append(1e3 * (time.perf_counter() - t0) / CALC_STEPS)
        if name == "tethered":
            out = run
    ms = {k: statistics.mean(v) for k, v in ms.items()}
    launches = count_launches(f"{label} with the Langevin runs",
                              "coul3-ortho", 1 + 4 * (1 + CALC_STEPS), 1)
    check_state(f"{label} tethered", out)
    call_ms = statistics.median(
        _host_ms(lambda: ext.force_virial(out.coords, out.boundary,
                                          out.atoms)) for _ in range(10))
    f_ext, _ = ext.force_virial(out.coords, out.boundary, out.atoms)
    f_res, _ = pt.specific_forces(restrained.specific_lists[-1], out.coords,
                                  out.boundary)
    e_ext = float(ext.energy(out.coords, out.boundary, out.atoms))
    e_res = float(pt.specific_energy(restrained.specific_lists[-1],
                                     out.coords, out.boundary))
    dfr = float((f_ext - f_res).abs().max())
    der = abs(e_ext - e_res) / abs(e_res)
    line = (f"{label}: ExternalCalculator tether (k {TETHER_K:g} "
            f"kJ/mol/nm^2 on {len(oxy)} oxygens) after {CALC_STEPS} "
            f"Langevin steps: forces against add_position_restraints' "
            f"max|dF| {dfr:.3e} kJ/mol/nm (tolerance {TOL_TETHER_FORCE}; "
            f"max|F| {float(f_res.abs().max()):.4f}), energy {e_ext:.6f} "
            f"against {e_res:.6f} kJ/mol (rel {der:.3e}); one force_virial "
            f"call (the host round trip) {call_ms:.4f} ms (median of 10); "
            f"{ms['tethered']:.4f} ms/step against {ms['plain']:.4f} "
            f"without it (each the mean of two runs of {CALC_STEPS} steps, "
            "in turns): it adds "
            f"{ms['tethered'] - ms['plain']:.4f} ms/step")
    print(line, flush=True)
    if dfr > TOL_TETHER_FORCE or der > TOL_TETHER_ENERGY:
        raise RuntimeError(line)
    npt = pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION,
                      coupling=(pt.CRescaleBarostat(
                          NPT_BAR * pt.units.BAR, TEMP, CRESCALE_TAU,
                          n_steps=CRESCALE_EVERY),))
    with uncounted():
        try:
            pt.simulate(tethered, npt, CRESCALE_EVERY)
        except ValueError as err:
            print(f"{label}: NPT (C-rescale) with the tether and no "
                  f"fn_virial raised ValueError ({err})", flush=True)
        else:
            raise RuntimeError(f"{label}: NPT without fn_virial ran")
    return dict(launches=launches, add_ms=ms["tethered"] - ms["plain"],
                call_ms=call_ms)


def tile_system(system, radius, cadence):
    """``system`` on a CellTileFinder of list radius ``radius``."""
    import mollytpu_torch as pt
    return system.update(neighbor_finder=pt.CellTileFinder.setup(
        system.boundary, radius, system.n_atoms, n_steps=cadence))


def describe_tiles(label, finder, n):
    """Print the grid; returns the pair slots of one evaluation."""
    import numpy as np
    cells = int(np.prod(finder.grid_dims))
    s = finder.stencil.shape[1]
    cap = finder.cell_capacity
    slots = cells * cap * s * cap
    print(f"{label}: {n} atoms, CellTileFinder radius {finder.dist_cutoff} "
          f"nm, grid {finder.grid_dims} ({cells} cells), capacity {cap}, "
          f"stencil {s} cells: {slots:,} pair slots per evaluation",
          flush=True)
    return slots


def tile_terms(system, tiles):
    """The tile engine's pair forces, energy and virial of ``system``'s
    listed interactions."""
    from mollytpu_torch.ops import celltiles
    nl = tuple(i for i in system.pairwise_inters
               if getattr(i, "use_neighbors", False))
    args = (nl, system.atoms, system.coords, system.boundary, tiles,
            system.neighbor_finder, system.exclusions)
    f, v = celltiles.tile_forces(*args, needs_virial=True)
    return f, celltiles.tile_energy(*args), v


def celltiles_pme_phase(system, line):
    """CellTiles-PME: the PME cube's start frame on the cell-tile engine.
    Gates: no overflow; the tile pair terms against K1a's on the frame
    (TOL_TILE_K1A; K1a launched uncounted, as a comparator) and against
    the float64 tile engine (TOL_F64 off the cutoff); TILE_WARMUP +
    TILE_STEPS Langevin steps with no stale table and no overflow
    (run_chunk raises), no pair-kernel launch, the state; one rebuild
    interval under set_sync_debug_mode("error"). Reports ms per tile
    evaluation, ms/step and the peak device memory of an evaluation and
    of the run."""
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.ops import pair_kernel as pk
    label = "CellTiles-PME"
    ts = tile_system(system, LIST_RADIUS, CADENCE)
    slots = describe_tiles(label, ts.neighbor_finder, ts.n_atoms)
    tiles = ts.neighbor_finder.find(ts.coords, ts.boundary, ts.exclusions)
    if int(tiles.overflow):
        raise RuntimeError(f"{label}: {int(tiles.overflow)} atoms found "
                           "their cell full")
    spec = pk.build_fused_spec(system.pairwise_inters)
    nb = system.neighbor_finder.find(system.coords, system.boundary,
                                     system.exclusions)
    with uncounted():
        f_k, e_k, v_k = pk.block_nonbonded(
            spec, system.coords, system.boundary, system.atoms,
            system.exclusions, nb, compute_energy=True)
        k1_ms = _time(lambda: pk.block_nonbonded(
            spec, system.coords, system.boundary, system.atoms,
            system.exclusions, nb))
        again = pk.block_nonbonded(spec, system.coords, system.boundary,
                                   system.atoms, system.exclusions, nb)[0]
    # K1's float atomics add in no fixed order, so the Mesh phase, which
    # compares two runs bit for bit, runs on the tile engine
    print(f"{label}: K1a's forces on the frame twice: bit for bit "
          f"{torch.equal(again, f_k)}, max|dF| "
          f"{float((again - f_k).abs().max()):.3e} kJ/mol/nm", flush=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    f_t, e_t, v_t = tile_terms(ts, tiles)
    torch.cuda.synchronize()
    eval_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    rms = float(f_k.double().pow(2).sum(dim=1).mean().sqrt())
    ratio = float((f_t - f_k).abs().max()) / rms
    de = abs(float(e_t) - float(e_k)) / abs(float(e_k))
    dv = float((v_t - v_k).abs().max()) / float(v_k.abs().max())
    print(f"{label}: tile pair terms against K1a on the start frame: "
          f"max|dF|/rms|F| {ratio:.3e} (rms|F| {rms:.3f} kJ/mol/nm), rel dE "
          f"{de:.3e} (E {float(e_k):.6e} kJ/mol), rel dvir {dv:.3e} "
          f"(tolerance {TOL_TILE_K1A})", flush=True)
    if max(ratio, de, dv) > TOL_TILE_K1A:
        raise RuntimeError(f"{label}: the tile engine disagrees with K1a")
    s64 = ts.update(atoms=ts.atoms.to(dtype=torch.float64),
                    coords=ts.coords.double(),
                    boundary=ts.boundary.to(dtype=torch.float64))
    f64, e64, v64 = tile_terms(s64, tiles)
    nbk, _, _ = pk.kernel_inputs(spec, system.coords, system.atoms, nb)
    near = near_cutoff_atoms(spec, nbk, system.boundary, system.n_atoms)
    rms64 = float(f64.pow(2).sum(dim=1).mean().sqrt())
    err = (f_t.double() - f64).abs().amax(dim=1) / rms64
    df64 = float(err[~near].max())
    de64 = abs(float(e_t) - float(e64)) / abs(float(e64))
    dv64 = float((v_t.double() - v64).abs().max()) / float(v64.abs().max())
    print(f"{label}: f32 tiles against float64 tiles: max|dF|/rms|F| "
          f"{df64:.3e} over the {int((~near).sum())} atoms with no pair "
          f"within {NEAR_CUT} nm of the cutoff, rel dE {de64:.3e}, rel dvir "
          f"{dv64:.3e} (tolerance {TOL_F64})", flush=True)
    if max(df64, de64, dv64) > TOL_F64:
        raise RuntimeError(f"{label}: f32 tiles disagree with float64")
    nl = tuple(i for i in ts.pairwise_inters if i.use_neighbors)
    from mollytpu_torch.ops import celltiles
    args = (nl, ts.atoms, ts.coords, ts.boundary, tiles, ts.neighbor_finder,
            ts.exclusions)
    f_ms = _time(lambda: celltiles.tile_forces(*args), 1, 5)
    e_ms = _time(lambda: celltiles.tile_energy(*args), 1, 5)
    find_ms = _time(lambda: ts.neighbor_finder.find(
        ts.coords, ts.boundary, ts.exclusions), 2, 10)
    print(f"{label}: tile_forces {f_ms:.4f} ms, tile_energy {e_ms:.4f} ms, "
          f"find {find_ms:.4f} ms (CUDA events, median of 5 / 5 / 10) "
          f"over {slots:,} slots; K1a forces through its wrapper "
          f"{k1_ms:.4f} ms on the block list; peak memory of an "
          f"evaluation with the virial {eval_gib:.3f} GiB", flush=True)

    dev = ts.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ts = ts.update(velocities=pt.random_velocities(ts.masses, TEMP, gen))
    sim = pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)
    pk.reset_launch_counts()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    nbt = pt.find_neighbors(ts.neighbor_finder, ts.coords, ts.boundary,
                            ts.exclusions)
    aux = sim.init_aux(ts, nbt)
    ts, nbt, aux, _ = pt.run_chunk(sim, ts, nbt, aux, 0, TILE_WARMUP,
                                   generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, nbt, aux, closest = pt.run_chunk(sim, ts, nbt, aux, TILE_WARMUP,
                                         TILE_STEPS, generator=gen)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / TILE_STEPS
    run_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    if pk.LAUNCHES:
        raise RuntimeError(f"{label}: the pair kernel was launched "
                           f"{pk.LAUNCHES} times")
    temp, viol = check_state(label, ts)
    step = TILE_WARMUP + TILE_STEPS
    print(f"card: {line}; {label}: {step} Langevin steps, rebuild every "
          f"{CADENCE}: {ms:.4f} ms/step over the last {TILE_STEPS} "
          f"({pt.units.ps_per_step_to_ns_per_day(DT, ms * 1e-3):.4f} "
          f"ns/day); 0 pair-kernel launches; no overflow; closest pair "
          f"outside the old tiles' stencil at the rebuilds {closest:.4f} nm "
          f"(none inside the cutoff); T {temp:.2f} K, max constraint "
          f"violation {viol:.3e} nm; peak device memory of the run "
          f"{run_gib:.3f} GiB", flush=True)
    run = {"sim": sim, "system": ts, "nb": nbt, "aux": aux, "gen": gen}
    end = steps_without_sync(label, run, step, CADENCE)
    return dict(ms=ms, f_ms=f_ms, eval_gib=eval_gib, run_gib=run_gib,
                slots=slots, system=end["system"], ratio=ratio)


def celltiles_lj_phase(dev, line, cadence):
    """CellTiles-LJ: in.lj's 32,000 atoms on the cell-tile engine at
    LJ-bench's rebuild cadence. Gates: the lattice's pair energy per atom
    (TOL_LJ_E0_F32); TILE_LJ_STEPS NVE steps with no stale table and no
    overflow, beside as many on the cell list from the same state, the
    tiles' drift at most twice the cell list's plus LJ_DRIFT_SLACK; the
    tile forces and energy against the cell-list engine's on the tile
    run's end frame (TOL_ENGINES); finite coordinates and T < 1000 K; no
    pair-kernel launch."""
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.models import ljbench
    from mollytpu_torch.ops import pair_kernel as pk
    label = "CellTiles-LJ"
    cells = ljbench.lj_bench_system(LJ_CELLS, torch.float32, dev, SEED)
    cells = cells.update(neighbor_finder=dataclasses.replace(
        cells.neighbor_finder, n_steps=cadence))
    tiled = tile_system(cells, ljbench.CUTOFF + ljbench.SKIN, cadence)
    n = tiled.n_atoms
    slots = describe_tiles(label, tiled.neighbor_finder, n)
    k1 = (pk.LAUNCHES, dict(pk.INSTANCE_LAUNCHES))
    tiles = tiled.neighbor_finder.find(tiled.coords, tiled.boundary,
                                       tiled.exclusions)
    e0 = float(pt.potential_energy(tiled, tiles)) / n / ljbench.EPSILON
    ref = lattice_energy()
    print(f"{label}: step-0 E_pair/N {e0:.9f} epsilon (f32) against the "
          f"numpy lattice sum {ref:.12f}: relative {abs(e0 / ref - 1):.3e} "
          f"(tolerance {TOL_LJ_E0_F32})", flush=True)
    if abs(e0 / ref - 1.0) > TOL_LJ_E0_F32:
        raise RuntimeError(f"{label}: the step-0 lattice energy is off")

    def nve(system):
        sim = ljbench.lj_bench_integrator()
        nb = pt.find_neighbors(system.neighbor_finder, system.coords,
                               system.boundary, system.exclusions)
        aux = sim.init_aux(system, nb)
        samples, elapsed = [total_energy(system, nb)], 0.0
        for step in range(0, TILE_LJ_STEPS, LJ_SAMPLE):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            system, nb, aux, _ = pt.run_chunk(sim, system, nb, aux, step,
                                              LJ_SAMPLE)
            torch.cuda.synchronize()
            elapsed += time.perf_counter() - t0
            samples.append(total_energy(system, nb))
        e = [float(a) + float(b) for a, b in samples]
        drift = max(abs(x - e[0]) for x in e) / n / ljbench.EPSILON
        return system, nb, 1e3 * elapsed / TILE_LJ_STEPS, drift

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    end, nb_t, ms, drift = nve(tiled)
    run_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    _, _, ms_cell, drift_cell = nve(cells)
    if (pk.LAUNCHES, dict(pk.INSTANCE_LAUNCHES)) != k1:
        raise RuntimeError(f"{label}: the pair kernel was launched")
    temp = float(pt.temperature(end.masses, end.velocities, end.n_dof))
    if not bool(torch.isfinite(end.coords).all()) or not temp < 1000.0:
        raise RuntimeError(f"{label}: the state after the run is bad")
    on_cells = end.update(neighbor_finder=cells.neighbor_finder)
    nb_c = pt.find_neighbors(on_cells.neighbor_finder, on_cells.coords,
                             on_cells.boundary, on_cells.exclusions)
    f_c, f_t = pt.forces(on_cells, nb_c), pt.forces(end, nb_t)
    e_c = float(pt.potential_energy(on_cells, nb_c))
    e_t = float(pt.potential_energy(end, nb_t))
    rms = float(f_c.double().pow(2).sum(dim=1).mean().sqrt())
    ratio = float((f_t - f_c).abs().max()) / rms
    de = abs(e_t - e_c) / abs(e_c)
    per_s = 1e3 / ms
    print(f"card: {line}; {label}: {TILE_LJ_STEPS} NVE steps from the "
          f"lattice, rebuild every {cadence}: {ms:.4f} ms/step, "
          f"{per_s:.2f} timesteps/s, {n * per_s / 1e3:.1f} katom-step/s "
          f"(the cell list's neighbor engine {ms_cell:.4f} ms/step in the "
          f"same call); NVE drift max|E(t) - E(0)|/N {drift:.3e} epsilon "
          f"beside the cell list's {drift_cell:.3e} (gate: <= 2x + "
          f"{LJ_DRIFT_SLACK}); T {temp:.3f} K at the end; tile forces "
          f"against the cell-list engine's on the end frame: max|dF|/"
          f"rms|F| {ratio:.3e}, rel dE {de:.3e} (tolerance {TOL_ENGINES}); "
          f"peak device memory of the run {run_gib:.3f} GiB; no pair-kernel "
          "launch", flush=True)
    if drift > 2.0 * drift_cell + LJ_DRIFT_SLACK:
        raise RuntimeError(f"{label}: drift beyond twice the cell list's")
    if ratio > TOL_ENGINES or de > TOL_ENGINES:
        raise RuntimeError(f"{label}: tiles disagree with the cell list")
    return dict(ms=ms, ms_cell=ms_cell, run_gib=run_gib, slots=slots,
                per_s=per_s)


def mesh_phase(start):
    """Mesh: one T-REMD cycle (REMD_TEMPS, MESH_CYCLE steps) from the
    CellTiles-PME end state through mesh=replica_mesh() and through
    mesh=None from generators seeded alike, under
    torch.use_deterministic_algorithms; gate: coordinates, velocities,
    energies and the exchange rate bit for bit."""
    import torch
    import mollytpu_torch as pt
    label = "Mesh"
    mesh = pt.replica_mesh()
    remd = pt.ReplicaExchangeMD(
        temperatures=list(REMD_TEMPS),
        simulator=pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION),
        cycle_length=MESH_CYCLE)
    out, secs = [], []
    torch.use_deterministic_algorithms(True)
    try:
        for m in (mesh, None):
            gen = torch.Generator(device=start.device).manual_seed(SEED + 700)
            t0 = time.perf_counter()
            out.append(remd.simulate(start, 1, generator=gen, mesh=m))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    finally:
        torch.use_deterministic_algorithms(False)
    (ens, info), (ens0, info0) = out
    same = (torch.equal(ens.coords, ens0.coords)
            and torch.equal(ens.velocities, ens0.velocities)
            and torch.equal(info["pes"], info0["pes"])
            and info["exchange_rate"] == info0["exchange_rate"])
    print(f"{label}: replica_mesh() holds {len(mesh.devices)} device(s) "
          f"{[str(d) for d in mesh.devices]} of torch.cuda.device_count() "
          f"{torch.cuda.device_count()}; one T-REMD cycle of {MESH_CYCLE} "
          f"steps, {len(REMD_TEMPS)} replicas on the tile engine: "
          f"{secs[0]:.2f} s through the mesh, {secs[1]:.2f} s with "
          f"mesh=None; energies {[float(e) for e in info['pes'][0]]!r}; "
          f"exchange rate {info['exchange_rate']}; bit for bit: {same}",
          flush=True)
    if not same:
        raise RuntimeError(f"{label}: the mesh run differs from mesh=None")
    return dict(devices=len(mesh.devices), secs=secs)


def tuner_phase(system):
    """Tuner: tune_launch on the PME end state (K1a; the anchor TUNE_SKIN
    at the main paths' cadence, then TUNE_SKINS), each candidate's ms/step
    printed; then its cache read back from disk in a fresh process state
    (the in-process cache cleared; a second timing would raise)."""
    import torch
    from mollytpu_torch.ops import autotune
    from mollytpu_torch.ops import pair_kernel as pk
    label = "Tuner"
    saved = os.environ.get("MOLLYTPU_CACHE_DIR")
    with tempfile.TemporaryDirectory() as cache:
        os.environ["MOLLYTPU_CACHE_DIR"] = cache
        try:
            autotune._MEM_CACHE.clear()
            pk.reset_launch_counts()
            t0 = time.perf_counter()
            args = (system.boundary, 1.0, system.n_atoms, system.coords)
            kw = dict(atoms=system.atoms, exclusions=system.exclusions,
                      inters=system.pairwise_inters, cadence=CADENCE,
                      skin=TUNE_SKIN, skins=TUNE_SKINS)
            cfg = autotune.tune_launch(*args, verbose=True, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = pk.LAUNCHES
            autotune._MEM_CACHE.clear()

            def timed_again(skin, cadence):
                raise RuntimeError(f"{label}: a cached choice was timed "
                                   "again")

            again = autotune.tune_launch(*args, score=timed_again, **kw)
            stored = os.path.exists(os.path.join(cache,
                                                 "autotune_torch.json"))
        finally:
            if saved is None:
                os.environ.pop("MOLLYTPU_CACHE_DIR", None)
            else:
                os.environ["MOLLYTPU_CACHE_DIR"] = saved
            autotune._MEM_CACHE.clear()
    print(f"{label}: chose skin {cfg['skin']} nm, a rebuild every "
          f"{cfg['cadence']} steps, {cfg['ms_per_step']:.4f} ms/step "
          f"(block {cfg['block']}, lanes {cfg['lanes']}); {wall:.2f} s, "
          f"{launches} pair-kernel launches; read back from the disk cache "
          f"{'unchanged' if again == cfg and stored else 'CHANGED'}",
          flush=True)
    if again != cfg or not stored:
        raise RuntimeError(f"{label}: the cache round trip changed it")
    return dict(cfg=cfg, wall=wall, launches=launches)


def triangle_buckets(system):
    """The TRIANGLE buckets of ``system``'s constraint solvers: the
    rigid-triangle kernel's launches per constraint call on the card."""
    from mollytpu_torch.ops import constraints
    return sum(b.pattern == constraints.TRIANGLE
               for c in system.constraints for b in getattr(c, "clusters", ()))


@contextlib.contextmanager
def triangle_solves(label):
    """Over the block, with constraints.TRIANGLE_LAUNCHES set to 0 first,
    counts SHAKE / RATTLE calls on card tensors by solvers with a TRIANGLE
    bucket, and the launches each should make (``shake``, ``rattle``: one
    per bucket). Gates after it: the kernel launched that often, and there
    was a call. Yields the counts (``launches`` is filled in at the
    end)."""
    from mollytpu_torch.ops import constraints
    cls = constraints.SHAKERattle
    names = ("apply_position_constraints", "apply_velocity_constraints")
    real = {name: getattr(cls, name) for name in names}
    counts = {"calls": 0, "shake": 0, "rattle": 0}

    def counting(name, kind):
        def call(self, coords, *args, **kw):
            n = sum(b.pattern == constraints.TRIANGLE for b in self.clusters)
            if coords.is_cuda and n and self.n_constraints:
                counts["calls"] += 1
                counts[kind] += n
            return real[name](self, coords, *args, **kw)
        return call

    constraints.TRIANGLE_LAUNCHES = 0
    for name, kind in zip(names, ("shake", "rattle")):
        setattr(cls, name, counting(name, kind))
    try:
        yield counts
    finally:
        for name in names:
            setattr(cls, name, real[name])
    counts["launches"] = constraints.TRIANGLE_LAUNCHES
    print(f"{label}: rigid-triangle kernel launches over the phase "
          f"{counts['launches']} for {counts['calls']} SHAKE / RATTLE calls "
          f"on the card ({counts['shake']} SHAKE, {counts['rattle']} "
          "RATTLE)", flush=True)
    if (counts["launches"] != counts["shake"] + counts["rattle"]
            or not counts["calls"]):
        raise RuntimeError(f"{label}: a SHAKE / RATTLE call on the card did "
                           "not launch the rigid-triangle kernel once per "
                           "TRIANGLE bucket")


def _ulp32(x):
    """The float32 unit in the last place of the largest |x|."""
    import numpy as np
    return float(np.spacing(np.float32(float(x.abs().max()))))


def triangle_kernel_check(label, system, dtype):
    """The rigid-triangle kernel on ``system``'s frame (cast to ``dtype``)
    against its twin on the same card tensors: SHAKE from the frame to the
    frame moved by up to TRI_MOVE nm, RATTLE of standard-normal velocities
    at the moved frame; one launch each (gated), the largest differences
    within TRI_ULPS_X / TRI_ULPS_V float32 ulps (gated where dtype is
    float32; float64 prints them). Times: each kernel's device ms
    (torch.profiler over 25 calls), the whole call's (CUDA events around
    25 back-to-back calls), the twin's (median of 25), and the bound of
    the bytes each kernel moves: per triangle, SHAKE reads 18 coordinates,
    3 distances, 3 masses and 3 int64 atom ids and writes 9 coordinates;
    RATTLE reads 9 coordinates, 9 velocities, 3 masses and the ids and
    writes 9 velocities."""
    import torch
    from mollytpu_torch.ops import constraints
    (c,) = system.constraints
    box, dev = system.boundary, system.coords.device
    x = system.coords.to(dtype)
    m = system.masses.to(dtype)
    g = torch.Generator(device=dev).manual_seed(SEED)
    moved = x + TRI_MOVE * (2 * torch.rand(x.shape, generator=g, dtype=dtype,
                                           device=dev) - 1)
    vels = torch.randn(x.shape, generator=g, dtype=dtype, device=dev)

    def shake():
        return c.apply_position_constraints(x, moved, vels, m, box, DT)

    def rattle():
        return c.apply_velocity_constraints(moved, vels, m, box)

    def twin(fn):
        real = constraints._on_kernel
        constraints._on_kernel = lambda *a: False
        try:
            return fn()
        finally:
            constraints._on_kernel = real

    before = constraints.TRIANGLE_LAUNCHES
    (xs, vs), v_r = shake(), rattle()
    launches = constraints.TRIANGLE_LAUNCHES - before
    (xs_t, vs_t), v_r_t = twin(shake), twin(rattle)
    ulp_x, ulp_v = _ulp32(moved), _ulp32(vels)
    err = {"SHAKE x": float((xs - xs_t).abs().max()),
           "SHAKE v": float((vs - vs_t).abs().max()),
           "RATTLE v": float((v_r - v_r_t).abs().max())}
    ulps = {"SHAKE x": err["SHAKE x"] / ulp_x,
            "SHAKE v": err["SHAKE v"] * DT / ulp_x,
            "RATTLE v": err["RATTLE v"] / ulp_v}
    viol = float(c.max_violation(xs, box))
    n_tri = int(c.clusters[0].atoms.shape[0])
    size, ids = torch.finfo(dtype).bits // 8, 24
    bytes_ = {"shake": n_tri * ((18 + 3 + 3 + 9) * size + ids),
              "rattle": n_tri * ((9 + 9 + 3 + 9) * size + ids)}
    out = {}
    for name, fn in (("shake", shake), ("rattle", rattle)):
        kernel_ms, calls = profiled(fn, 25,
                                    kernel=f"triangle_{name}_kernel")
        out[name] = dict(ms=kernel_ms, call_ms=burst_ms(fn), calls=calls,
                         plain_ms=_time(lambda: twin(fn)),
                         bound_ms=1e3 * bytes_[name] / HBM_BYTES_PER_S,
                         bound_by="bytes")
        if not kernel_ms > 0.0:
            raise RuntimeError(f"{label}: the profiler saw no "
                               f"triangle_{name}_kernel")
    print(f"{label}: rigid-triangle kernel against its twin on the same card "
          f"tensors, {n_tri:,} triangles, {str(dtype)[6:]}: " + ", ".join(
              f"{k} max|diff| {e:.3e} ({ulps[k]:.2f} f32 ulps)"
              for k, e in err.items())
          + f"; {launches} launches for one SHAKE and one RATTLE; max "
          f"violation after SHAKE {viol:.3e}; " + "; ".join(
              f"triangle_{k}_kernel {r['ms']:.4f} ms, the whole call "
              f"{r['call_ms']:.4f} ms ({r['calls']:g} device calls), the twin "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({bytes_[k] / 1e6:.1f} MB over 3.35 TB/s)"
              for k, r in out.items()), flush=True)
    if launches != 2:
        raise RuntimeError(f"{label}: {launches} rigid-triangle kernel "
                           "launches for one SHAKE and one RATTLE")
    if dtype == torch.float32 and (
            max(ulps["SHAKE x"], ulps["SHAKE v"]) > TRI_ULPS_X
            or ulps["RATTLE v"] > TRI_ULPS_V):
        raise RuntimeError(f"{label}: the rigid-triangle kernel differs "
                           f"from its twin by {ulps} float32 ulps")
    out["shake"]["max_abs_err"] = err["SHAKE x"]
    out["rattle"]["max_abs_err"] = err["RATTLE v"]
    return out


def cluster_list_check(label, system, move):
    """The cluster-pair list's search over a grid of cluster centers
    against measuring every cluster pair (GRID_ROWS rows at a time) on
    ``system``'s frame: the same pairs, in the same order (gated); with
    ``move``, the stale-list check after every atom moved by GRID_MOVE nm x
    a standard normal against the closest unlisted atom pair found atom by
    atom over every unlisted cluster pair whose boxes come within the
    cutoff (gated equal, or both at least the cutoff)."""
    import torch
    import mollytpu_torch as pt
    from mollytpu_torch.ops import blockpairs
    from mollytpu_torch.sim import simulate
    box, f = system.boundary, system.neighbor_finder
    radius, cutoff = f.dist_cutoff, simulate.list_cutoff(system)
    t0 = time.perf_counter()
    nb = pt.find_neighbors(f, system.coords, box, system.exclusions, 0)
    torch.cuda.synchronize()
    find_s = time.perf_counter() - t0
    cl = blockpairs.CLUSTER
    x = box.wrap(system.coords)[nb.src].view(-1, cl, 3)
    centers, exts = blockpairs._cluster_boxes(x, box)
    dims, _ = blockpairs._cluster_grid(centers, exts, box, radius)
    c = centers.shape[0]
    cj_all = torch.arange(c, device=x.device)
    every, unlisted = [], []
    for r0 in range(0, c, GRID_ROWS):
        ci = torch.arange(r0, min(c, r0 + GRID_ROWS), device=x.device)
        ii, jj = ci[:, None].expand(-1, c), cj_all[None, :].expand(
            ci.shape[0], -1)
        upper = jj >= ii
        gap = blockpairs._pair_gaps(centers, exts, box, ii, jj)
        near = (gap < radius) & upper
        every.append(torch.stack([ii[near], jj[near]], dim=1))
        if move:
            unlisted.append(torch.stack([ii[upper & ~near],
                                         jj[upper & ~near]], dim=1))
    every = torch.cat(every).to(torch.int32)
    same = every.shape == nb.pairs.shape and torch.equal(every, nb.pairs)
    line = (f"{label}: the cluster-pair list's grid search (grid {dims}, "
            f"{c:,} clusters, radius {radius} nm) against every cluster "
            f"pair: {nb.pairs.shape[0]:,} pairs listed, "
            f"{every.shape[0]:,} by every pair, "
            f"{'the same' if same else 'DIFFERENT'}; the find "
            f"{find_s:.3f} s")
    closest = brute = None
    if move:
        g = torch.Generator(device=x.device).manual_seed(SEED)
        moved = system.coords + GRID_MOVE * torch.randn(
            system.coords.shape, generator=g, dtype=system.coords.dtype,
            device=x.device)
        closest = float(blockpairs.unlisted_min_distance(nb, moved, box,
                                                         cutoff))
        cont = nb.coords_built + box.displacement(nb.coords_built, moved)
        xm = cont[nb.src].view(-1, cl, 3)
        c_now, e_now = blockpairs._cluster_boxes(xm, box)
        un = torch.cat(unlisted)
        un = un[blockpairs._pair_gaps(c_now, e_now, box, un[:, 0],
                                      un[:, 1]) < cutoff]
        ids = nb.ids.view(-1, cl)
        brute = math.inf
        for r0 in range(0, un.shape[0], GRID_ROWS):
            ui, uj = un[r0:r0 + GRID_ROWS].unbind(dim=1)
            dd = torch.linalg.vector_norm(pt.boundary.mic_displacement(
                box, xm[ui][:, :, None, :], xm[uj][:, None, :, :]), dim=-1)
            real = (ids[ui] < system.n_atoms)[:, :, None] & \
                (ids[uj] < system.n_atoms)[:, None, :]
            brute = min(brute, float(torch.where(real, dd, math.inf).amin()))
        line += (f"; after moves of {GRID_MOVE} nm x N(0, 1) the stale check "
                 f"reads {closest:.6f} nm, every unlisted atom pair "
                 f"{brute:.6f} nm (cutoff {cutoff} nm, {un.shape[0]:,} "
                 "unlisted cluster pairs within it)")
    print(line, flush=True)
    if not same:
        raise RuntimeError(f"{label}: the grid search lists other cluster "
                           "pairs than measuring every pair")
    if move and not (closest == brute if brute < cutoff
                     else closest >= cutoff):
        raise RuntimeError(f"{label}: the stale-list check reads {closest} "
                           f"nm, every unlisted atom pair {brute} nm")


def gmx_water_box(dev, workdir):
    """GROMACS's water benchmark as benchmark/systems/gmx_water.py builds
    it, without velocities: 512,000 SPC waters from the committed tile."""
    import torch
    from mollytpu_torch.models import gromacs, waterbox
    gro = waterbox.tile_gro(gromacs.read_gro(waterbox.SPC_TILE), GMX_TILES)
    top = waterbox.spc_topology(os.path.join(workdir, "spc-big.top"),
                                len(gro[0]) // 3)
    return gromacs.system_from_gromacs(
        gro, top, nonbonded_method="pme", dist_cutoff=GMX_RC,
        dist_neighbors=GMX_RLIST, device=dev, dtype=torch.float32,
        use_settles=True, dispersion_correction=False,
        velocities_from_gro=False, neighbor_finder="block",
        ewald_rtol=GMX_RTOL, fourier_spacing=GMX_SPACING,
        pme_order=GMX_ORDER)


def triangle_kernel_phase(dev, workdir):
    """Triangle-kernel: triangle_kernel_check and cluster_list_check on
    the PME cube's and the PME dodecahedron's start frames (N_WATERS TIP3P
    waters, f32; the dodecahedron triclinic) and on GROMACS's water
    benchmark (512,000 SPC waters, f32 and f64; the list without moves).
    Returns {frame: {"shake": ..., "rattle": ...}} for the kernels line."""
    import torch
    out = {}
    for tag, angles in (("cube", CUBE), ("dodecahedron", DODECAHEDRON)):
        system = water_system(dev, torch.float32, workdir, "pme", angles)
        frame = f"the PME {tag}'s start frame, {N_WATERS:,} TIP3P waters"
        out[f"{frame}, f32"] = triangle_kernel_check(
            f"Triangle-kernel ({frame})", system, torch.float32)
        cluster_list_check(f"Triangle-kernel ({frame})", system, move=True)
        del system
    t0 = time.perf_counter()
    big = gmx_water_box(dev, workdir)
    torch.cuda.synchronize()
    frame = (f"GROMACS's water benchmark, {big.n_atoms // 3:,} SPC waters "
             "from the tile")
    print(f"Triangle-kernel: {frame} built in {time.perf_counter() - t0:.1f} "
          "s", flush=True)
    for dtype in (torch.float32, torch.float64):
        out[f"{frame}, {str(dtype)[6:].replace('float', 'f')}"] = \
            triangle_kernel_check(f"Triangle-kernel ({frame})", big, dtype)
    cluster_list_check(f"Triangle-kernel ({frame})", big, move=False)
    del big
    torch.cuda.empty_cache()
    return out


def main():
    t_start = time.perf_counter()
    # the Mesh phase runs under torch.use_deterministic_algorithms, which
    # needs cuBLAS's fixed workspace set before the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    line = require_cuda()
    import torch
    import mollytpu_torch as pt
    build_kernels()
    dev = torch.device(DEVICE)
    small_modes(dev)
    small_alch_modes(dev)
    stats, runs, probes, pme_eval, more, finds = {}, {}, [], {}, {}, {}
    triangles = {}
    with tempfile.TemporaryDirectory() as workdir:
        for label, method, angles, n_chunks, family in MAIN_PATHS:
            with triangle_solves(label) as triangles[label]:
                t0 = time.perf_counter()
                system = water_system(dev, torch.float32, workdir, method,
                                      angles)
                torch.cuda.synchronize()
                print(f"{label}: {describe(system)}; setup "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
                stats[family] = compare(f"{label} water{system.n_atoms}",
                                        system, timing=True)
                if stats[family]["family"] != family:
                    raise RuntimeError(f"{label} runs instance "
                                       f"{stats[family]['family']}")
                if label == "PME":
                    probes += probe_phase(label, system, stats[family])
                if label == "RF-ortho":
                    other_modes(label, system, OTHER_MODES)
                runs[label] = main_path(label, system, n_chunks, family)
                if label == "PME":
                    pme_eval["cube"] = pme_evaluation_times(
                        label, runs[label]["system"])
                    npt, npt_energy = npt_phase(system, runs[label], line)
                    bonded = bonded_phase(runs[label]["system"])
                    runs["MTS-PME"] = mts_path(runs[label], line)
                    t_remd = t_remd_phase(runs[label]["system"],
                                          runs[label]["ms"])
                    calc = calculator_phase(runs[label]["system"])
                    tiles_pme = celltiles_pme_phase(system, line)
                    mesh = mesh_phase(tiles_pme.pop("system"))
                    tuner = tuner_phase(runs[label]["system"])
                if label == "RF-ortho":
                    components(label, runs[label])
                if label == "PME-dodecahedron":
                    run = runs[label]
                    steps_without_sync(label, run, run["step"], CADENCE)
                    pme_eval["dodecahedron"] = pme_evaluation_times(
                        label, run["system"])
                    components(label, run)
                    production = production_phase(run, workdir)
                    more[label] = (production["launches"]
                                   + integrators_phase(run))
                    muller_brown_phase(dev)
                if label == "PME":
                    pme_system, pme_end = system, runs[label]["system"]
                runs[label] = {k: runs[label][k]
                               for k in ("launches", "ms", "ns_day")}
                del system
        runs["Bonded-PME"] = bonded_pme_path(dev, workdir)
        more["PME"] = (runs["Bonded-PME"]["launches"]
                       + runs["MTS-PME"]["launches"])
        with triangle_solves("TIP4P-Ew-PME") as triangles["TIP4P-Ew-PME"]:
            tip4p = tip4p_path(dev, workdir, line, runs["PME"])
        lincs = lincs_pme_path(dev, workdir, line)
        for label, r in (("TIP4P-Ew-PME", tip4p), ("LINCS-PME", lincs)):
            runs[label] = {k: r[k] for k in ("launches", "ms", "ns_day")}
        with cell_finds("GROMACS-PME") as finds["GROMACS-PME"], \
                triangle_solves("GROMACS-PME") as triangles["GROMACS-PME"]:
            gmx = gromacs_path(dev, workdir, line)
        setup_options_phase(dev, workdir)

        with triangle_solves("FEP-water and the free-energy phases") as \
                triangles["FEP-water"]:
            t0 = time.perf_counter()
            fep, mask = fep_system(pme_system)
            print(f"FEP-water: {describe(fep)}; setup "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            lambda1_check(pme_system, fep, mask)
            fep_timed = pt.set_lambda(fep, FEP_TIMED, atom_mask=mask)
            stats[FEP_FAMILY] = compare(
                f"FEP-water lambda={FEP_TIMED} water{fep.n_atoms}", fep_timed,
                timing=True)
            if stats[FEP_FAMILY]["family"] != FEP_FAMILY:
                raise RuntimeError(f"FEP-water runs instance "
                                   f"{stats[FEP_FAMILY]['family']}")
            probes += probe_phase(f"FEP-water lambda={FEP_TIMED}", fep_timed,
                                  stats[FEP_FAMILY])
            timed, ham, energies = fep_path(fep, mask)
            fep_mbar(energies)
            components(f"FEP-water lambda={FEP_TIMED}", timed, ham, FEP_LAMS)
            runs["FEP-water"] = {k: timed[k] for k in ("launches", "ms",
                                                       "ns_day")}
            fe = free_energy_phases(pme_end, timed["system"], mask,
                                    runs["PME"]["ms"])
            h_remd = h_remd_phase(timed["system"], mask)
    table_build()
    tables = {}
    with cell_finds("LJ-bench") as finds["LJ-bench"], \
            table_calls("LJ-bench", True) as tables["LJ-bench"]:
        lj = lj_bench_path(dev, line)
    with cell_finds("CellTiles-LJ") as finds["CellTiles-LJ"]:
        tiles_lj = celltiles_lj_phase(dev, line, lj["cadence"])
    with cell_finds("MC-LJ") as finds["MC-LJ"], \
            table_calls("MC-LJ", False) as tables["MC-LJ"]:
        mc = mc_lj_phase(lj["end"])
    # the gradient passes track epsilon and stay on the engine; the central
    # difference's passes, under no_grad, take the kernel
    with cell_finds("Gradients") as finds["Gradients"], \
            table_calls("Gradients", None) as tables["Gradients"]:
        grads = gradient_phase(lj["liquid64"], pme_end)
    if not tables["Gradients"]["refused"]:
        raise RuntimeError("Gradients: no gradient pass reached the engine")
    big_frames = big_lj_frames(dev)
    cell_kernel = cell_kernel_phase(lj["end"], big_frames)
    table_kernel = table_kernel_phase(lj["end"], big_frames)
    del big_frames
    forms_phase(dev)
    with table_calls("DPD", False) as tables["DPD"]:
        dpd_card_phase(dev)
    with tempfile.TemporaryDirectory() as workdir:
        triangle_kernel = triangle_kernel_phase(dev, workdir)
    paths = [(label, family) for label, _, _, _, family in MAIN_PATHS]
    paths.append(("FEP-water", FEP_FAMILY))
    print(f"card: {line}; " + "; ".join(
        f"{label} {r['ms']:.4f} ms/{'outer ' if label == 'MTS-PME' else ''}"
        f"step, {r['ns_day']:.4f} ns/day" for label, r in runs.items())
        + f"; NPT-PME (MC) "
        f"{npt['MC']['ms']:.4f} ms/step, {npt['MC']['ns_day']:.4f} ns/day; "
        f"NPT-PME (C-rescale) {npt['C-rescale']['ms']:.4f} ms/step (an "
        "expanding box, re-setups included: not a representative NPT "
        "rate); bonded layer: Bonded-PME "
        f"{runs['Bonded-PME']['layer']['ms']:.4f} ms and "
        f"{runs['Bonded-PME']['layer']['launches']:g} device calls per "
        f"evaluation, all eleven kinds {bonded['ms']:.4f} ms and "
        f"{bonded['launches']:g}; pair-kernel K1a launches: PME "
        f"{runs['PME']['launches']}, Bonded-PME "
        f"{runs['Bonded-PME']['launches']}, MTS-PME "
        f"{runs['MTS-PME']['launches']}; LJ-bench (in.lj, 32,000 atoms, "
        f"the general pair path) {lj['ms']:.4f} ms/step at a rebuild every "
        f"{lj['cadence']} steps, {lj['tau_day']:.1f} tau/day, no pair-kernel "
        "launch; PME-dodecahedron production with loggers and the XTC "
        f"writer {production['ms']:.4f} ms/step, {production['xtc_ms']:.2f} "
        "ms per XTC frame; PME per force evaluation: cube "
        f"{pme_eval['cube'][False]:.4f} ms, dodecahedron "
        f"{pme_eval['dodecahedron'][False]:.4f} ms, TIP4P-Ew cube "
        f"{tip4p['pme_ms']:.4f} ms; pair-kernel K1a launches: TIP4P-Ew-PME "
        f"{tip4p['launches']}, LINCS-PME {lincs['launches']}; per call "
        f"LINCS {lincs['lincs_ms']['LINCS'][0]:.4f} ms (positions) / "
        f"{lincs['lincs_ms']['LINCS'][1]:.4f} ms (velocities) against SHAKE "
        f"{lincs['lincs_ms']['SHAKE'][0]:.4f} / RATTLE "
        f"{lincs['lincs_ms']['SHAKE'][1]:.4f} ms on the same O-H pairs; "
        f"GROMACS-PME {gmx['ms']:.4f} ms/step (neighbor-table engine, a "
        f"rebuild every {gmx['cadence']} steps, list builds included); "
        "free-energy phases: " + "; ".join(
            f"{label} {r['ms']:.4f} ms per biased or lambda step, "
            f"{r['launches']} pair-kernel launches, {r['wall']:.1f} s"
            for label, r in fe.items())
        + f"; T-REMD-PME {t_remd['ms']:.4f} ms per replica-step, "
        f"{t_remd['exchange_ms']:.4f} ms per exchange; H-REMD-FEP "
        f"{h_remd['ms']:.4f} ms per replica-step, "
        f"{h_remd['exchange_ms']:.4f} ms per exchange; MC-LJ "
        f"{mc['ms']:.4f} ms per move; Gradients peak memory "
        f"{grads['peaks'][True]:.3f} GiB with remat, "
        f"{grads['peaks'][False]:.3f} GiB without; ExternalCalculator "
        f"{calc['call_ms']:.4f} ms per call, {calc['add_ms']:.4f} ms/step "
        f"added; CellTiles-PME {tiles_pme['ms']:.4f} ms/step "
        f"({tiles_pme['f_ms']:.4f} ms per tile_forces, peak "
        f"{tiles_pme['run_gib']:.3f} GiB); CellTiles-LJ "
        f"{tiles_lj['ms']:.4f} ms/step, {tiles_lj['per_s']:.2f} "
        f"timesteps/s (peak {tiles_lj['run_gib']:.3f} GiB); Mesh "
        f"{mesh['devices']} device(s), bit for bit with mesh=None; Tuner "
        f"skin {tuner['cfg']['skin']} nm, a rebuild every "
        f"{tuner['cfg']['cadence']} steps", flush=True)
    kernels = [{
        "name": FAMILIES[family], "route": "cuda",
        "source": "mollytpu_torch/csrc/pair_nonbonded.cu",
        "replaces": "mollytpu/ops/pallas_pairwise.py:636",
        "launches": runs[label]["launches"] + more.get(label, 0),
        "max_abs_err": stats[family]["max_abs_err"],
        "ms": stats[family]["ms"], "plain_ms": stats[family]["plain_ms"],
        "bound_ms": stats[family]["bound_ms"],
        "bound_by": stats[family]["bound_by"], "library_ms": None}
        for label, family in paths]
    kernels += [{
        "name": f"{FAMILIES[family]} on {label}", "route": "cuda",
        "source": "mollytpu_torch/csrc/pair_nonbonded.cu",
        "replaces": "mollytpu/ops/pallas_pairwise.py:636",
        "launches": r["launches"],
        **{k: r["stats"][k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by")},
        "library_ms": None}
        for label, family, r in (
            (f"TIP4P-Ew-PME ({4 * N_WATERS:,} particles, "
             f"{N_WATERS:,} virtual sites)", TIP4P_FAMILY, tip4p),
            (f"LINCS-PME ({2 * N_WATERS:,} O-H constraints on LINCS)",
             LINCS_FAMILY, lincs))]
    kernels += [{
        "name": f"{FAMILIES[family]} on {label} (its launches there; "
                f"checked and timed on the {frame} frame)", "route": "cuda",
        "source": "mollytpu_torch/csrc/pair_nonbonded.cu",
        "replaces": "mollytpu/ops/pallas_pairwise.py:636",
        "launches": {**fe, "T-REMD-PME": t_remd, "H-REMD-FEP": h_remd,
                     "Calculators": calc}[label]["launches"],
        **{k: stats[family][k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by")},
        "library_ms": None}
        for label, family, frame in (
            ("Umbrella-MBAR", "coul3-ortho", "PME"),
            ("AWH-umbrella", "coul3-ortho", "PME"),
            ("GridAWH", "coul3-ortho", "PME"),
            ("AWH-lambda", FEP_FAMILY, f"FEP-water lambda={FEP_TIMED}"),
            ("TSS-lambda", FEP_FAMILY, f"FEP-water lambda={FEP_TIMED}"),
            ("T-REMD-PME", "coul3-ortho", "PME"),
            ("H-REMD-FEP", FEP_FAMILY, f"FEP-water lambda={FEP_TIMED}"),
            ("Calculators", "coul3-ortho", "PME"))]
    kernels.append({
        "name": "pair_nonbonded K1a with energy and virial (LJ + Ewald "
                "real space, orthorhombic; the NPT path's Monte Carlo trial "
                "energies)", "route": "cuda",
        "source": "mollytpu_torch/csrc/pair_nonbonded.cu",
        "replaces": "mollytpu/ops/pallas_pairwise.py:636",
        **{k: npt_energy[k] for k in ("launches", "max_abs_err", "ms",
                                      "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None})
    kernels.append({
        "name": "pair_nonbonded K1b with energy and virial (LJ + Ewald real "
                "space, triclinic; the production path's PE, E and pressure "
                "records)", "route": "cuda",
        "source": "mollytpu_torch/csrc/pair_nonbonded.cu",
        "replaces": "mollytpu/ops/pallas_pairwise.py:636",
        "launches": production["energy_launches"],
        **{k: stats["coul3-triclinic"]["energy"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None})
    kernels += [{
        "name": f"{FAMILIES[e['family']]}, roofline probe {e['probe']} "
                "(wrong physics on purpose; not on a main path)",
        "route": "cuda", "source": "mollytpu_torch/csrc/pair_nonbonded.cu",
        "replaces": PROBE_SITES[e["probe"]],
        "launches": e["launches"], "max_abs_err": e["max_abs_err"],
        "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
        "bound_by": e["bound_by"], "library_ms": None} for e in probes]
    kernels += [{
        "name": f"cell_neighbors_kernel (CellListNeighborFinder.find's "
                f"table) on {frame}", "route": "cuda",
        "source": "mollytpu_torch/csrc/cell_neighbors.cu",
        "replaces": "none: XLA, mollytpu/ops/neighbors.py:234",
        "launches": sum(c["launches"] for c in finds.values()),
        "launches_by_path": {label: c["launches"]
                             for label, c in finds.items()},
        **{k: r[k] for k in ("max_abs_err", "ms", "find_ms", "plain_ms",
                             "bound_ms", "bound_by")},
        "library_ms": None} for frame, r in cell_kernel.items()]
    kernels += [{
        "name": f"lj_table_kernel (neighbor_forces, Lennard-Jones on the "
                f"neighbor table) on {frame}", "route": "cuda",
        "source": "mollytpu_torch/csrc/lj_table.cu",
        "replaces": "none: XLA, mollytpu/ops/nonbonded.py neighbor_forces",
        "launches": sum(t["launches"] for t in tables.values()),
        "launches_by_path": {label: t["launches"]
                             for label, t in tables.items()},
        **{k: r[k] for k in ("max_abs_err", "ms", "call_ms", "plain_ms",
                             "bound_ms", "bound_by")},
        "library_ms": None} for frame, r in table_kernel.items()]
    kernels += [{
        "name": f"triangle_{kind}_kernel (SHAKERattle's TRIANGLE bucket, "
                f"{'SHAKE' if kind == 'shake' else 'RATTLE'}) on {frame}",
        "route": "cuda", "source": "mollytpu_torch/csrc/rigid_triangles.cu",
        "replaces": "none: XLA, mollytpu/ops/constraints.py:33-611",
        "launches": sum(t[kind] for t in triangles.values()),
        "launches_by_path": {label: t[kind]
                             for label, t in triangles.items()},
        **{k: r[kind][k] for k in ("max_abs_err", "ms", "call_ms",
                                   "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None}
        for frame, r in triangle_kernel.items() for kind in ("shake",
                                                             "rattle")]
    print(f"chip_smoke.py: the whole run took "
          f"{time.perf_counter() - t_start:.1f} s (the kernels' build "
          "included)", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
