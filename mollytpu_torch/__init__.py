"""mollytpu_torch: the PyTorch / CUDA port of mollytpu.

The JAX package ``mollytpu`` is the reference; this package mirrors its
module names and public layouts ((N, 3) coordinates and forces in nm and
kJ/mol/nm, (3, 3) virials, the internal units of ``units``). The hot pair
kernel is hand-written CUDA C++ for Hopper (``csrc/``), built with nvcc on
first use; every kernel has a plain PyTorch twin that CPU tensors use.
Entry points build on the CUDA card unless given ``device="cpu"``.
"""

from . import units
from .atoms import (ALCH_CORE, ALCH_DELETE, ALCH_INSERT, AtomData, Atoms,
                    make_atoms)
from .boundary import (Orthorhombic, Triclinic, cubic, distance, place_atoms,
                       place_diatomics, random_coords, rectangular,
                       sq_distance, triclinic, triclinic_from_lengths_angles)
from .config import (ENV_FLAGS, describe_env, report_issue, resolve_device,
                     strictness)
from .forces import (accelerations, forces, forces_virial,
                     potential_energy, total_energy)
from .models.forcefield import ForceField
from .models.setup import (add_position_restraints, crystal_system,
                           system_from_pdb)
from .models.gromacs import read_gro, system_from_gromacs
from .models.waterbox import (DODECAHEDRON, TIP3P_XML, TIP4PEW_XML,
                              water_box_gromacs, water_box_pdb)
from .ops.bonded import (
    SpecificList, all_specific_forces, cosine_angles, ewald_exclusions,
    fene_bonds, harmonic_angles, harmonic_bonds, harmonic_torsions,
    morse_bonds, periodic_torsions, position_restraints, rb_torsions,
    register_term, specific_energy, specific_forces, urey_bradleys)
from .ops.cutoffs import (CubicSplineCutoff, DistanceCutoff, NoCutoff,
                          PolynomialCutoff, ShiftedForceCutoff,
                          ShiftedPotentialCutoff, cutoff_distance)
from .ops.cmap import cmap_coefficients, make_cmap_list
from .ops.constraints import SHAKERattle, angle_constraint
from .ops.ewald import (PME, Ewald, EwaldExclusionCorrection,
                        ewald_exclusion_list)
from .ops.gbsa import (ImplicitSolventGBN2, ImplicitSolventOBC,
                       make_implicit_solvent)
from .ops.lincs import LINCS
from .ops.general import (GeneralInteraction, LJDispersionCorrection,
                          MullerBrown)
from .ops.mixing import (ExceptionTable, FenderHalseyMixing,
                         GeometricMixing, InverseMixing, LorentzMixing,
                         MinimumMixing, MixingException,
                         WaldmanHaglerMixing, mix_epsilon, mix_lambda,
                         mix_sigma)
from .ops.neighbors import (CellListNeighborFinder, DistanceNeighborFinder,
                            Neighbors, NoNeighborFinder, find_neighbors,
                            maybe_rebuild)
from .ops.nonbonded import (dense_energy, dense_forces, dense_pair_mask,
                            neighbor_energy, neighbor_forces)
from .ops.pairwise import (
    AshbaughHatch, Buckingham, Coulomb, CoulombEwald, CoulombEwaldScaled,
    CoulombReactionField, CoulombReactionFieldScaled, CoulombScaled,
    CoulombSoftCoreBeutler, CoulombSoftCoreBeutlerEwald,
    CoulombSoftCoreBeutlerReactionField, CoulombSoftCoreGapsys,
    CoulombSoftCoreGapsysEwald, CoulombSoftCoreGapsysReactionField,
    DoubleExponential, DoubleExponentialSoftCore, DPDInteraction, Gravity,
    LennardJones, LennardJonesSoftCoreBeutler, LennardJonesSoftCoreGapsys,
    Mie, SoftSphere, Yukawa, interaction_cutoff)
from .ops.blockpairs import BlockPairFinder, BlockPairs
from .ops.celltiles import CellTileFinder, CellTiles
from .sim.coupling import (AndersenThermostat, BerendsenBarostat,
                           BerendsenThermostat, CRescaleBarostat,
                           ImmediateThermostat, MonteCarloBarostat,
                           VelocityRescaleThermostat, apply_couplers,
                           couplers_invalidate_forces, needs_virial_interval)
from .sim.integrators import (DPDVelocityVerlet, Langevin,
                              LangevinSplitting, MTSIntegrator,
                              MTSLangevinIntegrator, NoseHoover,
                              OverdampedLangevin, StormerVerlet, Verlet,
                              VelocityVerlet)
from .sim.minimize import SteepestDescentMinimizer
from .sim.simulate import (StaleNeighborList, npt_resetup, run_chunk,
                           simulate, simulate_differentiable)
from .sim.mc import (MetropolisMonteCarlo, random_normal_translation,
                     random_uniform_translation)
from .sim.remd import HamiltonianReplicaExchangeMD, ReplicaExchangeMD
from .parallel.replicas import (ReplicaEnsemble, make_ensemble,
                                make_ensemble_step, replica_mesh,
                                shard_ensemble, simulate_ensemble)
from .interop import Calculator, ExternalCalculator
from .spatial import (kinetic_energy, kinetic_energy_tensor,
                      molecule_centers, n_dof, pressure_tensor,
                      random_velocities, random_velocity, remove_cm_motion,
                      scalar_pressure, scale_coords, scale_coords_molecular,
                      temperature, unwrap_molecules)
from .ops.virtual_sites import VirtualSites
from .system import Exclusions, System, molecule_ids_from_bonds
from .free_energy.mbar import (PMF, MBARInput, assemble_mbar_inputs,
                               free_energy_differences, iterate_mbar,
                               mbar_pmf, mbar_weights, pmf_with_uncertainty)
from .free_energy.cv import (CalcCMDist, CalcDist, CalcMaxDist, CalcMinDist,
                             CalcRg, CalcRMSD, CalcSingleDist, CalcTorsion,
                             cv_gradient)
from .free_energy.bias import (BiasPotential, FlatBottomSquareBias,
                               LinearBias, PeriodicFlatBottomBias,
                               SquareBias)
from .free_energy.extended_ensemble import (ActiveThermoState,
                                            ExtendedStateSpace)
from .free_energy.coupling import PerturbedTerms, couple_molecule
from .free_energy.awh import (AWHPMFBackend, AWHSimulation, AWHState,
                              GridAWH, GridAWHState, GridBias)
from .free_energy.pmf import (
    PMFGrid as PMFGridND, PMFResult, SampledPMFDeconvolutionAccumulator,
    build_log_coupling_matrix, pmf_bin_quality, pmf_log_bin_weights,
    pmf_result_from_sampled_deconvolution)
from .free_energy.tss import (
    TSSHistoryForgetting, TSSJackknifeResult, TSSLocalEstimator,
    TSSPMFDeconvolution, TSSSimulation, TSSState, tss_free_energies,
    tss_free_energy_uncertainties)
from .free_energy.tss_graph import (
    TSSGraph, TSSGraphBuilder, TSSWindow, add_tss_edge, build_tss_graph,
    single_window_tss_graph, tss_grid_graph)
from .free_energy.stats import (effective_sample_size,
                                statistical_inefficiency, subsample_indices)
from .free_energy.thermo import (AlchemicalPartition, LambdaHamiltonian,
                                 ThermoState, set_lambda)
from .utils import analysis, loggers
from .utils.analysis import (dipole_moment, displacements, distances,
                             hydrodynamic_radius, msd, radius_gyration, rdf,
                             rmsd)
from .utils.checkpoint import load_checkpoint, save_checkpoint
from .utils.loggers import (
    AverageObservableLogger, BoxLogger, CoordinatesLogger, DensityLogger,
    DisplacementsLogger, ForcesLogger, GeneralObservableLogger,
    KineticEnergyLogger, MonteCarloLogger, PotentialEnergyLogger,
    PressureLogger, ReplicaExchangeLogger, ScalarPressureLogger,
    ScalarVirialLogger, TemperatureLogger, TimeCorrelationLogger,
    TotalEnergyLogger, VelocitiesLogger, VirialLogger, VolumeLogger,
    autocorrelation)
from .utils.trajectory import (EnsembleSystem, TrajectoryWriter,
                               read_xtc_coords)
from .utils.visualize import render_frame, visualize
from .free_energy.alchemy import (DefaultLambdaScheduler,
                                  EleScaledLambdaScheduler,
                                  NAMDLambdaScheduler,
                                  QuartersLambdaScheduler)

__version__ = "0.1.0"
