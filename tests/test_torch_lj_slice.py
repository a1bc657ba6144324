"""The general pair path as a whole against the JAX package, float64 on
the CPU:

- LAMMPS's in.lj (models/ljbench.py) at 500 atoms (5^3 fcc cells), built
  as chip_smoke.py builds it at 32,000: the step-0 pair energy per atom
  against an independent numpy lattice sum, then 40 velocity-Verlet steps
  with a cell-list rebuild every 20 against JAX's chunk runner on the
  same arrays (1e-9 nm); the loop's exact stale-list check finds the
  pairs that reach the cutoff between rebuilds 20 steps apart (LAMMPS's
  "dangerous builds", which in.lj does not check), and passes at 10;
- 20 DPDVelocityVerlet steps of a DPD fluid on a distance-finder table
  against JAX's (1e-9 nm on JAX's pair noise; 1e-7 nm on the port's own,
  which agrees with JAX's float32 noise to 3 ulp, tests/
  test_torch_nonbonded.py);
- system_from_pdb with nonbonded_method="none" (with and without CRYST1),
  neighbor_finder="cell" and "distance", and NBFix overrides from a force
  field this file writes, each against the JAX package's system_from_pdb:
  the same interactions and finder, and the same energy and forces (1e-10
  relative, 1e-8 of rms|F|).
"""

import dataclasses
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.models.forcefield import ForceField as JaxForceField
from mollytpu.models.setup import system_from_pdb as jax_system_from_pdb
from mollytpu.ops.neighbors import find_neighbors as jax_find_neighbors
from mollytpu.sim.simulate import _make_chunk_fn

import mollytpu_torch as pt
from mollytpu_torch.models import ljbench
from torch_parity import (CPU, box_path, jax_forces_virial,  # noqa: F401
                          jax_fresh_start, jax_potential_energy, jax_xi,
                          np64, one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TRAJ = 1e-9
N_CELLS = 5


def numpy_lattice_energy():
    """E_pair / N (epsilon) of the fcc lattice at density 0.8442 with the
    2.5 sigma truncation, summed over lattice vectors in reduced units."""
    a = (4.0 / 0.8442) ** (1.0 / 3.0)
    basis = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    r = np.arange(-4, 5)
    cells = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 1, 3)
    d = np.linalg.norm(((cells + basis[None]) * a).reshape(-1, 3), axis=1)
    d = d[(d > 0) & (d < 2.5)]
    assert len(d) == 54
    return 0.5 * np.sum(4.0 * (d ** -12 - d ** -6))


@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-6)])
def test_lattice_energy_matches_numpy(dtype, tol):
    ref = numpy_lattice_energy()
    assert ref == pytest.approx(ljbench.LATTICE_ENERGY, abs=5e-8)
    sys = ljbench.lj_bench_system(N_CELLS, dtype=dtype, device=CPU)
    nb = pt.find_neighbors(sys.neighbor_finder, sys.coords, sys.boundary,
                           sys.exclusions)
    e = float(pt.potential_energy(sys, nb)) / sys.n_atoms / ljbench.EPSILON
    assert e == pytest.approx(ref, rel=tol)
    # in.lj's start: zero momentum, exactly 1.44 epsilon / kB
    assert float(torch.linalg.vector_norm(
        (sys.masses[:, None] * sys.velocities).sum(dim=0))) < 1e-4
    t = float(pt.temperature(sys.masses, sys.velocities, sys.n_dof))
    assert t == pytest.approx(ljbench.TEMPERATURE, rel=1e-5)


@functools.lru_cache(maxsize=None)
def lj_pair():
    """(JAX system, port system): in.lj at 5^3 cells in float64, the JAX
    one from the port's arrays with JAX's own cell-list finder."""
    ps = ljbench.lj_bench_system(N_CELLS, dtype=torch.float64, device=CPU)
    n = ps.n_atoms
    jb = mt.cubic(float(ps.boundary.side_lengths[0]), dtype=jnp.float64)
    jf = mt.CellListNeighborFinder.setup(jb, ljbench.CUTOFF + ljbench.SKIN,
                                         n, n_steps=ljbench.EVERY)
    for field in ("grid_dims", "n_steps", "max_neighbors", "cell_capacity"):
        assert getattr(ps.neighbor_finder, field) == getattr(jf, field)
    js = mt.System(
        atoms=mt.make_atoms(n=n, mass=ljbench.MASS, sigma=ljbench.SIGMA,
                            epsilon=ljbench.EPSILON, dtype=jnp.float64),
        coords=jnp.asarray(np64(ps.coords)), boundary=jb,
        velocities=jnp.asarray(np64(ps.velocities)),
        pairwise_inters=(mt.LennardJones(
            cutoff=mt.DistanceCutoff(ljbench.CUTOFF), use_neighbors=True),),
        neighbor_finder=jf)
    return js, ps


def test_lj_trajectory_with_rebuilds_every_20_matches_jax():
    """40 steps, a rebuild at steps 20 and 40, as JAX's chunk runner
    schedules them; the port's steps on the same schedule."""
    js, ps = lj_pair()
    sim_j = mt.VelocityVerlet(dt=ljbench.DT, remove_cm=False)
    nbs = jax_find_neighbors(js.neighbor_finder, js.coords, js.boundary,
                             js.exclusions, 0)
    run = jax.jit(partial(_make_chunk_fn(sim_j, False, js.neighbor_finder,
                                         align=0), n=40))
    out_j, nbs_j, _, _ = run(js, nbs, sim_j.init_aux(js, nbs),
                             jax.random.PRNGKey(0), 0)

    sim = ljbench.lj_bench_integrator()
    finder = ps.neighbor_finder
    nb = pt.find_neighbors(finder, ps.coords, ps.boundary, ps.exclusions)
    np.testing.assert_array_equal(np.asarray(nbs.idx), nb.idx.numpy())
    aux, sys = sim.init_aux(ps, nb), ps
    for step_n in range(40):
        sys, aux = sim.step(sys, nb, aux, step_n)
        if (step_n + 1) % ljbench.EVERY == 0:
            nb = pt.find_neighbors(finder, sys.coords, sys.boundary,
                                   sys.exclusions, step_n + 1)
    np.testing.assert_allclose(np64(sys.coords), np64(out_j.coords),
                               rtol=0, atol=TRAJ)
    np.testing.assert_allclose(np64(sys.velocities), np64(out_j.velocities),
                               rtol=0, atol=1e-7)
    np.testing.assert_array_equal(np.asarray(nbs_j.idx), nb.idx.numpy())


def test_lj_stale_check_fails_at_20_and_passes_at_10():
    """The loop's check: at in.lj's cadence of 20, a pair that was beyond
    the list radius at a rebuild comes inside the cutoff by the next
    (within the first 40 steps); at 10 none does over 60 steps."""
    _, ps = lj_pair()
    sim = ljbench.lj_bench_integrator()
    with pytest.raises(pt.StaleNeighborList, match="missing from the "
                                                   "neighbor list"):
        pt.simulate(ps, sim, 40)
    ten = ps.update(neighbor_finder=dataclasses.replace(ps.neighbor_finder,
                                                        n_steps=10))
    nb = pt.find_neighbors(ten.neighbor_finder, ten.coords, ten.boundary,
                           ten.exclusions)
    _, nb, _, closest = pt.run_chunk(sim, ten, nb, sim.init_aux(ten, nb), 0,
                                     60)
    assert closest == float("inf") and nb.step_built == 60


DPD_N, DPD_DT = 192, 0.01


@functools.lru_cache(maxsize=None)
def dpd_arrays(seed=5):
    """A DPD fluid at density 3 (unit masses, a 4 nm cube), positions and
    velocities from numpy."""
    rng = np.random.default_rng(seed)
    side = (DPD_N / 3.0) ** (1.0 / 3.0)
    return rng.uniform(0.0, side, (DPD_N, 3)), rng.normal(
        size=(DPD_N, 3)), side


def _dpd_systems():
    x, v, side = dpd_arrays()
    kw = dict(a=25.0, gamma=4.5, sigma=3.0, r_c=1.0, dt=DPD_DT)
    js = mt.System(atoms=mt.make_atoms(n=DPD_N, mass=1.0, dtype=jnp.float64),
                   coords=jnp.asarray(x), boundary=mt.cubic(
                       side, dtype=jnp.float64), velocities=jnp.asarray(v),
                   pairwise_inters=(mt.DPDInteraction(**kw),),
                   neighbor_finder=mt.DistanceNeighborFinder(1.8, 5, 64))
    ps = pt.System(atoms=pt.make_atoms(n=DPD_N, mass=1.0,
                                       dtype=torch.float64, device=CPU),
                   coords=torch.as_tensor(x), boundary=pt.cubic(
                       side, dtype=torch.float64, device=CPU),
                   velocities=torch.as_tensor(v),
                   pairwise_inters=(pt.DPDInteraction(**kw),),
                   neighbor_finder=pt.DistanceNeighborFinder(1.8, 5, 64))
    return js, ps


@functools.lru_cache(maxsize=None)
def dpd_jax_run():
    js, _ = _dpd_systems()
    sim = mt.DPDVelocityVerlet(dt=DPD_DT)
    nbs = jax_find_neighbors(js.neighbor_finder, js.coords, js.boundary,
                             js.exclusions, 0)
    run = jax.jit(partial(_make_chunk_fn(sim, False, js.neighbor_finder,
                                         align=0), n=20))
    out, _, _, _ = run(jax_fresh_start(js, sim), nbs, sim.init_aux(js, nbs),
                       jax.random.PRNGKey(0), 0)
    return np64(out.coords), np64(out.velocities)


@pytest.mark.parametrize("noise, tol, v_tol", [("jax", TRAJ, 1e-7),
                                               ("port", 1e-7, 1e-6)])
def test_dpd_trajectory_matches_jax(noise, tol, v_tol, monkeypatch):
    if noise == "jax":
        monkeypatch.setattr(pt.DPDInteraction, "_xi",
                            lambda self, i, j, step_n: jax_xi(self.seed, i,
                                                              j, step_n))
    x_j, v_j = dpd_jax_run()
    _, ps = _dpd_systems()
    out, nb, _ = pt.simulate(ps, pt.DPDVelocityVerlet(dt=DPD_DT), 20)
    assert nb.step_built == 20
    np.testing.assert_allclose(np64(out.coords), x_j, rtol=0, atol=tol)
    np.testing.assert_allclose(np64(out.velocities), v_j, rtol=0,
                               atol=v_tol)


NBFIX_XML = """<ForceField>
 <AtomTypes>
  <Type name="tip3p-O" class="OW" element="O" mass="15.99943"/>
  <Type name="tip3p-H" class="HW" element="H" mass="1.007947"/>
 </AtomTypes>
 <Residues>
  <Residue name="HOH">
   <Atom name="O" type="tip3p-O"/>
   <Atom name="H1" type="tip3p-H"/>
   <Atom name="H2" type="tip3p-H"/>
   <Bond atomName1="O" atomName2="H1"/>
   <Bond atomName1="O" atomName2="H2"/>
  </Residue>
 </Residues>
 <HarmonicBondForce>
  <Bond class1="OW" class2="HW" length="0.09572" k="462750.4"/>
 </HarmonicBondForce>
 <HarmonicAngleForce>
  <Angle class1="HW" class2="OW" class3="HW" angle="1.82421813418" k="836.8"/>
 </HarmonicAngleForce>
 <NonbondedForce coulomb14scale="0.833333" lj14scale="0.5">
  <Atom type="tip3p-O" charge="-0.834" sigma="1" epsilon="0"/>
  <Atom type="tip3p-H" charge="0.417" sigma="1" epsilon="0"/>
 </NonbondedForce>
 <LennardJonesForce lj14scale="0.5">
  <Atom type="tip3p-O" sigma="0.31507524065751241" epsilon="0.635968"/>
  <Atom type="tip3p-H" sigma="0.12" epsilon="0.02"/>
  <NBFixPair class1="OW" class2="HW" sigma="0.2" epsilon="0.3"/>
 </LennardJonesForce>
</ForceField>
"""


def _pdb(tmp_path, cryst1):
    """tiny64's water box, with or without its CRYST1 record."""
    with open(box_path("tiny64")) as f:
        lines = f.read().splitlines()
    path = tmp_path / f"w{int(cryst1)}.pdb"
    path.write_text("\n".join(ln for ln in lines
                              if cryst1 or not ln.startswith("CRYST1"))
                    + "\n")
    return str(path)


SETUPS = {
    "none": dict(nonbonded_method="none"),
    "none-open": dict(nonbonded_method="none", cryst1=False),
    "cell": dict(nonbonded_method="cutoff", neighbor_finder="cell"),
    "distance": dict(nonbonded_method="cutoff", neighbor_finder="distance"),
    "open-cutoff": dict(nonbonded_method="cutoff", neighbor_finder="cell",
                        cryst1=False),
    "nbfix-cell": dict(nonbonded_method="cutoff", neighbor_finder="cell",
                       nbfix=True),
}


def _fields(obj):
    """A finder's or an interaction's fields as comparable values."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = (type(v).__name__, _fields(v))
        elif not isinstance(v, (int, float, bool, tuple, type(None))):
            v = type(v).__name__
        out[f.name] = v
    return out


@pytest.mark.parametrize("case", SETUPS)
def test_system_from_pdb_matches_jax(case, tmp_path):
    kw = dict(SETUPS[case])
    path = _pdb(tmp_path, kw.pop("cryst1", True))
    xml = pt.TIP3P_XML
    if kw.pop("nbfix", False):
        xml = str(tmp_path / "nbfix.xml")
        with open(xml, "w") as f:
            f.write(NBFIX_XML)
    common = dict(dist_cutoff=0.9, dist_neighbors=1.1, constraints="hbonds",
                  rigid_water=True, **kw)
    js = jax_system_from_pdb(path, JaxForceField(xml), dtype=jnp.float64,
                             build_cache=False, **common)
    ps = pt.system_from_pdb(path, pt.ForceField(xml), dtype=torch.float64,
                            device=CPU, **common)
    assert [type(i).__name__ for i in ps.pairwise_inters] == [
        type(i).__name__ for i in js.pairwise_inters]
    for a, b in zip(ps.pairwise_inters, js.pairwise_inters):
        fa, fb = _fields(a), _fields(b)
        for name in fa:
            assert fa[name] == fb.get(name, fa[name]), (case, name)
    assert type(ps.neighbor_finder).__name__ == type(
        js.neighbor_finder).__name__
    if ps.neighbor_finder is not None:
        assert _fields(ps.neighbor_finder) == _fields(js.neighbor_finder)
    np.testing.assert_array_equal(np64(ps.boundary.side_lengths),
                                  np64(js.boundary.side_lengths))
    nbs = jax_find_neighbors(js.neighbor_finder, js.coords, js.boundary,
                             js.exclusions, 0)
    nb = pt.find_neighbors(ps.neighbor_finder, ps.coords, ps.boundary,
                           ps.exclusions)
    if nb is not None:
        np.testing.assert_array_equal(np.asarray(nbs.idx), nb.idx.numpy())
    f_j, v_j = jax_forces_virial(js, nbs)
    f_p, v_p = pt.forces_virial(ps, nb, needs_virial=True)
    e_j, e_p = jax_potential_energy(js, nbs), pt.potential_energy(ps, nb)
    scale = max(1.0, float(np.sqrt((np64(f_j) ** 2).sum(axis=1).mean())))
    assert np.max(np.abs(np64(f_p) - np64(f_j))) / scale < 1e-8
    assert np.max(np.abs(np64(v_p) - np64(v_j))) / scale < 1e-8
    assert abs(float(e_p) - float(e_j)) <= 1e-10 * max(1.0, abs(float(e_j)))


def test_nbfix_on_the_block_list_raises(tmp_path):
    xml = tmp_path / "nbfix.xml"
    xml.write_text(NBFIX_XML)
    with pytest.raises(NotImplementedError, match="neighbor_finder=\"cell\""):
        pt.system_from_pdb(box_path("tiny64"), pt.ForceField(str(xml)),
                           device=CPU, constraints="hbonds", rigid_water=True)


def test_diatomics_from_the_docs_match_jax():
    """docs/documentation.md's diatomics, placed by place_diatomics from a
    torch.Generator: first atoms at least min_dist apart, each second
    atom bond_length along x, wrapped; then the documented system (LJ on
    the dense engine, harmonic bonds, bonded pairs excluded) on those
    coordinates in both packages."""
    n_mol, side, bond, min_dist = 30, 2.0, 0.1, 0.3
    box = pt.cubic(side, dtype=torch.float64, device=CPU)
    gen = torch.Generator().manual_seed(3)
    x = pt.place_diatomics(gen, box, n_mol, bond, min_dist=min_dist,
                           dtype=torch.float64)
    first, second = x[0::2], x[1::2]
    d = torch.linalg.vector_norm(box.displacement(first[:, None, :],
                                                  first[None, :, :]), dim=-1)
    assert float(d[~torch.eye(n_mol, dtype=torch.bool)].min()) > min_dist
    np.testing.assert_allclose(
        np64(box.displacement(first, second)),
        np.tile([bond, 0.0, 0.0], (n_mol, 1)), atol=1e-12)
    assert bool(((x >= 0) & (x < side)).all())
    bi, bj = np.arange(n_mol) * 2, np.arange(n_mol) * 2 + 1
    pairs = list(zip(bi.tolist(), bj.tolist()))
    js = mt.System(
        atoms=mt.make_atoms(n=2 * n_mol, mass=10.0, sigma=0.3, epsilon=0.2,
                            dtype=jnp.float64),
        coords=jnp.asarray(np64(x)), boundary=mt.cubic(side,
                                                       dtype=jnp.float64),
        pairwise_inters=(mt.LennardJones(cutoff=mt.DistanceCutoff(1.0)),),
        specific_lists=(mt.harmonic_bonds(
            jnp.asarray(bi), jnp.asarray(bj), k=jnp.full((n_mol,), 3e5),
            r0=jnp.full((n_mol,), bond)),),
        exclusions=mt.Exclusions.build(2 * n_mol, excl_pairs=pairs))
    ps = pt.System(
        atoms=pt.make_atoms(n=2 * n_mol, mass=10.0, sigma=0.3, epsilon=0.2,
                            dtype=torch.float64, device=CPU),
        coords=x, boundary=box,
        pairwise_inters=(pt.LennardJones(cutoff=pt.DistanceCutoff(1.0)),),
        specific_lists=(pt.harmonic_bonds(bi, bj, k=np.full(n_mol, 3e5),
                                          r0=np.full(n_mol, bond),
                                          dtype=torch.float64, device=CPU),),
        exclusions=pt.Exclusions.build(2 * n_mol, excl_pairs=pairs,
                                       device=CPU))
    f_j, v_j = jax_forces_virial(js, None)
    f_p, v_p = pt.forces_virial(ps, needs_virial=True)
    scale = max(1.0, float(np.sqrt((np64(f_j) ** 2).sum(axis=1).mean())))
    assert np.max(np.abs(np64(f_p) - np64(f_j))) / scale < 1e-8
    assert np.max(np.abs(np64(v_p) - np64(v_j))) / scale < 1e-8
    e_j, e_p = jax_potential_energy(js, None), pt.potential_energy(ps)
    assert abs(float(e_p) - float(e_j)) <= 1e-10 * max(1.0, abs(float(e_j)))


def test_gravity_in_an_open_box_matches_jax():
    """The documentation's gravity example in 3-D: two bodies in an open
    box, Gravity without a cutoff on the dense engine."""
    m = np.array([2e30, 6e24])
    x = np.array([[0.0, 0.0, 0.0], [1.5e11, 0.0, 0.0]])
    v = np.array([[0.0, 0.0, 0.0], [0.0, 29_800.0, 0.0]])
    js = mt.System(atoms=mt.make_atoms(n=2, mass=m, sigma=0.1, epsilon=0.0,
                                       dtype=jnp.float64),
                   coords=jnp.asarray(x), velocities=jnp.asarray(v),
                   boundary=mt.rectangular([np.inf] * 3, dtype=jnp.float64),
                   pairwise_inters=(mt.Gravity(G=6.674e-11),))
    ps = pt.System(atoms=pt.make_atoms(n=2, mass=m, sigma=0.1, epsilon=0.0,
                                       dtype=torch.float64, device=CPU),
                   coords=torch.as_tensor(x), velocities=torch.as_tensor(v),
                   boundary=pt.rectangular([np.inf] * 3, dtype=torch.float64,
                                           device=CPU),
                   pairwise_inters=(pt.Gravity(G=6.674e-11),))
    np.testing.assert_allclose(np64(pt.forces(ps)),
                               np64(jax.jit(mt.forces)(js)), rtol=1e-12)
    np.testing.assert_allclose(float(pt.total_energy(ps)),
                               float(jax.jit(mt.total_energy)(js)),
                               rtol=1e-12)
    np.testing.assert_allclose(np64(pt.accelerations(ps)),
                               np64(jax.jit(mt.accelerations)(js)),
                               rtol=1e-12)
