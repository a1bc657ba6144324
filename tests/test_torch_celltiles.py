"""The cell-tile engine of mollytpu_torch (ops/celltiles.py) against the
JAX package's (mollytpu/ops/celltiles.py), float64 on the CPU: setup's
grid, capacity and stencil; find's table, overflow and step; the tile
energy, forces and virial on the 32-atom LJ fluid of
tests/test_simulation.py, the 100-atom lattice and the heavy-exclusion
chain of tests/test_kernel_consistency.py (coordinates from numpy), and
the 64-water box with LJ + CoulombEwald (1e-10 relative on energy, 1e-10
absolute on forces, as JAX holds its tiles to its dense engine; f32
within 1e-5 of rms|F|); the
dispatch of forces and potential_energy; a 50-step velocity Verlet run
against JAX's simulate (1e-9 nm); overflow and a stale table raising;
the NPT re-setup; the bridge; and the skewed-box check, where JAX's tiles
miss pairs and the port's setup raises."""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.ops import celltiles as jct

import mollytpu_torch as pt
from mollytpu_torch.bridge import system_from_arrays
from mollytpu_torch.ops import celltiles as pct
from mollytpu_torch.sim.simulate import list_check, raise_if_stale
from tests.test_kernel_consistency import _mk_system
from torch_parity import CPU, LIST_RADIUS, jax_system, np64
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL_E, TOL_F, TOL_F32 = 1e-10, 1e-10, 1e-5


def dodecahedron(mod, edge, dtype):
    angles = (math.radians(60.0), math.radians(60.0), math.radians(90.0))
    if mod is mt:
        return mt.triclinic_from_lengths_angles((edge,) * 3, angles,
                                                dtype=dtype)
    return pt.triclinic_from_lengths_angles((edge,) * 3, angles, dtype=dtype,
                                            device=CPU)


BOXES = {
    "cube": lambda mod, dt: (mod.cubic(2.7, dtype=dt) if mod is mt
                             else pt.cubic(2.7, dt, CPU)),
    # fewer than 3 cells on two axes: a stencil of 12 cells
    "rect": lambda mod, dt: (mod.rectangular((2.0, 3.0, 1.5), dtype=dt)
                             if mod is mt else
                             pt.rectangular((2.0, 3.0, 1.5), dt, CPU)),
    # three cells on x and y, two on z: every cell of an axis in the
    # stencil, so JAX's tiles are exact there
    "dodeca": lambda mod, dt: dodecahedron(mod, 3.0, dt),
}


def random_coords(box, n, seed):
    """n points uniform in the box (fractional uniforms through its
    basis), float64 numpy."""
    f = np.random.default_rng(seed).uniform(0.0, 1.0, (n, 3))
    return f @ np64(box.box_matrix())


@pytest.mark.parametrize("name", list(BOXES))
def test_setup_matches_jax(name):
    jb, pb = BOXES[name](mt, jnp.float64), BOXES[name](pt, torch.float64)
    jf = jct.CellTileFinder.setup(jb, 0.95, 180, n_steps=5)
    pf = pt.CellTileFinder.setup(pb, 0.95, 180, n_steps=5)
    assert pf.grid_dims == jf.grid_dims
    assert pf.cell_capacity == jf.cell_capacity
    assert pf.n_steps == jf.n_steps == 5
    assert pf.ref_sides == pytest.approx(jf.ref_sides, rel=1e-15)
    np.testing.assert_array_equal(pf.stencil.numpy(), np.asarray(jf.stencil))
    if name == "rect":
        assert pf.stencil.shape[1] < 27


@pytest.mark.parametrize("name,capacity", [("cube", None), ("rect", None),
                                           ("dodeca", None), ("cube", 8)])
def test_find_matches_jax(name, capacity):
    jb, pb = BOXES[name](mt, jnp.float64), BOXES[name](pt, torch.float64)
    n = 180
    x = random_coords(pb, n, 11)
    jf = jct.CellTileFinder.setup(jb, 0.95, n, cell_capacity=capacity)
    pf = pt.CellTileFinder.setup(pb, 0.95, n, cell_capacity=capacity)
    jt = jax.jit(lambda c: jf.find(c, jb, step_n=7))(jnp.asarray(x))
    tiles = pf.find(torch.as_tensor(x), pb, step_n=7)
    np.testing.assert_array_equal(tiles.table.numpy(), np.asarray(jt.table))
    assert int(tiles.overflow) == int(jt.overflow)
    assert tiles.step_built == int(jt.step_built) == 7
    if capacity is not None:
        assert int(tiles.overflow) > 0


def spread(n, box, min_dist, seed):
    """n points in a cube of side ``box``, at least ``min_dist`` apart
    (minimum image), by rejection from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((0, 3))
    while len(pts) < n:
        x = rng.uniform(0.0, box, 3)
        d = x - pts
        d -= box * np.round(d / box)
        if not len(pts) or (d * d).sum(axis=1).min() >= min_dist ** 2:
            pts = np.vstack([pts, x])
    return pts


def lj32():
    """tests/test_simulation.py:250's fluid (32 atoms, 2.0 nm box, shifted
    force at 0.8 nm), its coordinates and 100 K velocities from numpy."""
    rng = np.random.default_rng(5)
    atoms = mt.make_atoms(n=32, mass=10.0, sigma=0.3, epsilon=0.2,
                          dtype=jnp.float64)
    vels = rng.normal(0.0, math.sqrt(pt.units.KB * 100.0 / 10.0), (32, 3))
    return mt.System(
        atoms=atoms, coords=jnp.asarray(spread(32, 2.0, 0.36, 5)),
        boundary=mt.cubic(2.0, dtype=jnp.float64),
        velocities=jnp.asarray(vels - vels.mean(axis=0)),
        pairwise_inters=(mt.LennardJones(cutoff=mt.ShiftedForceCutoff(0.8),
                                         use_neighbors=True),)), 0.9


def lattice100():
    pts = [[0.52 * (i // 25) + 0.26, 0.52 * ((i % 25) // 5) + 0.26,
            0.52 * (i % 5) + 0.26] for i in range(100)]
    sys, mk, _ = _mk_system(100, 2.6, jnp.float64, coords=np.array(pts),
                            sigma=0.35)
    return sys.update(pairwise_inters=mk(True)), 0.9


def chain64():
    n = 64
    excl = [(i, i + 1) for i in range(n - 1)] + \
        [(i, i + 2) for i in range(n - 2)]
    spec = [(i, i + 3) for i in range(n - 3)]
    sys, mk, _ = _mk_system(n, 2.6, jnp.float64,
                            coords=spread(n, 2.6, 0.25, 64),
                            excl_pairs=excl, special_pairs=spec)
    return sys.update(pairwise_inters=mk(True)), 0.9


def water64():
    """The 64-water box: LJ + CoulombEwald real space with the 1-4 and
    intramolecular exclusions (its PME is not a tile term)."""
    return jax_system("tiny64"), LIST_RADIUS


SYSTEMS = {"lj32": lj32, "lattice100": lattice100, "chain64": chain64,
           "water64": water64}


@functools.lru_cache(maxsize=None)
def jax_case(name):
    """(JAX system with a CellTileFinder of the case's radius, its tiles,
    JAX's tile energy, forces and virial), computed once per case."""
    js, radius = SYSTEMS[name]()
    finder = jct.CellTileFinder.setup(js.boundary, radius, js.n_atoms)
    js = js.update(neighbor_finder=finder)
    jt = jax.jit(lambda s: finder.find(s.coords, s.boundary,
                                       s.exclusions))(js)
    args = (listed(js.pairwise_inters), js.atoms, js.coords, js.boundary,
            jt, js.neighbor_finder, js.exclusions)
    e = jax.jit(lambda *a: jct.tile_energy(*a))(*args)
    f, v = jax.jit(lambda *a: jct.tile_forces(*a, needs_virial=True))(*args)
    return js, jt, (float(e), np64(f), np64(v))


def both(name, dtype=torch.float64):
    """(JAX system, its tiles, its tile terms, the port's system, its
    tiles)."""
    js, jt, terms = jax_case(name)
    ps = system_from_arrays(jax.device_get(js), dtype=dtype, device=CPU)
    tiles = ps.neighbor_finder.find(ps.coords, ps.boundary, ps.exclusions)
    return js, jt, terms, ps, tiles


def listed(inters):
    return tuple(i for i in inters if getattr(i, "use_neighbors", False))


def port_tile_terms(ps, tiles):
    args = (listed(ps.pairwise_inters), ps.atoms, ps.coords, ps.boundary,
            tiles, ps.neighbor_finder, ps.exclusions)
    e = pct.tile_energy(*args)
    f, v = pct.tile_forces(*args, needs_virial=True)
    return float(e), np64(f), np64(v)


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_tile_engine_matches_jax(name):
    _, jt, (e_j, f_j, v_j), ps, tiles = both(name)
    np.testing.assert_array_equal(tiles.table.numpy(), np.asarray(jt.table))
    assert int(jt.overflow) == 0
    e, f, v = port_tile_terms(ps, tiles)
    assert e == pytest.approx(e_j, rel=TOL_E)
    np.testing.assert_allclose(f, f_j, rtol=0, atol=TOL_F)
    np.testing.assert_allclose(v, v_j, rtol=0, atol=TOL_F * max(
        1.0, np.abs(v_j).max()))
    if name == "chain64":
        assert int(ps.exclusions.excl_i.numel()) == 64 - 1 + 64 - 2
    # f32 against JAX's float64
    ps = system_from_arrays(jax.device_get(jax_case(name)[0]),
                            dtype=torch.float32, device=CPU)
    tiles = ps.neighbor_finder.find(ps.coords, ps.boundary, ps.exclusions)
    _, f, _ = port_tile_terms(ps, tiles)
    rms = np.sqrt((f_j ** 2).sum(axis=1).mean())
    assert np.sqrt(((f - f_j) ** 2).sum(axis=1).mean()) / rms < TOL_F32


def test_dispatch_and_trajectory_match_jax():
    """forces.py sends CellTiles to the tile engine (lj32 has no other
    term); then 50 velocity Verlet steps against JAX's simulate."""
    js, _, (e_j, f_j, v_j), ps, tiles = both("lj32")
    assert float(pt.potential_energy(ps, tiles)) == pytest.approx(
        e_j, rel=TOL_E)
    f, v = pt.forces_virial(ps, tiles, needs_virial=True)
    np.testing.assert_allclose(np64(f), f_j, atol=TOL_F)
    np.testing.assert_allclose(np64(v), v_j, atol=TOL_F)
    np.testing.assert_allclose(np64(pt.forces(ps, tiles)), f_j, atol=TOL_F)
    final_j, _ = mt.simulate(js, mt.VelocityVerlet(dt=0.001), 50,
                             key=jax.random.PRNGKey(22))
    final, nb, _ = pt.simulate(ps, pt.VelocityVerlet(dt=0.001), 50)
    assert isinstance(nb, pt.CellTiles) and nb.step_built == 50
    np.testing.assert_allclose(np64(final.coords), np64(final_j.coords),
                               rtol=0, atol=1e-9)


def test_overflow_raises():
    _, _, _, ps, _ = both("lj32")
    finder = pt.CellTileFinder.setup(ps.boundary, 0.9, ps.n_atoms,
                                     cell_capacity=2)
    assert finder.cell_capacity == 8
    # 32 atoms in 8 cells cannot all fit 2 to a cell
    dense = ps.update(neighbor_finder=dataclasses.replace(finder,
                                                          cell_capacity=2))
    tiles = dense.neighbor_finder.find(dense.coords, dense.boundary)
    assert int(tiles.overflow) > 0
    with pytest.raises(RuntimeError, match="overflow"):
        pt.simulate(dense, pt.VelocityVerlet(dt=0.001), 2)


def test_a_stale_table_raises():
    """Two atoms 2.1 nm apart in a 4 nm cube (cells 1 nm wide) lie two
    cells apart; moved 0.7 nm apart, their pair is inside the 0.8 nm
    cutoff and outside the old tiles' stencil."""
    box = pt.cubic(4.0, torch.float64, CPU)
    x = torch.tensor([[0.5, 2.0, 2.0], [2.6, 2.0, 2.0], [3.5, 3.5, 0.5]],
                     dtype=torch.float64)
    sys = pt.System(
        atoms=pt.make_atoms(n=3, mass=10.0, sigma=0.3, epsilon=0.2,
                            dtype=torch.float64, device=CPU),
        coords=x, boundary=box,
        pairwise_inters=(pt.LennardJones(cutoff=pt.DistanceCutoff(0.8),
                                         use_neighbors=True),),
        neighbor_finder=pt.CellTileFinder.setup(box, 0.9, 3))
    assert sys.neighbor_finder.grid_dims == (4, 4, 4)
    old = sys.neighbor_finder.find(sys.coords, box)
    near, _ = list_check(sys, old, 0.8)
    assert float(near) == math.inf
    moved = sys.update(coords=x + torch.tensor([[0.0] * 3, [-1.4, 0, 0],
                                                [0.0] * 3],
                                               dtype=torch.float64))
    near, over = list_check(moved, old, 0.8)
    assert int(over) == 0
    assert float(near) == pytest.approx(0.7, abs=1e-12)
    with pytest.raises(pt.StaleNeighborList):
        raise_if_stale(near, 0.8)


def test_box_drift_and_resetup_match_jax():
    jb, pb = mt.cubic(3.0, dtype=jnp.float64), pt.cubic(3.0, torch.float64,
                                                        CPU)
    jf = jct.CellTileFinder.setup(jb, 0.95, 200, n_steps=4)
    pf = pt.CellTileFinder.setup(pb, 0.95, 200, n_steps=4)
    for mu in (1.04, 1.06, 0.93):
        assert pf.box_drift_exceeded(pb.scale(mu)) == \
            jf.box_drift_exceeded(jb.scale(mu))
    jr = jf.resetup(jb.scale(1.4), 200)
    pr = pf.resetup(pb.scale(1.4), 200)
    assert pr.grid_dims == jr.grid_dims != pf.grid_dims
    assert (pr.cell_capacity, pr.n_steps) == (jr.cell_capacity, jr.n_steps)
    np.testing.assert_array_equal(pr.stencil.numpy(), np.asarray(jr.stencil))


def test_bridge_carries_the_finder():
    js, _, _, ps, _ = both("water64")
    jf, pf = js.neighbor_finder, ps.neighbor_finder
    assert isinstance(pf, pt.CellTileFinder)
    for field in ("dist_cutoff", "grid_dims", "cell_capacity", "n_steps",
                  "ref_sides", "resetup_drift"):
        assert getattr(pf, field) == getattr(jf, field), field
    np.testing.assert_array_equal(pf.stencil.numpy(), np.asarray(jf.stencil))


def test_skewed_box_jax_misses_pairs_and_the_port_raises():
    """A rhombic dodecahedron of edge 4.0 nm: four cells on x and y, each
    4.0 sqrt(2/3) / 4 = 0.816 nm wide across, under the 0.95 nm radius.
    JAX's tiles miss pairs inside the 0.9 nm cutoff (its energy and forces
    differ from its dense engine's); the port's setup raises."""
    jb, pb = dodecahedron(mt, 4.0, jnp.float64), dodecahedron(
        pt, 4.0, torch.float64)
    n = 400
    basis = np64(pb.basis)
    inv = np.linalg.inv(basis)
    rng = np.random.default_rng(3)
    pts = []
    while len(pts) < n:
        x = rng.uniform(0.0, 1.0, 3) @ basis
        if pts:
            d = (x - np.asarray(pts)) @ inv
            d = (d - np.round(d)) @ basis
            if np.min((d * d).sum(axis=1)) < 0.3 ** 2:
                continue
        pts.append(x)
    coords = jnp.asarray(np.asarray(pts))
    atoms = mt.make_atoms(n=n, mass=10.0, sigma=0.2, epsilon=0.2,
                          dtype=jnp.float64)
    dense = mt.System(atoms=atoms, coords=coords, boundary=jb,
                      pairwise_inters=(mt.LennardJones(
                          cutoff=mt.DistanceCutoff(0.9)),))
    finder = jct.CellTileFinder.setup(jb, 0.95, n)
    assert finder.grid_dims[:2] == (4, 4)
    tiled = dense.update(pairwise_inters=(mt.LennardJones(
        cutoff=mt.DistanceCutoff(0.9), use_neighbors=True),),
        neighbor_finder=finder)
    tiles = jax.jit(lambda s: finder.find(s.coords, s.boundary))(dense)
    assert int(tiles.overflow) == 0
    energy, forces = jax.jit(mt.potential_energy), jax.jit(mt.forces)
    de = float(energy(tiled, tiles)) - float(energy(dense))
    df = np.abs(np64(forces(tiled, tiles)) - np64(forces(dense))).max()
    # 2.3e-4 kJ/mol and 8.5e-4 kJ/mol/nm here: pairs missed, not rounding
    assert abs(de) > 1e-5 and df > 1e-4
    with pytest.raises(ValueError, match="perpendicular width"):
        pt.CellTileFinder.setup(pb, 0.95, n)
