"""GROMACS's water benchmark on the port's main path, on the CPU: rigid SPC
water (waterbox.spc_topology) read by system_from_gromacs with
neighbor_finder="block" (the cluster-pair list and the pair kernel's CPU
twin), PME by GROMACS's rules (ewald-rtol, fourierspacing, pme-order), and
leap-frog with v-rescale; held against the benchmark's plain reference
(benchmark/reference/spc_water.py, float64, SETTLE solved analytically),
against the neighbor-table engine, and against the JAX package's reader
for the vectorised set-up. The committed tile (SPC_TILE, 1,000 waters) is
held to its constraints and density, and its script runs.

The pair work is cut to a 0.6 nm cutoff (list radius 0.7 nm) so that the
3,000-atom tile runs in seconds on one thread; the benchmark runs 1.0 nm.
Tolerances: the float32 program against the float64 reference, forces
1e-4 of the reference's rms per atom and energy 2e-6 relative, a chunk's
positions 2e-5 nm; the two float32 engines 1e-4 and 1e-5 (the energy's
float32 sums in another order); the reference's PME on a 0.017 nm mesh
against a direct Ewald sum 1e-5 relative, against the port's PME 1e-8.
"""

import json
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mollytpu.models.gromacs import system_from_gromacs as jax_from_gromacs

import mollytpu_torch as pt
from mollytpu_torch.models import gromacs, waterbox
from mollytpu_torch.ops import blockpairs, constraints, ewald
from mollytpu_torch.ops.constraints import SHAKERattle
from mollytpu_torch.ops.ewald import (PME, ewald_error_alpha,
                                      ewald_rtol_alpha, pme_mesh_dims,
                                      pme_mesh_dims_spacing)
from torch_parity import CPU
from torch_parity import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from reference.precision import F64  # noqa: E402
from reference.spc_water import SPCWater, read_tile  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RC, RLIST = 0.6, 0.7
CONFIG = os.path.join(BENCH, "configs", "gmx-water-1536000.json")


def config(rc=RC, tiles=1):
    with open(CONFIG) as fh:
        cfg = json.load(fh)
    cfg["water"]["tiles_per_side"] = tiles
    cfg["mdp"]["rcoulomb"] = cfg["mdp"]["rvdw"] = rc
    return cfg


def build(tmp_path, finder="block", dtype=torch.float32, rc=RC,
          rlist=RLIST, **kw):
    gro = gromacs.read_gro(waterbox.SPC_TILE)
    top = waterbox.spc_topology(str(tmp_path / "spc.top"), len(gro[0]) // 3)
    args = dict(nonbonded_method="pme", dist_cutoff=rc, dist_neighbors=rlist,
                device=CPU, dtype=dtype, use_settles=True,
                dispersion_correction=False, velocities_from_gro=False,
                neighbor_finder=finder, ewald_rtol=1e-5, fourier_spacing=0.12,
                pme_order=4)
    args.update(kw)
    return gromacs.system_from_gromacs(gro, top, **args)


@pytest.fixture(scope="module")
def water(tmp_path_factory):
    """The tile on the block path, started at 300 K from a seed, and the
    reference at the same cutoff."""
    d = tmp_path_factory.mktemp("spc")
    s = gromacs.gen_vel_start(build(d), 300.0,
                              torch.Generator().manual_seed(2 ** 31 + 5))
    return d, s, SPCWater(config(), F64, CPU)


def test_block_system_matches_the_plain_reference(water):
    _, s, ref = water
    nb = pt.find_neighbors(s.neighbor_finder, s.coords, s.boundary,
                           s.exclusions, 0)
    assert isinstance(nb, pt.BlockPairs)
    f = pt.forces(s, nb)
    f_ref = ref.forces(s.coords.double())
    rms = torch.sqrt((f_ref * f_ref).sum(1).mean())
    assert float((f.double() - f_ref).norm(dim=1).max() / rms) < 1e-4
    e, e_ref = float(pt.potential_energy(s, nb)), float(ref.energy(
        s.coords.double()))
    assert abs(e - e_ref) / abs(e_ref) < 2e-6
    # the reference's own start is the tile on its triangles
    assert ref.constraint_deviation(ref.start) < 1e-12
    assert float((ref.start - ref.whole(s.coords.double())).abs().max()) \
        < 1e-6


def test_block_and_cell_engines_agree(water):
    d, s, _ = water
    c = build(d, finder="cell").update(coords=s.coords,
                                       velocities=s.velocities)
    assert isinstance(c.neighbor_finder, pt.CellListNeighborFinder)
    nb_b = pt.find_neighbors(s.neighbor_finder, s.coords, s.boundary,
                             s.exclusions, 0)
    nb_c = pt.find_neighbors(c.neighbor_finder, c.coords, c.boundary,
                             c.exclusions, 0)
    f_b, f_c = pt.forces(s, nb_b), pt.forces(c, nb_c)
    rms = torch.sqrt((f_c * f_c).sum(1).mean())
    assert float((f_b - f_c).norm(dim=1).max() / rms) < 1e-4
    e_b, e_c = float(pt.potential_energy(s, nb_b)), float(
        pt.potential_energy(c, nb_c))
    assert abs(e_b - e_c) / abs(e_c) < 1e-5


def test_gromacs_ewald_rules(water):
    d, s, _ = water
    beta = ewald_rtol_alpha(1.0, 1e-5)
    assert math.erfc(beta * 1.0) == pytest.approx(1e-5, rel=1e-9)
    assert 1.0 / beta == pytest.approx(0.320163, abs=5e-7)   # GROMACS's log
    assert math.erfc(ewald_rtol_alpha(RC, 1e-5) * RC) == pytest.approx(
        1e-5, rel=1e-9)
    assert pme_mesh_dims_spacing([24.9, 24.9, 24.9], 0.12) == (216,) * 3
    assert pme_mesh_dims_spacing([3.11, 3.2, 3.3], 0.12) == (27, 27, 30)
    pme, excl = s.general_inters
    lj, coul = s.pairwise_inters
    assert isinstance(pme, PME) and pme.order == 4
    assert pme.mesh_dims == pme_mesh_dims_spacing(
        s.boundary.side_lengths.numpy(), 0.12)
    assert pme.alpha == coul.alpha == excl.alpha == ewald_rtol_alpha(RC,
                                                                      1e-5)
    assert isinstance(lj.sigma_mixing, pt.LorentzMixing)


def test_openmm_route_is_unchanged_bit_for_bit(water):
    """Without the GROMACS arguments, PME.setup and system_from_gromacs
    take OpenMM's alpha and mesh, and PME's forces are those of the same
    setup with that alpha and mesh given."""
    d, s, _ = water
    o = build(d, finder="cell", ewald_rtol=None, fourier_spacing=None,
              pme_order=5)
    pme, excl = o.general_inters[:2]
    alpha = ewald_error_alpha(RC, 0.0005)
    sides = o.boundary.side_lengths.numpy()
    assert pme.alpha == excl.alpha == o.pairwise_inters[1].alpha == alpha
    assert pme.order == 5
    assert pme.mesh_dims == pme_mesh_dims(sides, alpha, 0.0005)
    given = PME.setup(o.boundary, dist_cutoff=RC, alpha=alpha,
                      mesh_dims=pme_mesh_dims(sides, alpha, 0.0005))
    f0, v0 = pme.force_virial(s.coords, o.boundary, o.atoms, True)
    f1, v1 = given.force_virial(s.coords, o.boundary, o.atoms, True)
    assert torch.equal(f0, f1) and torch.equal(v0, v1)


def test_tiling_is_the_periodic_images_of_the_tile():
    tile = gromacs.read_gro(waterbox.SPC_TILE)
    names, resn, resi, x, v, box = waterbox.tile_gro(tile, 2)
    n = len(tile[0])
    assert names == list(tile[0]) * 8 and resn == list(tile[1]) * 8
    assert resi[n] == max(tile[2]) + 1 and len(set(resi)) == 8 * n // 3
    np.testing.assert_array_equal(box, 2 * np.asarray(tile[5]))
    copies = x.reshape(8, n, 3)
    shifts = copies - np.asarray(tile[3])[None]
    for k, (i, j, l) in enumerate(np.ndindex(2, 2, 2)):
        np.testing.assert_allclose(shifts[k], np.broadcast_to(
            np.array([i, j, l]) * tile[5], (n, 3)), atol=1e-12)
    # the reference lays out the same box from the file itself
    ref = SPCWater(config(tiles=2), F64, CPU)
    xr, edges = read_tile(waterbox.SPC_TILE)
    np.testing.assert_allclose(edges * 2, box)
    np.testing.assert_allclose(ref.whole(torch.as_tensor(x)).numpy(),
                               ref.start.numpy(), atol=2e-3)
    # every water whole in the tiled box: its O-H distances are SPC's to
    # the file's three decimals, with no minimum image taken
    w = x.reshape(-1, 3, 3)
    doh = np.linalg.norm(w[:, 1:] - w[:, :1], axis=2)
    assert np.abs(doh - waterbox.SPC_DOH).max() < 2e-3


def test_committed_tile_holds_its_constraints_and_density():
    names, _, _, x, _, box = gromacs.read_gro(waterbox.SPC_TILE)
    with open(CONFIG) as fh:
        recorded = json.load(fh)["water"]
    assert len(names) == 3 * recorded["tile_waters"] == 3000
    assert names[:3] == ["OW", "HW1", "HW2"]
    w = x.reshape(-1, 3, 3)
    d = np.concatenate([np.linalg.norm(w[:, 1:] - w[:, :1], axis=2),
                        np.linalg.norm(w[:, 2] - w[:, 1], axis=1)[:, None]],
                       axis=1)
    d0 = np.array([waterbox.SPC_DOH, waterbox.SPC_DOH, waterbox.SPC_DHH])
    # the .gro's 3 decimals move each distance by at most ~1.7e-3 nm
    assert np.abs(d - d0).max() < 2e-3
    assert np.abs(d - d0).mean() < 5e-4
    density = recorded["tile_waters"] / float(np.prod(box))
    assert density == pytest.approx(recorded["tile_molecules_per_nm3"],
                                    rel=1e-4)
    assert 30.0 < density < 35.0


def test_tile_script_runs_from_its_seed(tmp_path):
    """The script that made the tile, cut to 125 waters and a few steps:
    it writes a whole-water .gro and its JSON line, and the same seed gives
    the same tile on the CPU."""
    script = os.path.join(REPO, "mollytpu_torch", "data", "make_spc_tile.py")
    outs = []
    for k in range(2):
        out = tmp_path / f"t{k}.gro"
        res = subprocess.run(
            [sys.executable, script, "--seed", "7", "--out", str(out),
             "--waters", "125", "--cutoff", "0.6", "--rlist", "0.75",
             "--melt-ps", "0.02", "--npt-ps", "0.05", "--nvt-ps", "0.02",
             "--device", "cpu"], capture_output=True, text=True,
            timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
        assert res.returncode == 0, res.stderr[-2000:]
        info = json.loads(res.stdout.strip().splitlines()[-1])
        assert info["waters"] == 125 and info["temperature_end_k"] > 0
        outs.append(gromacs.read_gro(str(out)))
    np.testing.assert_array_equal(outs[0][3], outs[1][3])
    np.testing.assert_array_equal(outs[0][5], outs[1][5])


def test_leapfrog_vrescale_chunk_matches_the_reference(water):
    """One chunk of 10 steps of leap-frog with v-rescale on the block path
    against the reference's SETTLE leap-frog from the same state with the
    same thermostat draws, and the counters of PME's evaluations and the
    constraints' sweeps over it."""
    _, s, ref = water
    thermo = pt.VelocityRescaleThermostat(300.0, 0.1)
    sim = pt.Verlet(dt=0.002, coupling=(thermo,), remove_cm=False)
    gen = torch.Generator().manual_seed(11)
    nb = pt.find_neighbors(s.neighbor_finder, s.coords, s.boundary,
                           s.exclusions, 0)
    aux = sim.init_aux(s, nb)
    state = gen.get_state()
    ewald.EVALUATIONS.clear()
    constraints.SWEEPS.update(dict.fromkeys(constraints.SWEEPS, 0))
    out, _, _, closest = pt.run_chunk(sim, s, nb, aux, 0, 10, generator=gen)
    assert closest >= RC
    # one PME evaluation per step on the configured mesh; per step one
    # SHAKE call of 5 Newton iterations and one RATTLE solve
    assert ewald.EVALUATIONS == {s.general_inters[0].mesh_dims: 10}
    assert constraints.SWEEPS == {"position_calls": 10, "position_sweeps": 50,
                                  "velocity_calls": 10, "velocity_sweeps": 10}
    replay = torch.Generator()
    replay.set_state(state)
    draws = []
    for _ in range(10):
        d = thermo.draw(s, replay)
        draws.append((float(d["r1"]), float(d["g"])))
    x_ref, v_ref = ref.leapfrog(s.coords.double(), s.velocities.double(), 10,
                                0.002, 300.0, 0.1, draws)
    gap = ref.mic(out.coords.double() - x_ref).norm(dim=1).max()
    assert float(gap) < 2e-5
    assert ref.constraint_deviation(out.coords) < 2e-5
    t_p = float(pt.temperature(out.masses, out.velocities, out.n_dof))
    t_r = float((ref.mass[:, None] * v_ref * v_ref).sum()
                / (ref.n_dof * 0.00831446261815324))
    assert t_p == pytest.approx(t_r, rel=1e-4)


def test_reference_settle_is_the_constrained_step():
    """The reference's SETTLE against a float64 Newton solve of the same
    step (displacements along the old bonds, mass-weighted): random waters
    moved by up to 0.01 nm."""
    rng = np.random.default_rng(3)
    w = 50
    o = rng.uniform(0, 3, (w, 3))
    ang = 2.0 * math.asin(0.5 * waterbox.SPC_DHH / waterbox.SPC_DOH)
    h1 = np.array([waterbox.SPC_DOH, 0, 0])
    h2 = waterbox.SPC_DOH * np.array([math.cos(ang), math.sin(ang), 0])
    rot = np.linalg.qr(rng.normal(size=(w, 3, 3)))[0]
    x0 = o[:, None] + np.einsum("wij,aj->wai", rot, np.stack(
        [np.zeros(3), h1, h2]))
    x1 = x0 + rng.uniform(-0.01, 0.01, x0.shape)
    from reference.spc_water import settle
    got = settle(torch.as_tensor(x0), torch.as_tensor(x1), 15.9994, 1.008,
                 waterbox.SPC_DOH, waterbox.SPC_DHH).numpy()
    solver = SHAKERattle.triangles(np.arange(3 * w).reshape(w, 3),
                                   np.tile([waterbox.SPC_DOH, waterbox.SPC_DOH,
                                            waterbox.SPC_DHH], (w, 1)),
                                   dtype=torch.float64, device=CPU)
    solver = type(solver)(**{**solver.__dict__, "newton_iters": 30})
    box = pt.boundary.rectangular([100.0] * 3, dtype=torch.float64,
                                  device=CPU)
    m = torch.tensor([15.9994, 1.008, 1.008] * w, dtype=torch.float64)
    want, _ = solver.apply_position_constraints(
        torch.as_tensor(x0.reshape(-1, 3)), torch.as_tensor(
            x1.reshape(-1, 3)), None, m, box, 1.0)
    np.testing.assert_allclose(got.reshape(-1, 3), want.numpy(), atol=1e-12)


def test_reference_pme_matches_a_direct_ewald_sum():
    """The reference's smooth PME (order 4) against the port's direct Ewald
    sum (ops.ewald.Ewald over a k-space cube) on 27 waters of the tile in
    a 1.5 nm box, on a mesh fine enough (90 points, 0.017 nm) for the
    interpolation's error to fall below 1e-5 of the energy; and against
    the port's PME of order 4 on the same mesh and alpha."""
    tile = gromacs.read_gro(waterbox.SPC_TILE)
    x = np.asarray(tile[3]).reshape(-1, 3, 3)
    keep = np.all(x[:, 0] < 1.35, axis=1) & np.all(x[:, 0] > 0.15, axis=1)
    xt = torch.as_tensor(x[keep][:27].reshape(-1, 3))
    cfg = config(rc=0.7)
    cfg["mdp"]["ewald_rtol"] = 1e-6
    ref = SPCWater(cfg, F64, CPU)
    # the reference cut to a 27-water box of its own
    ref.edges, ref.L = np.full(3, 1.5), torch.full((3,), 1.5,
                                                 dtype=torch.float64)
    ref.n, ref.n_waters, ref.mesh, ref._influence = 81, 27, [90] * 3, None
    ref.charge = ref.charge[:81]
    e_rec, f_rec = ref._reciprocal(xt)
    atoms = pt.make_atoms(n=81, mass=ref.mass[:81].numpy(),
                          charge=ref.charge.numpy(), sigma=np.zeros(81),
                          epsilon=np.zeros(81), dtype=torch.float64,
                          device=CPU)
    box = pt.boundary.rectangular([1.5] * 3, dtype=torch.float64, device=CPU)
    # the direct sum's reciprocal part alone: its self term taken off
    e_self = -138.935458 * ref.beta / math.sqrt(math.pi) * float(
        (ref.charge ** 2).sum())
    e_direct = float(pt.Ewald(alpha=ref.beta, kmax=14).energy(
        xt, box, atoms)) - e_self
    assert float(e_rec) == pytest.approx(e_direct, rel=1e-5)
    pme = PME.setup(box, dist_cutoff=0.7, order=4, mesh_dims=(90,) * 3,
                    alpha=ref.beta, dtype=torch.float64)
    f_port, _ = pme.force_virial(xt, box, atoms)
    assert float((f_port - f_rec).abs().max() / f_rec.abs().max()) < 1e-8


def test_vectorised_setup_matches_the_jax_loops(tmp_path):
    """A topology of two molecule types, one of them twice in
    [molecules], and SPC waters: the port's tiled set-up gives the JAX
    package's per-copy exclusions, 1-4 pairs, bonded lists, molecule ids
    and settle constraints (those as SHAKERattle.build makes them)."""
    from test_torch_gromacs import MOL_TOP
    top_text = MOL_TOP.replace("[ molecules ]\nMOL  2", (
        "[ molecules ]\nMOL  2\nSOL  3\nMOL  1\n"))
    spc = waterbox._SPC_TOP
    water_type = spc[spc.index("[ moleculetype ]"):spc.index("[ system ]")]
    top_text = top_text.replace("[ system ]", water_type + "[ system ]")
    hw = "HW      1       1.00800   0.41    A      0.0  0.0\n"
    ow = "OW      8       15.99940  -0.82   A      0.316557  0.650194\n"
    top_text = top_text.replace("[ atomtypes ]\n", "[ atomtypes ]\n" + ow
                                + hw)
    top = tmp_path / "mixed.top"
    top.write_text(top_text)
    rng = np.random.default_rng(1)
    lines = ["mixed", "   24"]
    names = ["C1", "C2", "C3", "C4", "O5"] * 2 + ["OW", "HW1", "HW2"] * 3 \
        + ["C1", "C2", "C3", "C4", "O5"]
    for a, name in enumerate(names):
        lines.append("%5d%-5s%5s%5d%8.3f%8.3f%8.3f" % (
            1, "MOL", name, a + 1, *rng.uniform(0.5, 2.5, 3)))
    lines.append("   3.00000   3.00000   3.00000")
    gro = tmp_path / "mixed.gro"
    gro.write_text("\n".join(lines) + "\n")
    kw = dict(nonbonded_method="cutoff", dist_neighbors=1.15,
              use_settles=True)
    js = jax_from_gromacs(str(gro), str(top), dtype=jnp.float64, **kw)
    ps = pt.system_from_gromacs(str(gro), str(top), dtype=torch.float64,
                                device=CPU, **kw)
    for field in ("excl_i", "excl_j", "spec_i", "spec_j", "excl_bits",
                  "spec_bits", "far_excl", "far_spec", "excl_table",
                  "spec_table"):
        np.testing.assert_array_equal(
            getattr(ps.exclusions, field).numpy(),
            np.asarray(getattr(js.exclusions, field)), err_msg=field)
    for jl, pl in zip(js.specific_lists, ps.specific_lists):
        np.testing.assert_array_equal(pl.atom_idx.numpy(),
                                      np.asarray(jl.atom_idx))
    np.testing.assert_array_equal(ps.molecule_ids.numpy(),
                                  np.asarray(js.molecule_ids))
    assert ps.n_molecules == int(js.n_molecules) == 6
    (c,) = ps.constraints
    loops = SHAKERattle.build([(10 + 3 * k + a, 10 + 3 * k + b)
                               for k in range(3)
                               for a, b in ((0, 1), (0, 2), (1, 2))],
                              [0.1, 0.1, 0.1633] * 3, dtype=torch.float64,
                              device=CPU)
    for field in ("idx_i", "idx_j", "dists"):
        assert torch.equal(getattr(c, field), getattr(loops, field)), field
    assert len(c.clusters) == len(loops.clusters) == 1
    assert torch.equal(c.clusters[0].atoms, loops.clusters[0].atoms)
    assert torch.equal(c.clusters[0].dists, loops.clusters[0].dists)
    assert c.clusters[0].pattern == loops.clusters[0].pattern
    assert ps.n_dof == int(js.n_dof)


def test_block_mixing_rule_other_than_lorentz_berthelot_raises(tmp_path):
    """comb-rule 3 with two LJ types of different sigma gives another
    sigma than the pair kernel's rule: "block" refuses it, "cell" builds."""
    gro = gromacs.read_gro(waterbox.SPC_TILE)
    text = waterbox._SPC_TOP.replace(
        "HW      1       1.00800   0.41    A      0.00000e+00  0.00000e+00",
        "HW      1       1.00800   0.41    A      1.00000e-01  1.00000e-01")
    top = tmp_path / "lj_h.top"
    top.write_text(text.format(n=1000))
    kw = dict(nonbonded_method="pme", device=CPU, use_settles=True,
              dist_cutoff=RC, dist_neighbors=RLIST)
    with pytest.raises(NotImplementedError, match="Lorentz-Berthelot"):
        gromacs.system_from_gromacs(gro, str(top), neighbor_finder="block",
                                    **kw)
    s = gromacs.system_from_gromacs(gro, str(top), neighbor_finder="cell",
                                    **kw)
    assert isinstance(s.pairwise_inters[0].sigma_mixing, pt.GeometricMixing)


def test_binned_cluster_pairs_match_every_pair(water):
    """The cluster-pair search over the grid of cluster centers lists the
    pairs that measuring every cluster pair lists, on the tile tiled 2 x 2
    x 2 at a radius where the grid has 3 or more cells along each axis; the
    stale check finds the closest unlisted pair below the cutoff."""
    d, s, _ = water
    gro = waterbox.tile_gro(gromacs.read_gro(waterbox.SPC_TILE), 2)
    top = waterbox.spc_topology(str(d / "spc8.top"), len(gro[0]) // 3)
    big = gromacs.system_from_gromacs(
        gro, top, nonbonded_method="pme", dist_cutoff=0.35,
        dist_neighbors=0.45, device=CPU, use_settles=True,
        velocities_from_gro=False, neighbor_finder="block")
    nb = pt.find_neighbors(big.neighbor_finder, big.coords, big.boundary,
                           big.exclusions, 0)
    x = big.boundary.wrap(big.coords)[nb.src].view(-1, blockpairs.CLUSTER, 3)
    centers, exts = blockpairs._cluster_boxes(x, big.boundary)
    dims, _ = blockpairs._cluster_grid(centers, exts, big.boundary, 0.45)
    assert min(dims) >= 3
    c = centers.shape[0]
    ci, cj = torch.triu_indices(c, c)
    gap = blockpairs._pair_gaps(centers, exts, big.boundary, ci, cj)
    near = gap < 0.45
    every = torch.stack([ci[near], cj[near]], dim=1).to(torch.int32)
    assert torch.equal(nb.pairs, every)
    moved = big.coords + 0.1 * torch.randn(big.coords.shape,
                                           generator=torch.Generator()
                                           .manual_seed(5))
    closest = float(blockpairs.unlisted_min_distance(nb, moved, big.boundary,
                                                     0.35))
    # atom by atom over every unlisted cluster pair whose boxes (a lower
    # bound on their atoms' distances) now come within the cutoff
    cont = nb.coords_built + big.boundary.displacement(nb.coords_built,
                                                       moved)
    xm = cont[nb.src].view(-1, blockpairs.CLUSTER, 3)
    c_now, e_now = blockpairs._cluster_boxes(xm, big.boundary)
    un_i, un_j = ci[~near], cj[~near]
    close = blockpairs._pair_gaps(c_now, e_now, big.boundary, un_i,
                                  un_j) < 0.35
    un_i, un_j = un_i[close], un_j[close]
    dd = torch.linalg.vector_norm(pt.boundary.mic_displacement(
        big.boundary, xm[un_i][:, :, None, :], xm[un_j][:, None, :, :]),
        dim=-1)
    ids = nb.ids.view(-1, blockpairs.CLUSTER)
    real = (ids[un_i] < big.n_atoms)[:, :, None] & \
        (ids[un_j] < big.n_atoms)[:, None, :]
    brute = float(torch.where(real, dd, float("inf")).amin())
    assert brute < 0.35 and closest == brute
