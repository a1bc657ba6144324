"""The production path's pieces of mollytpu_torch against the JAX package
(float64): ``simulate`` with loggers and a trajectory writer against JAX's
``simulate`` with the same loggers (run_loggers True and "skipstart"); the
trajectory writers' bytes and the readers; the checkpoint round trip; and
the analysis functions.

Tolerances: the logs of 20 Langevin steps on the dense reaction-field
box, the port fed JAX's noise, agree to 1e-9 relative; the writers agree
byte for byte on the same frames; a run resumed from a checkpoint at a
rebuild step is the uninterrupted run bit for bit (CPU, float64); the
analysis functions agree to 1e-10 relative."""

import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.utils import trajectory as jax_traj

import mollytpu_torch as pt
from mollytpu_torch.bridge import system_from_arrays
from mollytpu_torch.utils import trajectory
from torch_parity import (CPU, LIST_RADIUS, jax_dense_rf_system,
                          jax_noise_sequence, max_rel, np64)
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DT, TEMP, FRICTION = 0.002, 300.0, 1.0
N_STEPS = 20
REL = 1e-9


@pytest.fixture(scope="module")
def start():
    js = jax_dense_rf_system()
    ps = system_from_arrays(jax.device_get(js), device=CPU,
                            dist_neighbors=LIST_RADIUS, n_steps=10)
    return js, ps


def _loggers(m, path):
    """The same loggers from module m (mollytpu or mollytpu_torch)."""
    return {"T": m.TemperatureLogger(5), "KE": m.KineticEnergyLogger(5),
            "PE": m.PotentialEnergyLogger(5), "E": m.TotalEnergyLogger(10),
            "P": m.ScalarPressureLogger(10), "Ptensor": m.PressureLogger(10),
            "W": m.ScalarVirialLogger(10), "V": m.VolumeLogger(10),
            "rho": m.DensityLogger(10), "box": m.BoxLogger(20),
            "x": m.CoordinatesLogger(10), "F": m.ForcesLogger(10),
            "corr": m.TimeCorrelationLogger(
                lambda s, n, a, i: s.velocities[0], interval=5),
            "disp": m.DisplacementsLogger(10),
            "mean_v2": m.AverageObservableLogger(
                lambda s, n, a, i: (s.velocities ** 2).sum(), interval=5),
            "traj": m.TrajectoryWriter(5, path)}


@pytest.mark.parametrize("run_loggers", [True, "skipstart"])
def test_simulate_loggers_match_jax(start, tmp_path, run_loggers):
    js, ps = start
    sim_j = mt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)
    sim_p = pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)
    key = jax.random.PRNGKey(21)
    lj = _loggers(mt, str(tmp_path / "jax.xtc"))
    lp = _loggers(pt, str(tmp_path / "port.xtc"))
    out_j, logs_j = mt.simulate(js, sim_j, N_STEPS, key, loggers=lj,
                                run_loggers=run_loggers)
    noise = jax_noise_sequence(key, N_STEPS, (js.n_atoms, 3))
    out_p, _, _, logs_p = pt.simulate(ps, sim_p, N_STEPS,
                                      noise=noise.__getitem__, loggers=lp,
                                      run_loggers=run_loggers)
    np.testing.assert_allclose(np64(out_p.coords), np64(out_j.coords),
                               rtol=0, atol=1e-7)
    first = 5 if run_loggers == "skipstart" else 0
    for name in lj:
        if name == "corr":
            a_j, b_j = logs_j[name]
            a_p, b_p = logs_p[name]
            assert max_rel(a_j, a_p) < REL and max_rel(b_j, b_p) < REL
            continue
        got, want = logs_p[name], np64(logs_j[name])
        assert got.shape[0] == want.shape[0], name
        if name == "traj":
            assert got.tolist() == list(range(first, N_STEPS + 1, 5))
            continue
        assert max_rel(want, got) < REL, name
    assert logs_p["P"].shape[0] == (2 if run_loggers == "skipstart" else 3)
    assert float(lp["mean_v2"].average) == pytest.approx(
        float(lj["mean_v2"].average), rel=REL)
    with open(tmp_path / "jax.xtc", "rb") as fj, \
            open(tmp_path / "port.xtc", "rb") as fp:
        assert fp.read() == fj.read()
    frames = pt.read_xtc_coords(str(tmp_path / "port.xtc"))
    np.testing.assert_allclose(frames[-1], np64(out_p.coords), rtol=0,
                               atol=6e-4)


def test_simulate_with_loggers_keeps_the_trajectory(start):
    """Loggers do not change what simulate computes: the run without them
    ends where the logged run ends, bit for bit."""
    _, ps = start
    sim = pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)
    outs = []
    for loggers in (None, {"P": pt.ScalarPressureLogger(5)}):
        gen = torch.Generator().manual_seed(4)
        out = pt.simulate(ps, sim, N_STEPS, generator=gen, loggers=loggers)
        outs.append(out[0].coords)
    assert torch.equal(outs[0], outs[1])


def _frames(n=40, n_frames=3, seed=3):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 2.4, (n_frames, n, 3)), rng.normal(size=(n, 3))


@functools.lru_cache(maxsize=None)
def _atom_data():
    """The 64-water box's AtomData from each package's system_from_pdb."""
    from mollytpu.models.setup import system_from_pdb as jax_from_pdb
    from torch_parity import box_path, port_system
    js = jax_from_pdb(box_path("tiny64"), mt.ForceField(pt.TIP3P_XML),
                      dtype=jnp.float64, build_cache=False)
    return js.atom_data, port_system("tiny64").atom_data


@pytest.mark.parametrize("fmt", ["pdb", "xyz", "trr", "mol2", "dcd", "xtc",
                                 "pdb-atom_data", "xyz-atom_data",
                                 "mol2-atom_data"])
@pytest.mark.parametrize("box", ["cube", "dodecahedron"])
def test_writers_match_jax_bytes_and_read_back(tmp_path, fmt, box):
    """Each writer's bytes equal the JAX package's, without names and (the
    -atom_data cases) with each package's AtomData of the 64-water box."""
    fmt, _, named = fmt.partition("-")
    jad, pad = _atom_data() if named else (None, None)
    frames, vels = _frames(n=192 if named else 40)
    n = frames.shape[1]
    if box == "cube":
        jb = mt.rectangular(jnp.asarray([2.4, 2.5, 2.6]), dtype=jnp.float64)
        pb = pt.rectangular([2.4, 2.5, 2.6], dtype=torch.float64, device=CPU)
    else:
        angles = [math.radians(a) for a in pt.DODECAHEDRON]
        jb = mt.boundary.triclinic_from_lengths_angles((2.4,) * 3, angles,
                                                       dtype=jnp.float64)
        pb = pt.triclinic_from_lengths_angles((2.4,) * 3, angles,
                                              dtype=torch.float64,
                                              device=CPU)
    jw = jax_traj.TrajectoryWriter(10, str(tmp_path / f"jax.{fmt}"),
                                   atom_data=jad)
    pw = pt.TrajectoryWriter(10, str(tmp_path / f"port.{fmt}"),
                             atom_data=pad)
    for t, x in enumerate(frames):
        js = mt.System(atoms=mt.make_atoms(n=n, dtype=jnp.float64),
                       coords=jnp.asarray(x), boundary=jb,
                       velocities=jnp.asarray(vels))
        ps = pt.System(atoms=pt.make_atoms(n=n, dtype=torch.float64,
                                           device=CPU),
                       coords=torch.as_tensor(x), boundary=pb,
                       velocities=torch.as_tensor(vels))
        assert pw.observe(ps, None, None, 10 * t) == jw.observe(
            js, None, None, 10 * t)
    with open(tmp_path / f"jax.{fmt}", "rb") as fj, \
            open(tmp_path / f"port.{fmt}", "rb") as fp:
        assert fp.read() == fj.read()
    if fmt == "mol2":
        return
    path = str(tmp_path / f"port.{fmt}")
    readers = {"pdb": "read_pdb_frames", "xyz": "read_xyz_frames",
               "trr": "read_trr_frames", "dcd": "read_dcd_frames",
               "xtc": "read_xtc_coords"}
    got = getattr(trajectory, readers[fmt])(path)
    np.testing.assert_array_equal(got, getattr(jax_traj, readers[fmt])(path))
    assert got.shape == frames.shape
    np.testing.assert_allclose(got, frames, rtol=0, atol=6e-4)
    ens = pt.EnsembleSystem.from_file(ps, path)
    assert len(ens) == 3
    assert torch.equal(ens.frame(2).coords,
                       torch.as_tensor(got[2], dtype=torch.float64))


def test_xtc_codec_matches_jax_on_a_water_box(tmp_path):
    """Two frames of the 512-water box (1,536 atoms, runs of near atoms as
    in water) through the JAX codec and the port's: the same bytes, and
    each reader decodes the other's file to the same coordinates."""
    from mollytpu.utils import xtc as jax_xtc
    from mollytpu_torch.utils import xtc
    from torch_parity import port_system
    ps = port_system("liquid512")
    x = np64(ps.coords).astype(np.float32)
    box = np64(ps.boundary.box_matrix()).astype(np.float32)
    frames = (x, x + np.float32(0.01))
    paths = {}
    for name, codec in (("jax", jax_xtc), ("port", xtc)):
        paths[name] = str(tmp_path / f"{name}.xtc")
        with open(paths[name], "wb") as f:
            for step, frame in enumerate(frames):
                codec.write_xtc_frame(f, frame, box, step, 0.0)
    with open(paths["jax"], "rb") as fj, open(paths["port"], "rb") as fp:
        assert fp.read() == fj.read()
    got = xtc.read_xtc_frames(paths["jax"])
    want = jax_xtc.read_xtc_frames(paths["port"])
    assert len(got) == len(want) == 2
    for (xg, *_), (xw, *_), frame in zip(got, want, frames):
        np.testing.assert_array_equal(xg, xw)
        np.testing.assert_allclose(xg, frame, rtol=0, atol=6e-4)


@pytest.mark.parametrize("name", ["langevin", "nose_hoover"])
def test_checkpoint_resume_is_bit_exact(start, tmp_path, name):
    """20 steps in one run against 10, a checkpoint, a load into the
    starting system and 10 more from step 10 (a rebuild step), with the
    generator's draws and the integrator's state carried."""
    _, ps = start
    sim = (pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)
           if name == "langevin" else pt.NoseHoover(dt=DT, temperature=TEMP))
    full, _, _ = pt.simulate(ps, sim, 20,
                             generator=torch.Generator().manual_seed(8))
    gen = torch.Generator().manual_seed(8)
    half, _, aux = pt.simulate(ps, sim, 10, generator=gen)
    path = str(tmp_path / "state.npz")
    pt.save_checkpoint(path, half, 10, gen, aux=aux)
    state = gen.get_state()
    loaded, step_n, gen2, extra = pt.load_checkpoint(path, ps)
    assert step_n == 10 and torch.equal(gen2.get_state(), state)
    assert torch.equal(loaded.coords, half.coords)
    resumed, _, _ = pt.simulate(loaded, sim, 10, generator=gen2,
                                aux=extra["aux"], init_step=step_n)
    assert torch.equal(resumed.coords, full.coords)
    assert torch.equal(resumed.velocities, full.velocities)


def test_checkpoint_keeps_a_triclinic_box(tmp_path):
    basis = [[2.0, 0.0, 0.0], [0.5, 1.9, 0.0], [0.3, 0.4, 1.8]]
    box = pt.triclinic(basis, dtype=torch.float64, device=CPU,
                       approx_images=False)
    sys = pt.System(atoms=pt.make_atoms(n=4, dtype=torch.float64,
                                        device=CPU),
                    coords=torch.rand(4, 3, dtype=torch.float64), boundary=box)
    path = str(tmp_path / "tri.npz")
    pt.save_checkpoint(path, sys, 3, extra={"note": np.arange(3)})
    out, step_n, gen, extra = pt.load_checkpoint(path, sys)
    assert step_n == 3 and gen is None
    assert torch.equal(out.boundary.basis, box.basis)
    assert out.boundary.approx_images is False
    np.testing.assert_array_equal(extra["note"], np.arange(3))


def test_analysis_matches_jax():
    rng = np.random.default_rng(12)
    x, y = rng.uniform(0, 2.0, (30, 3)), rng.uniform(0, 2.0, (30, 3))
    m, q = rng.uniform(1, 16, 30), rng.uniform(-1, 1, 30)
    series = rng.normal(size=(6, 30, 3))
    angles = [math.radians(a) for a in (92.0, 95.0, 88.0)]
    jb = mt.boundary.triclinic_from_lengths_angles((2.0, 2.1, 2.2), angles,
                                                   dtype=jnp.float64)
    pb = pt.triclinic_from_lengths_angles((2.0, 2.1, 2.2), angles,
                                          dtype=torch.float64, device=CPU)
    X, Y = torch.as_tensor(x), torch.as_tensor(y)
    a = mt.analysis
    pairs = [
        (a.displacements(x, y, jb), pt.displacements(X, Y, pb)),
        (a.distances(x, jb), pt.distances(X, pb)),
        (a.rmsd(x, y), pt.rmsd(X, Y)),
        (a.radius_gyration(x, m), pt.radius_gyration(X, torch.as_tensor(m))),
        (a.hydrodynamic_radius(x, jb), pt.hydrodynamic_radius(X, pb)),
        (a.dipole_moment(x, q), pt.dipole_moment(X, torch.as_tensor(q))),
        (a.msd(series), pt.msd(torch.as_tensor(series))),
        (mt.autocorrelation(series[:, :, 0]),
         pt.autocorrelation(torch.as_tensor(series[:, :, 0]))),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(np64(got), np64(want), rtol=1e-10,
                                   atol=1e-12)
    c_j, g_j = a.rdf(x, jb, n_bins=20)
    c_p, g_p = pt.rdf(X, pb, n_bins=20)
    np.testing.assert_allclose(c_p, np64(c_j), rtol=1e-10)
    np.testing.assert_allclose(g_p, np64(g_j), rtol=1e-10)


def test_visualize_matches_jax(tmp_path):
    frames, _ = _frames(n=20, n_frames=2)
    box = pt.rectangular([2.4, 2.5, 2.6], dtype=torch.float64, device=CPU)
    jbox = mt.rectangular(jnp.asarray([2.4, 2.5, 2.6]), dtype=jnp.float64)
    assert np.array_equal(
        pt.render_frame(torch.as_tensor(frames[0]), box, size=64),
        mt.render_frame(frames[0], jbox, size=64))
    for name, m, b in (("port", pt, box), ("jax", mt, jbox)):
        m.visualize(frames, str(tmp_path / f"{name}.gif"), b, size=48)
    assert os.path.getsize(tmp_path / "port.gif") > 0
    with open(tmp_path / "jax.gif", "rb") as fj, \
            open(tmp_path / "port.gif", "rb") as fp:
        assert fp.read() == fj.read()
