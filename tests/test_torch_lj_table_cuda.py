"""The Lennard-Jones table kernel (csrc/lj_table.cu) against the autograd
engine it replaces on the card (neighbor_forces_plain), on the same card
tensors, in float32 and float64: forces and virial on in.lj melted a few
steps, on that frame's fractional coordinates in a skewed triclinic box,
and on a fluid with mixed sigma and epsilon, atoms of zero epsilon and of
zero lambda, 1-4 pairs under weight_special 0.5 and one open axis; one
launch per call, none for the calls the dispatch rule refuses, and no
blocking runtime call inside a call. Every test needs a CUDA card and
skips without one (the kernel has no CPU mode). It imports neither JAX
nor the JAX package, so it runs on a card host without them:

    python -m pytest --noconftest -q tests/test_torch_lj_table_cuda.py

Tolerances. Both sides take r^2, r and the cutoff test through the same
rounded operations, so they list the same pairs inside the cutoff; the
force arithmetic differs (the closed form against autograd through
pow), and so does the order of the sums (atomics on both sides). So
the forces agree to a few rounding errors of the largest pair force of a
row, summed over its ~30 pairs: max|dF| within F_TOL of rms|F| (f32: ~20
ulps of the largest pair force, ~8x rms|F| in the melted liquid, over
sqrt(60) sums; f64 alike at its epsilon); the virial within V_TOL of its
largest element (the engine sums 10^4-10^5 float32 products in float32,
the kernel in float64 per block).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import mollytpu_torch as pt
from mollytpu_torch.models import ljbench
from mollytpu_torch.ops import native
from mollytpu_torch.ops import nonbonded as tnb

F_TOL = {torch.float32: 2e-5, torch.float64: 1e-12}
V_TOL = {torch.float32: 2e-5, torch.float64: 1e-12}
DTYPES = (torch.float32, torch.float64)
FRAMES = ("in.lj-melted", "in.lj-triclinic", "mixed-open-axis")
#: the skewed box's angles alpha, beta, gamma (degrees)
ANGLES = (80.0, 95.0, 100.0)
LJ_CELLS = 12            # 6,912 atoms
RC = 0.8
LIST = 0.95


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread per test, as the parity tests run under xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def melted_lj(dtype):
    """in.lj at LJ_CELLS^3 fcc cells after 20 NVE steps from its lattice
    (a rebuild every 5), and its table."""
    dev = card()
    sys = ljbench.lj_bench_system(LJ_CELLS, dtype, dev, seed=18, n_steps=5)
    sim = ljbench.lj_bench_integrator()
    nb = pt.find_neighbors(sys.neighbor_finder, sys.coords, sys.boundary,
                           sys.exclusions, 0)
    sys, nb, _, _ = pt.run_chunk(sim, sys, nb, sim.init_aux(sys, nb), 0, 20)
    return sys.pairwise_inters, sys.atoms, sys.coords, sys.boundary, nb


@functools.lru_cache(maxsize=None)
def triclinic_lj(dtype):
    """The melted in.lj frame's fractional coordinates in a triclinic box
    of its side lengths at ANGLES, and a table of the same radius found
    there (pairs across the box take the skewed minimum image)."""
    inters, atoms, coords, box, nb = melted_lj(dtype)
    side = float(box.side_lengths[0])
    tri = pt.triclinic_from_lengths_angles(
        (side,) * 3, np.radians(ANGLES), dtype=dtype, device=coords.device)
    frac = box.fractional(coords)
    coords = tri.from_fractional(frac - torch.floor(frac))
    n = coords.shape[0]
    nb = pt.DistanceNeighborFinder(LIST, max_neighbors=nb.idx.shape[1]).find(
        coords, tri, pt.Exclusions.build(n, device=coords.device))
    assert int(nb.overflow) == 0
    return inters, atoms, coords, tri, nb


@functools.lru_cache(maxsize=None)
def mixed_fluid(dtype):
    """10 x 10 x 8 atoms on a jittered 0.36 nm lattice, periodic in x and
    y and open in z, with sigma and epsilon per atom, 5% of the atoms at
    epsilon 0 and 5% at lambda 0, bonded neighbours along x excluded or
    1-4 in turn, and LennardJones with weight_special 0.5."""
    dev = card()
    rng = np.random.default_rng(18)
    grid = np.stack(np.meshgrid(np.arange(10), np.arange(10), np.arange(8),
                                indexing="ij"), axis=-1).reshape(-1, 3)
    x = (grid + rng.uniform(-0.08, 0.08, grid.shape)) * 0.36
    n = x.shape[0]
    eps = rng.uniform(0.5, 1.5, n)
    eps[rng.choice(n, n // 20, replace=False)] = 0.0
    lam = np.ones(n)
    lam[rng.choice(n, n // 20, replace=False)] = 0.0
    atoms = pt.make_atoms(n=n, mass=40.0, sigma=rng.uniform(0.30, 0.36, n),
                          epsilon=eps, lam=lam, dtype=dtype, device=dev)
    box = pt.rectangular((3.6, 3.6, float("inf")), dtype=dtype, device=dev)
    # atom 80 i + 8 j + k sits at (i, j, k): its x neighbour is 80 on
    bonds = [(a, a + 80) for a in range(0, n - 80, 3)]
    excl = pt.Exclusions.build(n, bonds[0::2], bonds[1::2], device=dev)
    coords = torch.as_tensor(x, dtype=dtype, device=dev)
    nb = pt.DistanceNeighborFinder(LIST, max_neighbors=64).find(
        coords, box, excl)
    assert int(nb.overflow) == 0 and bool(nb.special.any())
    lj = pt.LennardJones(cutoff=pt.DistanceCutoff(RC), use_neighbors=True,
                         weight_special=0.5)
    return (lj,), atoms, coords, box, nb


def frame(name, dtype):
    return {"in.lj-melted": melted_lj, "in.lj-triclinic": triclinic_lj,
            "mixed-open-axis": mixed_fluid}[name](dtype)


@pytest.mark.parametrize("needs_virial", (False, True),
                         ids=("forces", "virial"))
@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "f64"))
@pytest.mark.parametrize("name", FRAMES)
def test_kernel_equals_the_engine(name, dtype, needs_virial):
    inters, atoms, coords, box, nb = frame(name, dtype)
    assert tnb.lj_table_admits(inters, atoms, coords, box, nb)
    before = native.LAUNCHES["lj_table"]
    f, v = tnb.neighbor_forces(inters, atoms, coords, box, nb,
                               needs_virial=needs_virial)
    assert native.LAUNCHES["lj_table"] == before + 1
    f0, v0 = tnb.neighbor_forces_plain(inters, atoms, coords, box, nb,
                                       needs_virial=needs_virial)
    torch.cuda.synchronize()
    assert f.dtype == v.dtype == dtype and f.shape == coords.shape
    rms = float(f0.double().pow(2).sum(dim=1).mean().sqrt())
    df = float((f.double() - f0.double()).abs().max()) / rms
    assert rms > 0 and df <= F_TOL[dtype], df
    if needs_virial:
        scale = float(v0.double().abs().max())
        dv = float((v.double() - v0.double()).abs().max()) / scale
        assert scale > 0 and dv <= V_TOL[dtype], dv
    else:
        assert not bool(v.any())


def test_mixed_frame_skips_the_pairs_without_interaction():
    """Atoms of zero epsilon or zero lambda feel no force: the rows and
    columns that hold them add nothing."""
    inters, atoms, coords, box, nb = mixed_fluid(torch.float64)
    f, _ = tnb.neighbor_forces(inters, atoms, coords, box, nb)
    off = (atoms.epsilon == 0) | (atoms.lam == 0)
    assert bool(off.any()) and not bool(f[off].any())
    assert bool(f[~off].abs().sum(dim=1).gt(0).all())


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "f64"))
def test_a_pair_at_the_cutoff_takes_the_engines_half_force(dtype):
    """A pair at r == rc in the working type: DistanceCutoff's
    minimum(r, rc) has two derivatives there and autograd takes their
    mean, so the engine gives half the pair's force, and so must the
    kernel. A pair just inside gets all of it, just outside none."""
    dev = card()
    rc = torch.tensor(RC, dtype=dtype)
    inside, outside = (float(rc.nextafter(torch.tensor(to, dtype=dtype)))
                       for to in (0.0, 1.0))
    # dx = x_j - 0 is exact, and sqrt(fl(dx^2)) == dx in binary floating
    # point, so the three pairs lie at rc, just inside and just outside
    xs = [[0.0, 0.5, 0.5], [float(rc), 0.5, 0.5], [0.0, 1.6, 0.5],
          [inside, 1.6, 0.5], [0.0, 2.7, 0.5], [outside, 2.7, 0.5]]
    coords = torch.tensor(xs, dtype=dtype, device=dev)
    box = pt.cubic(8.0, dtype=dtype, device=dev)
    atoms = pt.make_atoms(n=6, mass=40.0, sigma=0.34, epsilon=1.0,
                          dtype=dtype, device=dev)
    excl = pt.Exclusions.build(6, device=dev)
    nb = pt.DistanceNeighborFinder(LIST, max_neighbors=8).find(coords, box,
                                                                excl)
    inters = (pt.LennardJones(cutoff=pt.DistanceCutoff(RC),
                              use_neighbors=True),)
    f, _ = tnb.neighbor_forces(inters, atoms, coords, box, nb)
    f0, _ = tnb.neighbor_forces_plain(inters, atoms, coords, box, nb)
    full = float(f0[2:4, 0].abs().max())
    assert full > 0 and not bool(f0[4:].any())
    assert float(f0[0, 0].abs()) == pytest.approx(0.5 * full, rel=1e-3)
    assert float((f - f0).abs().max()) <= 1e-5 * full


def _refused(name, dtype):
    inters, atoms, coords, box, nb = melted_lj(dtype)
    (lj,) = inters
    if name == "coulomb":
        inters = (lj, pt.CoulombReactionField(dist_cutoff=0.85,
                                              use_neighbors=True))
    elif name == "shifted-force":
        inters = (dataclasses.replace(lj, cutoff=pt.ShiftedForceCutoff(
            0.85)),)
    elif name == "grad-box":
        box = pt.Orthorhombic(box.side_lengths.clone().requires_grad_())
    elif name == "grad-epsilon":
        atoms = dataclasses.replace(
            atoms, epsilon=atoms.epsilon.clone().requires_grad_())
    return inters, atoms, coords, box, nb


@pytest.mark.parametrize("name", ("coulomb", "shifted-force", "grad-box",
                                  "grad-epsilon"))
def test_refused_calls_launch_nothing(name):
    inters, atoms, coords, box, nb = _refused(name, torch.float32)
    assert not tnb.lj_table_admits(inters, atoms, coords, box, nb)
    before = native.LAUNCHES["lj_table"]
    f, _ = tnb.neighbor_forces(inters, atoms, coords, box, nb,
                               needs_virial=True)
    torch.cuda.synchronize()
    assert native.LAUNCHES["lj_table"] == before
    assert bool(torch.isfinite(f).all())
    # the engine keeps the graph of a gradient-tracking input
    assert f.requires_grad == name.startswith("grad-")


def test_a_call_makes_no_blocking_runtime_call():
    inters, atoms, coords, box, nb = melted_lj(torch.float32)
    tnb.neighbor_forces(inters, atoms, coords, box, nb, needs_virial=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for needs_virial in (False, True):
            tnb.neighbor_forces(inters, atoms, coords, box, nb,
                                needs_virial=needs_virial)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
