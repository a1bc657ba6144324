"""The stale-list check's kernel (csrc/table_check.cu) against its plain
twin (missing_min_distance_plain) on the same card tensors, in float32 and
float64: the same scalar bit for bit on a fluid in an orthorhombic and a
triclinic box with tables of other widths (old tables wider than a
lane loads at once, and wide enough for fewer warps a block, among
them), an old table of sentinels only, a table
checked against itself, a planted missing pair, a pair exactly at the
cutoff, and in.lj's 32,000-atom tables; one launch per check, one per
neighbor-table check of run_chunk, no blocking runtime call inside a
check, a stale table raising StaleNeighborList on the card, and inputs the
kernel does not take refused. Every test needs a CUDA card and skips
without one (the kernel has no CPU mode). It imports neither JAX nor the
JAX package, so it runs on a card host without them:

    python -m pytest --noconftest -q tests/test_torch_table_check_cuda.py
"""

import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

import mollytpu_torch as pt
from mollytpu_torch.models import ljbench
from mollytpu_torch.ops import native
from mollytpu_torch.sim import simulate
from mollytpu_torch.sim.simulate import (missing_min_distance,
                                         missing_min_distance_plain)

RADIUS, CUTOFF = 0.6, 0.5

#: (lengths in nm, angles in degrees): the fluids of
#: tests/test_torch_cell_neighbors_cuda.py
BOXES = {"ortho": ((2.5, 2.0, 1.3), (90.0, 90.0, 90.0)),
         "triclinic": ((2.5, 2.5, 2.5), (92.0, 97.0, 86.0))}

#: case -> whether the check finds a missing pair
CASES = {"narrower-old": True, "wider-old": True, "widest-old": True,
         "triclinic": True, "sentinels-only": True, "self": False,
         "planted": True, "at-cutoff": False, "lj-32000-start": True,
         "lj-32000-rebuild": False}


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


def box_of(name, dtype, dev):
    lengths, angles = BOXES[name]
    if angles == (90.0, 90.0, 90.0):
        return pt.rectangular(lengths, dtype=dtype, device=dev)
    return pt.triclinic_from_lengths_angles(lengths, np.radians(angles),
                                            dtype=dtype, device=dev)


def fluid(name, dtype, dev, n=300, seed=4):
    """n atoms uniform in the box and the same atoms moved up to 0.1 nm
    per axis (seeded numpy), with no exclusions."""
    rng = np.random.default_rng(seed)
    box = box_of(name, dtype, dev)
    f = rng.uniform(0.0, 1.0, (n, 3))
    coords = box.from_fractional(torch.as_tensor(f, dtype=dtype, device=dev))
    moved = box.wrap(coords + torch.as_tensor(
        rng.uniform(-0.1, 0.1, (n, 3)), dtype=dtype, device=dev))
    return coords, moved, box, pt.Exclusions.empty(n, device=dev)


def table(radius, width, coords, box, excl):
    return pt.find_neighbors(pt.DistanceNeighborFinder(radius, 1, width),
                             coords, box, excl)


@functools.lru_cache(maxsize=None)
def lj_frames(dtype):
    """in.lj at 20^3 fcc cells (32,000 atoms): its lattice start, the
    frame after 198 NVE steps of the benchmark's integrator with its finder
    rebuilt every 5 steps, and the table of the last rebuild (step 195)."""
    dev = card()
    start = ljbench.lj_bench_system(20, dtype, dev, seed=16, n_steps=5)
    sim = ljbench.lj_bench_integrator()
    nb = pt.find_neighbors(start.neighbor_finder, start.coords,
                           start.boundary, start.exclusions, 0)
    end, last, _, _ = pt.run_chunk(sim, start, nb, sim.init_aux(start, nb),
                                   0, 198)
    return start, end, last


def case_inputs(case, dtype):
    """(old table, new table, coords, box, cutoff) of a case on the card."""
    dev = card()
    if case.startswith("lj-32000"):
        start, end, last = lj_frames(dtype)
        new = pt.find_neighbors(end.neighbor_finder, end.coords,
                                end.boundary, end.exclusions)
        old = (pt.find_neighbors(start.neighbor_finder, start.coords,
                                 start.boundary, start.exclusions)
               if case == "lj-32000-start" else last)
        return old, new, end.coords, end.boundary, ljbench.CUTOFF
    if case in ("planted", "at-cutoff"):
        return planted(case, dtype, dev)
    coords, moved, box, excl = fluid(
        "triclinic" if case == "triclinic" else "ortho", dtype, dev)
    new = table(RADIUS, 64, coords, box, excl)
    if case == "self":
        return new, new, coords, box, CUTOFF
    if case == "sentinels-only":
        old = dataclasses.replace(new, idx=torch.full(
            (coords.shape[0], 7), coords.shape[0], dtype=torch.int32,
            device=dev))
    elif case in ("wider-old", "widest-old"):
        # 200 slots: more than a lane loads at once; 3,000: sets of 8,192
        # slots, so that a block holds fewer than 8 warps
        old = table(RADIUS, 200 if case == "wider-old" else 3000, moved,
                    box, excl)
    else:
        old = table(0.45, 40, moved, box, excl)
    return old, new, coords, box, CUTOFF


def planted(case, dtype, dev):
    """Atoms on a 2 nm grid in an 8 nm cube (no pair inside the cutoff
    0.7) and atom 1 moved next to atom 0, along x: 0.3 nm away, or exactly
    the cutoff rounded to the working type, which r < cutoff leaves out;
    the old table holds nothing."""
    cutoff = 0.7
    g = 2.0 * torch.arange(4, dtype=dtype, device=dev)
    coords = torch.stack(torch.meshgrid(g, g, g, indexing="ij"),
                         dim=-1).reshape(-1, 3)
    gap = 0.3 if case == "planted" else float(
        torch.tensor(cutoff, dtype=dtype))
    coords[1] = torch.tensor([gap, 0.0, 0.0], dtype=dtype, device=dev)
    box = pt.cubic(8.0, dtype=dtype, device=dev)
    excl = pt.Exclusions.empty(coords.shape[0], device=dev)
    new = table(0.8, 16, coords, box, excl)
    old = dataclasses.replace(new, idx=torch.full_like(new.idx,
                                                       coords.shape[0]))
    return old, new, coords, box, cutoff


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64),
                         ids=("f32", "f64"))
@pytest.mark.parametrize("case", CASES)
def test_kernel_scalar_equals_the_twin_bit_for_bit(case, dtype):
    old, new, coords, box, cutoff = case_inputs(case, dtype)
    before = native.LAUNCHES["table_check"]
    got = missing_min_distance(old, new, coords, box, cutoff)
    assert native.LAUNCHES["table_check"] == before + 1
    want = missing_min_distance_plain(old, new, coords, box, cutoff)
    torch.cuda.synchronize()
    assert got.shape == () and got.dtype == dtype and got.is_cuda
    assert got.cpu().numpy().tobytes() == want.cpu().numpy().tobytes()
    assert math.isfinite(float(got)) == CASES[case]
    if CASES[case]:
        assert float(got) < cutoff
    if case == "planted":
        assert float(got) == pytest.approx(0.3, rel=1e-6)


def test_run_chunk_launches_one_per_check(monkeypatch):
    """23 steps at a rebuild every 5: four rebuilds and the end of the
    chunk, five checks of a neighbor table and five launches."""
    start, _, _ = lj_frames(torch.float32)
    sim = ljbench.lj_bench_integrator()
    nb = pt.find_neighbors(start.neighbor_finder, start.coords,
                           start.boundary, start.exclusions, 0)
    aux = sim.init_aux(start, nb)
    checks = []
    real = simulate.list_check

    def counting(*args, **kw):
        checks.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(simulate, "list_check", counting)
    before = native.LAUNCHES["table_check"]
    *_, closest = pt.run_chunk(sim, start, nb, aux, 0, 23)
    assert len(checks) == 5
    assert native.LAUNCHES["table_check"] - before == 5
    assert closest == float("inf")


class _Drift:
    """Moves every atom dx nm in a seeded random direction per step."""

    coupling = ()

    def __init__(self, dx):
        self.dx = dx

    def step(self, sys, neighbors, aux, step_n, generator=None,
             needs_virial=False):
        gen = torch.Generator().manual_seed(step_n)
        u = torch.randn(sys.coords.shape, generator=gen, dtype=torch.float64)
        u = (u / torch.linalg.vector_norm(u, dim=1, keepdim=True)).to(
            sys.coords)
        return sys.update(coords=sys.boundary.wrap(sys.coords + self.dx * u)
                          ), aux


def test_stale_table_raises_on_the_card():
    """The CPU test's fluid on the card (radius 0.6, cutoff 0.5, a rebuild
    every 5 steps): steps of 0.005 nm stay inside the skin, steps of 0.05
    nm leave pairs inside the cutoff out, and the check raises."""
    dev = card()
    coords, _, box, excl = fluid("ortho", torch.float64, dev)
    atoms = pt.make_atoms(n=coords.shape[0], mass=40.0, sigma=0.12,
                          epsilon=0.1, dtype=torch.float64, device=dev)
    sys = pt.System(atoms=atoms, coords=coords, boundary=box,
                    exclusions=excl, pairwise_inters=(pt.LennardJones(
                        cutoff=pt.DistanceCutoff(CUTOFF),
                        use_neighbors=True),),
                    neighbor_finder=pt.CellListNeighborFinder.setup(
                        box, RADIUS, coords.shape[0], n_steps=5))
    nb = pt.find_neighbors(sys.neighbor_finder, sys.coords, sys.boundary,
                           sys.exclusions)
    before = native.LAUNCHES["table_check"]
    *_, closest = pt.run_chunk(_Drift(0.005), sys, nb, {}, 0, 10)
    assert closest == float("inf")
    with pytest.raises(pt.StaleNeighborList, match="rebuild more often"):
        pt.run_chunk(_Drift(0.05), sys, nb, {}, 0, 10)
    assert native.LAUNCHES["table_check"] - before == 4


def test_check_makes_no_blocking_call():
    """A check queues its work and returns: no runtime call inside it
    waits for the card (torch.cuda.set_sync_debug_mode raises on one)."""
    old, new, coords, box, cutoff = case_inputs("narrower-old",
                                                torch.float32)
    missing_min_distance(old, new, coords, box, cutoff)  # loads the library
    old64, new64, c64, box64, _ = case_inputs("triclinic", torch.float64)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = (missing_min_distance(old, new, coords, box, cutoff),
               missing_min_distance(old64, new64, c64, box64, cutoff))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(got[0]) == float(missing_min_distance_plain(
        old, new, coords, box, cutoff))
    assert float(got[1]) == float(missing_min_distance_plain(
        old64, new64, c64, box64, cutoff))


def test_inputs_the_kernel_does_not_take_are_refused():
    old, new, coords, box, cutoff = case_inputs("narrower-old",
                                                torch.float32)
    before = native.LAUNCHES["table_check"]
    wide = dataclasses.replace(new, idx=new.idx.long())
    with pytest.raises(ValueError, match="int32"):
        missing_min_distance(old, wide, coords, box, cutoff)
    short = dataclasses.replace(old, idx=old.idx[:-1])
    with pytest.raises(ValueError, match="rows"):
        missing_min_distance(short, new, coords, box, cutoff)
    with pytest.raises(ValueError, match="cpu"):
        missing_min_distance(old, new, coords, box.to("cpu"), cutoff)
    with pytest.raises(TypeError, match="float32 or float64"):
        missing_min_distance(old, new, coords.half(), box, cutoff)
    huge = dataclasses.replace(old, idx=torch.full(
        (coords.shape[0], 16385), coords.shape[0], dtype=torch.int32,
        device=coords.device))
    with pytest.raises(ValueError, match="up to 16384 wide"):
        missing_min_distance(huge, new, coords, box, cutoff)
    assert native.LAUNCHES["table_check"] == before
