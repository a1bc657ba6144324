"""The cell-list kernel (csrc/cell_neighbors.cu) against its plain twin
(CellListNeighborFinder.find_plain) on the same card tensors, in float32
and float64: the same idx, special and overflow element for element, on
in.lj melted for 200 steps, a fluid with exclusions and 1-4 pairs in an
orthorhombic and a triclinic box, a grid of 2 cells and 1 cell on an
axis, a row over K and cells over their capacity; one launch per find, no
blocking runtime call inside find, and a capacity whose stage outgrows
shared memory refused. Every test needs a CUDA card and skips without
one (the kernel has no CPU mode). It imports neither JAX nor the JAX
package, so it runs on a card host without them:

    python -m pytest --noconftest -q tests/test_torch_cell_neighbors_cuda.py
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import mollytpu_torch as pt
from mollytpu_torch.models import ljbench
from mollytpu_torch.ops import native
from mollytpu_torch.ops import neighbors as nb_mod

RADIUS = 0.6

#: (lengths in nm, angles in degrees): 4 x 3 x 2 cells at RADIUS, a
#: 92/97/86 degree cell of 4 x 4 x 4, and 4 x 2 x 1
BOXES = {"ortho": ((2.5, 2.0, 1.3), (90.0, 90.0, 90.0)),
         "triclinic": ((2.5, 2.5, 2.5), (92.0, 97.0, 86.0)),
         "thin": ((2.5, 1.3, 0.7), (90.0, 90.0, 90.0))}

CASES = ("lj-32000-melted", "fluid-ortho", "fluid-triclinic", "thin-grid",
         "row-over-k", "cell-over-capacity")


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


def fluid(name, dtype, dev, n=300, seed=4):
    """n atoms uniform in the box, with chains of exclusions (i, i+1),
    (i, i+2) and 1-4 pairs (i, i+3), some far apart in index (the fluid
    of tests/test_torch_neighbors.py, built by the port)."""
    rng = np.random.default_rng(seed)
    lengths, angles = BOXES[name]
    if angles == (90.0, 90.0, 90.0):
        box = pt.rectangular(lengths, dtype=dtype, device=dev)
    else:
        box = pt.triclinic_from_lengths_angles(
            lengths, np.radians(angles), dtype=dtype, device=dev)
    coords = box.from_fractional(torch.as_tensor(
        rng.uniform(0.0, 1.0, (n, 3)), dtype=dtype, device=dev))
    excl = ([(i, i + 1) for i in range(0, 120)]
            + [(i, i + 2) for i in range(0, 120)] + [(3, 250), (7, 299)])
    spec = [(i, i + 3) for i in range(0, 120)] + [(11, 280)]
    return coords, box, pt.Exclusions.build(n, excl, spec, device=dev)


@functools.lru_cache(maxsize=None)
def melted_lj(dtype):
    """in.lj at 20^3 fcc cells (32,000 atoms) after 200 steps of NVE from
    its lattice, the benchmark's integrator, and its finder rebuilt every
    5 steps as the benchmark's cell does (at in.lj's 20 the exact stale
    check stops the run)."""
    dev = card()
    sys = ljbench.lj_bench_system(20, dtype, dev, seed=16, n_steps=5)
    sim = ljbench.lj_bench_integrator()
    nb = pt.find_neighbors(sys.neighbor_finder, sys.coords, sys.boundary,
                           sys.exclusions, 0)
    aux = sim.init_aux(sys, nb)
    sys, _, _, _ = pt.run_chunk(sim, sys, nb, aux, 0, 200)
    return sys


def case_inputs(case, dtype):
    """(finder, coords, box, exclusions) of a case on the card."""
    dev = card()
    if case == "lj-32000-melted":
        sys = melted_lj(dtype)
        return sys.neighbor_finder, sys.coords, sys.boundary, sys.exclusions
    name = {"fluid-triclinic": "triclinic", "thin-grid": "thin"}.get(
        case, "ortho")
    coords, box, excl = fluid(name, dtype, dev)
    finder = pt.CellListNeighborFinder.setup(box, RADIUS, coords.shape[0])
    if case == "row-over-k":
        finder = dataclasses.replace(finder, max_neighbors=6)
    if case == "cell-over-capacity":
        # 3 of the 24 cells hold 17-19 atoms; the last cell holds 10. The
        # twin scatters the atoms past their cell's capacity into the
        # table's last slot, so its table is defined only where the last
        # cell is below the capacity
        finder = dataclasses.replace(finder, cell_capacity=16)
    return finder, coords, box, excl


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64),
                         ids=("f32", "f64"))
@pytest.mark.parametrize("case", CASES)
def test_kernel_table_equals_the_twin(case, dtype):
    finder, coords, box, excl = case_inputs(case, dtype)
    before = native.LAUNCHES["cell_neighbors"]
    got = finder.find(coords, box, excl, 4)
    assert native.LAUNCHES["cell_neighbors"] == before + 1
    want = finder.find_plain(coords, box, excl, 4)
    torch.cuda.synchronize()
    assert got.idx.dtype == torch.int32 and got.special.dtype == torch.bool
    assert got.idx.shape == want.idx.shape == (coords.shape[0],
                                               finder.max_neighbors)
    assert got.overflow.dtype == torch.int32 and got.overflow.dim() == 0
    assert got.step_built == 4
    assert torch.equal(got.idx, want.idx)
    assert torch.equal(got.special, want.special)
    over = int(got.overflow)
    assert over == int(want.overflow)
    n = coords.shape[0]
    listed = int((got.idx < n).sum())
    if case == "row-over-k":
        assert over > 0
    elif case == "cell-over-capacity":
        assert over >= 6   # the cells' excess alone is 1 + 2 + 3
    else:
        assert over == 0
        assert listed > 3 * n
    if case.startswith("fluid"):
        assert bool(got.special.any())


def test_find_makes_no_blocking_call():
    """find queues its work and returns: no runtime call inside it waits
    for the card (torch.cuda.set_sync_debug_mode raises on one), on a
    new box and finder, with exclusions and without."""
    dev = card()
    finder, coords, box, excl = case_inputs("fluid-ortho", torch.float32)
    finder.find(coords, box, excl)   # builds and loads the library
    cases = [fluid("triclinic", torch.float64, dev),
             fluid("ortho", torch.float32, dev)]
    cases.append((cases[1][0], cases[1][1], pt.Exclusions.empty(
        300, device=dev)))
    finders = [pt.CellListNeighborFinder.setup(b, RADIUS, 300)
               for _, b, _ in cases]
    before = native.LAUNCHES["cell_neighbors"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        tables = [f.find(c, b, x) for f, (c, b, x) in zip(finders, cases)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert native.LAUNCHES["cell_neighbors"] == before + 3
    assert nb_mod.find_engine(finders[0], cases[0][0]) == "cuda"
    for f, (c, b, x), t in zip(finders, cases, tables):
        assert torch.equal(t.idx, f.find_plain(c, b, x).idx)


def test_capacity_past_shared_memory_is_refused():
    finder, coords, box, excl = case_inputs("fluid-ortho", torch.float64)
    big = dataclasses.replace(finder, cell_capacity=2000)
    before = native.LAUNCHES["cell_neighbors"]
    with pytest.raises(ValueError, match="shared memory"):
        big.find(coords, box, excl)
    assert native.LAUNCHES["cell_neighbors"] == before
