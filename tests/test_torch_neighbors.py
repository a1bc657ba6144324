"""The neighbor tables of the general pair path (ops/neighbors.py) against
the JAX package's, float64 on the CPU: DistanceNeighborFinder and
CellListNeighborFinder give the same idx and special tables element for
element (exclusions and 1-4 pairs, orthorhombic and triclinic boxes, a
grid of 2 cells on an axis), ``setup`` sizes the finder as JAX does with
and without coordinates, overflow is reported as JAX reports it and
raised by the simulation loop, and the loop's exact stale-list check
raises on a table made stale on purpose. The check's plain twin
(missing_min_distance_plain) gives a brute-force walk over all pairs'
answer in float32 and float64, and on the CPU the check takes the twin
and launches no kernel.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.ops.neighbors import find_neighbors as jax_find_neighbors

import mollytpu_torch as pt
from mollytpu_torch.boundary import pair_geometry
from mollytpu_torch.sim.simulate import (missing_min_distance,
                                         missing_min_distance_plain)
from torch_parity import CPU, np64, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RADIUS = 0.6

#: boxes (name -> lengths in nm, angles in degrees): a grid of 4 x 3 x 2
#: cells at RADIUS, and a 92/97/86 degree cell of 4 x 4 x 4
BOXES = {"ortho": ((2.5, 2.0, 1.3), (90.0, 90.0, 90.0)),
         "triclinic": ((2.5, 2.5, 2.5), (92.0, 97.0, 86.0))}


def _boxes(name):
    lengths, angles = BOXES[name]
    if angles == (90.0, 90.0, 90.0):
        return (mt.rectangular(lengths, dtype=jnp.float64),
                pt.rectangular(lengths, dtype=torch.float64, device=CPU))
    jb = mt.triclinic_from_lengths_angles(lengths, np.radians(angles),
                                          dtype=jnp.float64)
    return jb, pt.Triclinic(torch.as_tensor(np64(jb.basis)))


@functools.lru_cache(maxsize=None)
def fluid(name, n=300, seed=4):
    """n atoms uniform in the box (some closer than a bond), with chains
    of exclusions (i, i+1), (i, i+2) and 1-4 pairs (i, i+3), some of them
    far apart in index."""
    rng = np.random.default_rng(seed)
    jb, _ = _boxes(name)
    f = rng.uniform(0.0, 1.0, (n, 3))
    coords = np.asarray(jax.device_get(jb.from_fractional(jnp.asarray(f))))
    excl = ([(i, i + 1) for i in range(0, 120)]
            + [(i, i + 2) for i in range(0, 120)] + [(3, 250), (7, 299)])
    spec = [(i, i + 3) for i in range(0, 120)] + [(11, 280)]
    return coords, excl, spec


def inputs(name):
    coords, excl, spec = fluid(name)
    n = coords.shape[0]
    jb, tb = _boxes(name)
    return ((jnp.asarray(coords), jb, mt.Exclusions.build(n, excl, spec)),
            (torch.as_tensor(coords), tb,
             pt.Exclusions.build(n, excl, spec, device=CPU)))


def assert_same_table(jn, tn):
    np.testing.assert_array_equal(np.asarray(jn.idx), tn.idx.numpy())
    np.testing.assert_array_equal(np.asarray(jn.special), tn.special.numpy())
    assert int(jn.overflow) == int(tn.overflow)


@pytest.mark.parametrize("name", BOXES)
def test_distance_finder_table_matches_jax(name):
    (jc, jb, jx), (tc, tb, tx) = inputs(name)
    jn = jax_find_neighbors(mt.DistanceNeighborFinder(RADIUS, 10, 40), jc,
                            jb, jx, 7)
    tn = pt.find_neighbors(pt.DistanceNeighborFinder(RADIUS, 10, 40), tc, tb,
                           tx, 7)
    assert tn.step_built == 7 and int(tn.overflow) == 0
    assert bool(tn.special.any())
    assert_same_table(jn, tn)


@pytest.mark.parametrize("name", BOXES)
@pytest.mark.parametrize("with_coords", (False, True))
def test_cell_finder_setup_and_table_match_jax(name, with_coords):
    """setup sizes the grid, the capacity and the row width as JAX does
    (from the mean density, or from the configuration with trial builds),
    and find gives JAX's table."""
    (jc, jb, jx), (tc, tb, tx) = inputs(name)
    n = tc.shape[0]
    kw = dict(n_steps=5)
    jf = mt.CellListNeighborFinder.setup(
        jb, RADIUS, n, coords=jc if with_coords else None, **kw)
    tf = pt.CellListNeighborFinder.setup(
        tb, RADIUS, n, coords=tc if with_coords else None, **kw)
    for field in ("grid_dims", "n_steps", "max_neighbors", "cell_capacity"):
        assert getattr(tf, field) == getattr(jf, field), field
    if name == "ortho":
        assert 2 in tf.grid_dims
    jn = jax_find_neighbors(jf, jc, jb, jx, 0)
    tn = pt.find_neighbors(tf, tc, tb, tx, 0)
    assert int(tn.overflow) == 0
    assert_same_table(jn, tn)


def test_cell_and_distance_tables_hold_the_same_pairs():
    """Both finders list the same pairs in the same rows (the balanced
    ownership); the cell finder's rows follow the stencil's order."""
    (_, _, _), (tc, tb, tx) = inputs("ortho")
    n = tc.shape[0]
    a = pt.find_neighbors(pt.DistanceNeighborFinder(RADIUS, 1, 40), tc, tb,
                          tx)
    b = pt.find_neighbors(pt.CellListNeighborFinder.setup(tb, RADIUS, n), tc,
                          tb, tx)
    for row in range(n):
        sa = sorted(x for x in a.idx[row].tolist() if x < n)
        sb = sorted(x for x in b.idx[row].tolist() if x < n)
        assert sa == sb


def test_overflow_reported_as_jax():
    """A row width and a cell capacity too small: the same overflow count
    as JAX."""
    (jc, jb, jx), (tc, tb, tx) = inputs("ortho")
    for kw in (dict(max_neighbors=6), dict(cell_capacity=4),
               dict(max_neighbors=5, cell_capacity=5)):
        jf = mt.CellListNeighborFinder.setup(jb, RADIUS, 300, **kw)
        tf = pt.CellListNeighborFinder.setup(tb, RADIUS, 300, **kw)
        jn = jax_find_neighbors(jf, jc, jb, jx, 0)
        tn = pt.find_neighbors(tf, tc, tb, tx, 0)
        assert int(tn.overflow) > 0
        assert int(tn.overflow) == int(jn.overflow)
    jn = jax_find_neighbors(mt.DistanceNeighborFinder(RADIUS, 1, 6), jc, jb,
                            jx)
    tn = pt.find_neighbors(pt.DistanceNeighborFinder(RADIUS, 1, 6), tc, tb,
                           tx)
    assert_same_table(jn, tn)


def _lj_system(finder, name="ortho"):
    (_, _, _), (tc, tb, tx) = inputs(name)
    atoms = pt.make_atoms(n=tc.shape[0], mass=40.0, sigma=0.12,
                          epsilon=0.1, dtype=torch.float64, device=CPU)
    return pt.System(atoms=atoms, coords=tc, boundary=tb, exclusions=tx,
                     pairwise_inters=(pt.LennardJones(
                         cutoff=pt.DistanceCutoff(0.5), use_neighbors=True),),
                     neighbor_finder=finder)


def test_simulate_raises_on_overflow():
    """The loop raises the JAX package's RuntimeError at the end of the
    chunk when a table overflowed."""
    sys = _lj_system(pt.DistanceNeighborFinder(RADIUS, 5, 6))
    with pytest.raises(RuntimeError, match="neighbor finder overflow at "
                                           "step 5: neighbor list overflow"):
        pt.simulate(sys, pt.VelocityVerlet(dt=0.0001), 5)


class _Drift:
    """Moves every atom dx nm in a seeded random direction per step."""

    coupling = ()

    def __init__(self, dx):
        self.dx = dx

    def step(self, sys, neighbors, aux, step_n, generator=None,
             needs_virial=False):
        gen = torch.Generator().manual_seed(step_n)
        u = torch.randn(sys.coords.shape, generator=gen, dtype=torch.float64)
        u = u / torch.linalg.vector_norm(u, dim=1, keepdim=True)
        return sys.update(coords=sys.boundary.wrap(sys.coords + self.dx * u)
                          ), aux


def test_stale_table_fails_loudly():
    """A skin of 0.1 nm (radius 0.6, cutoff 0.5): 5 steps of 0.005 nm
    between rebuilds stay inside it; steps of 0.05 nm leave pairs inside
    the cutoff out of the old table, and the check at the rebuild raises.
    The check itself: a table built at the same coordinates misses
    nothing; a table of half the radius misses the closest left-out
    pair."""
    sys = _lj_system(pt.CellListNeighborFinder.setup(
        pt.rectangular((2.5, 2.0, 1.3), dtype=torch.float64, device=CPU),
        RADIUS, 300, n_steps=5))
    nb = pt.find_neighbors(sys.neighbor_finder, sys.coords, sys.boundary,
                           sys.exclusions)
    *_, closest = pt.run_chunk(_Drift(0.005), sys, nb, {}, 0, 10)
    assert closest == float("inf")
    with pytest.raises(pt.StaleNeighborList, match="rebuild more often"):
        pt.run_chunk(_Drift(0.05), sys, nb, {}, 0, 10)
    short = pt.find_neighbors(pt.DistanceNeighborFinder(0.25, 1, 40),
                              sys.coords, sys.boundary, sys.exclusions)
    assert float(missing_min_distance(nb, nb, sys.coords, sys.boundary,
                                      0.5)) == float("inf")
    d = float(missing_min_distance(short, nb, sys.coords, sys.boundary, 0.5))
    dr = sys.boundary.displacement(sys.coords[:, None, :],
                                   sys.coords[None, :, :])
    r = torch.linalg.vector_norm(dr, dim=-1)
    n = sys.n_atoms
    listed = torch.zeros((n, n), dtype=torch.bool)
    listed[torch.eye(n, dtype=torch.bool)] = True
    for i, j in zip(*map(lambda t: t.tolist(), (sys.exclusions.excl_i,
                                                 sys.exclusions.excl_j))):
        listed[i, j] = listed[j, i] = True
    expect = r[~listed & (r >= 0.25) & (r < 0.5)].min()
    assert d == pytest.approx(float(expect), rel=1e-12)


def test_maybe_rebuild_on_cadence():
    (_, _, _), (tc, tb, tx) = inputs("ortho")
    f = pt.DistanceNeighborFinder(RADIUS, 4, 40)
    nb = pt.find_neighbors(f, tc, tb, tx, 0)
    assert pt.maybe_rebuild(f, nb, tc, tb, tx, 3) is nb
    assert pt.maybe_rebuild(f, nb, tc, tb, tx, 8).step_built == 8
    assert pt.maybe_rebuild(pt.NoNeighborFinder(), nb, tc, tb, tx, 8) is nb
    assert pt.find_neighbors(pt.NoNeighborFinder(), tc, tb, tx) is None


def test_cpu_find_takes_the_twin_and_tags_its_span_torch(monkeypatch):
    """On the CPU, CellListNeighborFinder.find is its plain twin
    (find_plain): the kernel's launch count does not move, and the loop's
    ``neighbors.find`` span names the engine "torch"."""
    from mollytpu_torch.ops import native
    from mollytpu_torch.ops import neighbors as nb_mod
    from mollytpu_torch.sim import simulate
    (_, _, _), (tc, tb, tx) = inputs("triclinic")
    finder = pt.CellListNeighborFinder.setup(tb, RADIUS, tc.shape[0],
                                             n_steps=5)
    before = native.LAUNCHES["cell_neighbors"]
    a = finder.find(tc, tb, tx, 3)
    b = finder.find_plain(tc, tb, tx, 3)
    assert torch.equal(a.idx, b.idx) and torch.equal(a.special, b.special)
    assert int(a.overflow) == int(b.overflow) == 0 and a.step_built == 3
    assert nb_mod.find_engine(finder, tc) == "torch"

    seen = []
    real = simulate.span

    def spy(name, args=None):
        seen.append((name, args))
        return real(name, args)

    monkeypatch.setattr(simulate, "span", spy)
    sys = _lj_system(pt.CellListNeighborFinder.setup(
        pt.rectangular((2.5, 2.0, 1.3), dtype=torch.float64, device=CPU),
        RADIUS, 300, n_steps=5))
    nb = pt.find_neighbors(sys.neighbor_finder, sys.coords, sys.boundary,
                           sys.exclusions)
    pt.run_chunk(_Drift(0.001), sys, nb, {}, 0, 10)
    assert [args for name, args in seen
            if name == "neighbors.find"] == ["torch", "torch"]
    assert native.LAUNCHES["cell_neighbors"] == before


#: kinds of the twin's check: an old table of another width built at
#: moved coordinates, an old table of sentinels only, the new table
#: against itself, and one pair planted 0.25 nm apart and left out
CHECK_KINDS = ("other-width", "sentinels-only", "self", "planted")


def _check_inputs(name, kind, dtype):
    """(old table, new table, coords, box) on the CPU in ``dtype``: the
    fluid, its table at radius 0.6 and width 64, and the old table of
    ``kind``."""
    coords, _, _ = fluid(name)
    n = coords.shape[0]
    _, box = _boxes(name)
    box = box.to(dtype=dtype)
    x = torch.as_tensor(coords, dtype=dtype)
    excl = pt.Exclusions.empty(n, device=CPU)
    if kind == "planted":
        # atom 1 0.25 nm from atom 0 along the box's first vector
        a = box.box_matrix()[0] if name == "triclinic" else torch.tensor(
            [1.0, 0.0, 0.0], dtype=dtype)
        x = x.clone()
        x[1] = x[0] + 0.25 * a / torch.linalg.vector_norm(a)
    new = pt.find_neighbors(pt.DistanceNeighborFinder(RADIUS, 1, 64), x,
                            box, excl)
    if kind == "self":
        return new, new, x, box
    if kind == "sentinels-only":
        return dataclasses.replace(new, idx=torch.full(
            (n, 7), n, dtype=torch.int32)), new, x, box
    if kind == "planted":
        idx = new.idx.clone()
        idx[(idx == 0) & (torch.arange(n)[:, None] == 1)] = n
        idx[(idx == 1) & (torch.arange(n)[:, None] == 0)] = n
        return dataclasses.replace(new, idx=idx), new, x, box
    rng = np.random.default_rng(7)
    moved = box.wrap(x + torch.as_tensor(rng.uniform(-0.1, 0.1, (n, 3)),
                                         dtype=dtype))
    old = pt.find_neighbors(pt.DistanceNeighborFinder(0.45, 1, 40), moved,
                            box, excl)
    return old, new, x, box


def _brute_missing(old, new, coords, box, cutoff):
    """The least r < cutoff (the cutoff in the working type) over every
    atom pair (i, j), j in row i of ``new`` and not in row i of ``old``,
    walked pair by pair over the all-pairs distances; inf for none."""
    n = coords.shape[0]
    r = torch.sqrt(pair_geometry(coords, box)[1])
    cut = torch.tensor(cutoff, dtype=coords.dtype)
    best = float("inf")
    for i in range(n):
        held = set(old.idx[i].tolist())
        for j in new.idx[i].tolist():
            if j < n and j not in held and bool(r[i, j] < cut):
                best = min(best, float(r[i, j]))
    return best


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64),
                         ids=("f32", "f64"))
@pytest.mark.parametrize("kind", CHECK_KINDS)
@pytest.mark.parametrize("name", BOXES)
def test_plain_check_matches_brute_force(name, kind, dtype):
    old, new, x, box = _check_inputs(name, kind, dtype)
    got = missing_min_distance_plain(old, new, x, box, 0.5)
    assert got.shape == () and got.dtype == dtype
    want = _brute_missing(old, new, x, box, 0.5)
    assert float(got) == want
    if kind == "self":
        assert want == float("inf")
    else:
        assert want < 0.5
    if kind == "other-width":
        assert old.idx.shape[1] != new.idx.shape[1]
    if kind == "planted":
        assert want == pytest.approx(0.25, rel=1e-6)


def test_cpu_check_takes_the_twin_and_launches_no_kernel():
    """On CPU tensors missing_min_distance is its twin, and neither it nor
    a chunk's checks move native.LAUNCHES["table_check"]."""
    from mollytpu_torch.ops import native
    before = native.LAUNCHES["table_check"]
    old, new, x, box = _check_inputs("ortho", "other-width", torch.float32)
    got = missing_min_distance(old, new, x, box, 0.5)
    want = missing_min_distance_plain(old, new, x, box, 0.5)
    assert got.numpy().tobytes() == want.numpy().tobytes()
    sys = _lj_system(pt.CellListNeighborFinder.setup(
        pt.rectangular((2.5, 2.0, 1.3), dtype=torch.float64, device=CPU),
        RADIUS, 300, n_steps=5))
    nb = pt.find_neighbors(sys.neighbor_finder, sys.coords, sys.boundary,
                           sys.exclusions)
    *_, closest = pt.run_chunk(_Drift(0.005), sys, nb, {}, 0, 12)
    assert closest == float("inf")
    assert native.LAUNCHES["table_check"] == before
