"""The physics count behind nonbonded_roofline_pct.*: pairs inside the
cutoff from the coordinates alone."""

import copy

import pytest
import torch

import bench_tiny
import harness
from reference.precision import F64
from roofline.count import count_pairs
from roofline.ops import FP32_OPS_PER_S, least_time_s


def test_simple_cubic_lattice_has_six_neighbours_per_atom():
    n, a = 5, 0.3
    grid = torch.stack(torch.meshgrid(*[torch.arange(n)] * 3,
                                      indexing="ij"), -1).reshape(-1, 3)
    x = grid.double() * a
    edges = torch.full((3,), n * a, dtype=torch.float64)
    own = torch.arange(n ** 3)
    lj = grid[:, 0] == 0
    # inside a and sqrt(2) a: the six face neighbours
    pairs, lj_pairs = count_pairs(x, edges, 1.2 * a, own, lj)
    assert pairs == 3 * n ** 3
    # atoms of one molecule are not counted: pair up +x neighbours
    mol = own.clone()
    mol[(grid[:, 0] % 2) == 1] -= n * n
    assert count_pairs(x, edges, 1.2 * a, mol, lj)[0] == \
        3 * n ** 3 - (n // 2) * n * n
    # LJ on the plane x = 0 only: four neighbours in the plane each
    assert lj_pairs == 2 * n * n


def test_fcc_lattice_has_54_neighbours_per_atom_inside_in_lj_cutoff():
    """in.lj's fcc lattice at rho* 0.8442: shells at a / sqrt(2) sqrt(k),
    a = (4 / rho*)^(1/3) sigma, hold 12, 6, 24, 12 atoms for k = 1..4,
    and k = 5 lies beyond 2.5 sigma, so N atoms make 27 N pairs."""
    spec = bench_tiny.tiny_spec(bench_tiny.CELLS[0])
    builder = harness.load_module("systems", spec["config"]["builder"])
    counts = []
    for neighbors in ({"finder": "cell", "rebuild_every": 5},
                      {"finder": "distance", "rebuild_every": 1}):
        cfg = copy.deepcopy(spec["config"])
        cfg["neighbors"] = neighbors
        ref = builder.reference(cfg, {}, F64, "cpu")
        counts.append(ref.pair_count(ref.start))
    assert counts[0] == counts[1] == (27 * 864, 27 * 864)


def test_least_time_is_the_larger_bound():
    t, by, ops, sfu, nbytes = least_time_s(1e6, 1e5, 1000, "ewald",
                                           "distance_cutoff", 24)
    assert ops == 1e6 * (20 + 3 + 37 + 12) + 1e5 * 18
    assert sfu == 4e6 and nbytes == 36000
    assert by == "FP32 operations"
    assert t == pytest.approx(ops / FP32_OPS_PER_S)


def test_cell_bins_see_every_pair_that_brute_force_sees(monkeypatch):
    """The reference over cell bins against one cell that holds every
    atom (every pair by brute force), on a lattice shaken off its sites:
    the same forces, energy and pair count."""
    from reference import cells, lj_fcc
    from roofline import count
    spec = bench_tiny.tiny_spec(bench_tiny.CELLS[0])
    builder = harness.load_module("systems", spec["config"]["builder"])
    ref = builder.reference(spec["config"], {}, F64, "cpu")
    gen = torch.Generator().manual_seed(7)
    x = ref.start + 0.05 * torch.randn(ref.start.shape, generator=gen,
                                       dtype=torch.float64)
    binned = (ref.forces(x), ref.energy(x), ref.pair_count(x))

    def one_cell(x, edges, cutoff):
        return cells.CellBins(x, edges, float(edges[0]))
    monkeypatch.setattr(lj_fcc, "CellBins", one_cell)
    monkeypatch.setattr(count, "CellBins", one_cell)
    brute = (ref.forces(x), ref.energy(x), ref.pair_count(x))
    torch.testing.assert_close(binned[0], brute[0], rtol=1e-12, atol=1e-12)
    assert float(binned[1]) == pytest.approx(float(brute[1]), rel=1e-13)
    assert binned[2] == brute[2] and binned[2][0] > 20 * 864
