"""Work accounting of the port's cluster-pair list (ops/blockpairs.py):
completeness against brute force, sentinel padding, half orientation, a
frozen list size for a fixed seed, the box-size check and the stale-list
guard of the simulation loop."""

import dataclasses

import numpy as np
import pytest
import torch

import mollytpu_torch as pt
from mollytpu_torch.ops.blockpairs import (CLUSTER, BlockPairFinder,
                                           unlisted_min_distance)
from mollytpu_torch.ops.cutoffs import DistanceCutoff
from mollytpu_torch.ops.pairwise import CoulombEwald, LennardJones
from mollytpu_torch.sim.simulate import run_chunk
from torch_parity import CPU, LIST_RADIUS
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _random_system(n, side, seed):
    rng = np.random.default_rng(seed)
    coords = torch.as_tensor(rng.uniform(0.0, side, (n, 3)))
    boundary = pt.cubic(side, dtype=torch.float64, device=CPU)
    atoms = pt.make_atoms(n=n, mass=10.0, sigma=0.3, epsilon=0.2,
                          charge=torch.as_tensor(rng.uniform(-0.5, 0.5, n)),
                          dtype=torch.float64, device=CPU)
    return coords, boundary, atoms, pt.Exclusions.build(n, device=CPU)


@pytest.fixture(scope="module")
def water1000(tmp_path_factory):
    path = pt.water_box_pdb(str(tmp_path_factory.mktemp("w") / "w.pdb"),
                            1000)
    sys = pt.system_from_pdb(path, pt.ForceField(pt.TIP3P_XML),
                             nonbonded_method="pme", dtype=torch.float64,
                             device=CPU, constraints="hbonds",
                             rigid_water=True, dist_neighbors=LIST_RADIUS,
                             neighbor_n_steps=20)
    return sys, sys.neighbor_finder.find(sys.coords, sys.boundary,
                                         sys.exclusions)


def _cluster_of_atom(nb, n):
    slot = torch.empty(n, dtype=torch.int64)
    ids = nb.ids.to(torch.int64)
    real = ids < n
    slot[ids[real]] = torch.nonzero(real).flatten()
    return (slot // CLUSTER).numpy()


@pytest.mark.parametrize("case", ["water1000", "random100"])
def test_list_covers_brute_force_pairs(case, water1000):
    """Every atom pair within the list radius lies in a listed tile."""
    if case == "water1000":
        sys, nb = water1000
        coords, boundary = sys.coords, sys.boundary
    else:
        coords, boundary, atoms, excl = _random_system(100, 2.6, 3)
        finder = BlockPairFinder.setup(boundary, 1.0, 100, atoms)
        nb = finder.find(coords, boundary, excl)
    n = coords.shape[0]
    dr = boundary.displacement(coords[:, None, :], coords[None, :, :])
    d = torch.linalg.vector_norm(dr, dim=-1).numpy()
    radius = LIST_RADIUS if case == "water1000" else 1.0
    ii, jj = np.nonzero(np.triu(d < radius, k=1))
    cl = _cluster_of_atom(nb, n)
    ci, cj = np.minimum(cl[ii], cl[jj]), np.maximum(cl[ii], cl[jj])
    listed = {tuple(p) for p in nb.pairs.tolist()}
    missing = [(a, b) for a, b in zip(ci, cj) if (a, b) not in listed]
    assert not missing


def test_padding_slots_carry_sentinels():
    coords, boundary, atoms, excl = _random_system(100, 2.6, 4)
    nb = BlockPairFinder.setup(boundary, 1.0, 100, atoms).find(
        coords, boundary, excl)
    assert nb.ids.shape[0] == 128
    assert torch.all(nb.ids[100:] == 100)
    assert sorted(nb.ids[:100].tolist()) == list(range(100))
    assert torch.all(nb.pos4[100:, 3] == 0) and torch.all(nb.lj2[100:] == 0)
    assert torch.all(nb.bits[100:] == 0)


def test_half_orientation_lists_each_pair_once(water1000):
    _, nb = water1000
    pairs = nb.pairs.tolist()
    assert all(i <= j for i, j in pairs)
    assert len(set(map(tuple, pairs))) == len(pairs)
    # every cluster meets itself: the self tile carries its in-cluster pairs
    assert {(c, c) for c in range(nb.n_clusters)} <= set(map(tuple, pairs))


def test_list_size_frozen_for_seed(water1000):
    """1000 waters at liquid density, seed 0: 3000 atoms in 94 clusters and
    3518 listed cluster pairs of the 4465 possible. A change here changes
    the kernel's work and must be deliberate."""
    sys, nb = water1000
    assert sys.neighbor_finder.sort_dims == (6, 6, 6)
    assert (nb.n_clusters, nb.n_pairs) == (94, 3518)


def test_small_box_is_refused():
    coords, boundary, atoms, _ = _random_system(50, 2.2, 5)
    with pytest.raises(ValueError, match="side/2"):
        BlockPairFinder.setup(boundary, LIST_RADIUS, 50, atoms)


@pytest.mark.parametrize("move", [0.05, 0.4])
def test_unlisted_min_distance_is_exact_below_cutoff(move):
    """Against brute force over all atom pairs of unlisted cluster pairs:
    exact when below the cutoff (large moves), a lower bound of at least
    the cutoff otherwise (small moves)."""
    n, cutoff = 2000, 1.0
    coords, boundary, atoms, excl = _random_system(n, 5.0, 6)
    nb = BlockPairFinder.setup(boundary, LIST_RADIUS, n, atoms).find(
        coords, boundary, excl)
    assert nb.n_pairs < nb.n_clusters * (nb.n_clusters + 1) // 2
    rng = np.random.default_rng(8)
    moved = coords + torch.as_tensor(rng.uniform(-move, move, (n, 3)))
    moved[11] += 5.0       # a whole box image changes nothing
    got = float(unlisted_min_distance(nb, moved, boundary, cutoff))
    cl = _cluster_of_atom(nb, n)
    listed = np.zeros((nb.n_clusters,) * 2, dtype=bool)
    p = nb.pairs.numpy()
    listed[p[:, 0], p[:, 1]] = listed[p[:, 1], p[:, 0]] = True
    unlisted = ~listed[cl[:, None], cl[None, :]]
    d = torch.linalg.vector_norm(boundary.displacement(
        moved[:, None, :], moved[None, :, :]), dim=-1).numpy()
    brute = d[unlisted].min()
    if brute < cutoff:
        assert got == pytest.approx(brute, abs=1e-12)
    else:
        assert cutoff <= got <= brute + 1e-12
    assert (brute < cutoff) == (move > 0.1)


@dataclasses.dataclass(frozen=True)
class _Drift:
    """A stand-in integrator that moves every atom `dx` nm per step along
    its own fixed random direction."""

    dx: float

    def init_aux(self, sys, neighbors, needs_virial=False):
        return {}

    def step(self, sys, neighbors, aux, step_n, generator=None, noise=None,
             needs_virial=False):
        gen = torch.Generator().manual_seed(1)
        u = torch.randn(sys.coords.shape, generator=gen, dtype=torch.float64)
        u = u / torch.linalg.vector_norm(u, dim=1, keepdim=True)
        return sys.update(coords=sys.coords + self.dx * u), aux


def _drift_system(n=64, side=2.6):
    coords, boundary, atoms, excl = _random_system(n, side, 7)
    finder = BlockPairFinder.setup(boundary, 1.15, n, atoms, n_steps=5)
    inters = (LennardJones(cutoff=DistanceCutoff(1.0)),
              CoulombEwald(dist_cutoff=1.0))
    return pt.System(atoms=atoms, coords=coords, boundary=boundary,
                     pairwise_inters=inters, exclusions=excl,
                     neighbor_finder=finder)


@pytest.mark.parametrize("step0, n, builds", [
    (0, 12, [5, 10]), (3, 12, [5, 10, 15]), (5, 5, [10])])
def test_chunk_schedule_rebuilds_on_cadence(step0, n, builds):
    sys = _drift_system()
    nb = sys.neighbor_finder.find(sys.coords, sys.boundary, sys.exclusions,
                                  step0)
    seen = []
    finder = sys.neighbor_finder

    class Recording(BlockPairFinder):
        def find(self, coords, boundary, exclusions, step_n=0):
            seen.append(step_n)
            return finder.find(coords, boundary, exclusions, step_n)

    sys = sys.update(neighbor_finder=Recording(**{
        f.name: getattr(finder, f.name)
        for f in dataclasses.fields(finder)}))
    run_chunk(_Drift(0.001), sys, nb, {}, step0, n)
    assert seen == builds


def test_stale_list_fails_loudly():
    sys = _drift_system(2000, 5.0)
    nb = sys.neighbor_finder.find(sys.coords, sys.boundary, sys.exclusions)
    # 5 steps of 0.01 nm between rebuilds: two clusters move at most 0.1 nm
    # together, inside the 0.15 nm skin
    *_, closest = run_chunk(_Drift(0.01), sys, nb, {}, 0, 10)
    assert closest >= 1.0
    with pytest.raises(pt.StaleNeighborList, match="rebuild more often"):
        run_chunk(_Drift(0.1), sys, nb, {}, 0, 10)
