"""The replica mesh over several CUDA cards (parallel/replicas.py,
sim/remd.py): T-REMD over the gcd rule's cards and simulate_ensemble over
every card, each on the block list so that the pair kernel launches on
every replica's card, against the same runs from the same generators on
card 0. It needs two or more cards and skips elsewhere. It imports
neither JAX nor the JAX package, so it runs on a card host without them:

    python -m pytest --noconftest -q tests/test_torch_multicard.py
"""

import math

import pytest
import torch

import mollytpu_torch as pt
from mollytpu_torch.ops import native
from mollytpu_torch.parallel.replicas import ReplicaMesh, mesh_size_for

TEMPS = [300.0, 300.6, 301.2, 301.8]


def langevin():
    return pt.Langevin(dt=0.002, temperature=300.0, friction=1.0)


def test_remd_over_cards_matches_one_card(tmp_path):
    """The pair kernel's float atomics add in no fixed order, so the runs
    agree to f32 rounding grown over 20 steps, not bit for bit: energies
    to 1e-5 relative, coordinates to 1e-4 nm, the same exchanges."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    count = torch.cuda.device_count()
    card0 = ReplicaMesh((torch.device("cuda", 0),))
    path = str(tmp_path / "water512.pdb")
    pt.water_box_pdb(path, n_waters=512)
    sys = pt.system_from_pdb(
        path, pt.ForceField(pt.TIP3P_XML), nonbonded_method="pme",
        dtype=torch.float32, device=card0.devices[0], constraints="hbonds",
        rigid_water=True, dist_neighbors=1.15, neighbor_finder="block")
    assert isinstance(sys.neighbor_finder, pt.BlockPairFinder)
    assert mesh_size_for(count, len(TEMPS)) == math.gcd(count, len(TEMPS))
    remd = pt.ReplicaExchangeMD(temperatures=TEMPS, simulator=langevin(),
                                cycle_length=10)
    runs = []
    for mesh in (None, card0):
        gen = torch.Generator(device=sys.device).manual_seed(11)
        before = native.LAUNCHES["pair_nonbonded"]
        runs.append(remd.simulate(sys, 2, generator=gen, mesh=mesh))
        assert native.LAUNCHES["pair_nonbonded"] > before
    (ens, info), (ens0, info0) = runs
    # the replicas lay on the gcd rule's cards (nothing else of this test
    # allocates beyond card 0)
    for d in range(math.gcd(count, len(TEMPS))):
        assert torch.cuda.max_memory_allocated(d) > 0, f"card {d} unused"
    assert info["exchange_rate"] == info0["exchange_rate"]
    torch.testing.assert_close(info["pes"], info0["pes"], rtol=1e-5,
                               atol=0.0)
    torch.testing.assert_close(ens.coords, ens0.coords, rtol=0.0, atol=1e-4)
    out = [pt.simulate_ensemble(
        sys, langevin(), count, 20, mesh=mesh, chunk=10,
        generator=torch.Generator(device=sys.device).manual_seed(12))
        for mesh in (None, card0)]
    assert out[0].coords.device == sys.device
    torch.testing.assert_close(out[0].coords, out[1].coords, rtol=0.0,
                               atol=1e-4)
