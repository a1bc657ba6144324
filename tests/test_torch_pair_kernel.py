"""The pair kernel's plain twin (ops/pair_kernel.py) against the JAX
package: the Pallas kernel pallas_block_nonbonded in interpret mode (as
tests/test_kernel_consistency.py runs it: BlockPairFinder block=32,
lanes=128) and the dense all-pairs reference (nonbonded.dense_forces /
dense_energy through forces_virial / potential_energy).

Tolerances, float64 throughout:
- against dense JAX with exact erfc: 1e-10 relative (same formulas, other
  summation order);
- against the Pallas kernel: its Ewald erfc is a degree-14 polynomial
  accurate to < 6e-7 absolute (pallas_pairwise.py:65-69) where the port
  uses the exact erfc, so forces and virial agree to 2e-6 of their largest
  entry and energies to 2e-6 of the summed pair-energy magnitude; on the
  water box the virial sums ~1e4 strongly cancelling Coulomb pair terms,
  each with that error, so it gets 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.ops.blockpairs import BlockPairFinder as JaxBlockPairFinder
from mollytpu.ops.pallas_pairwise import (build_fused_spec,
                                          pallas_block_nonbonded)

import mollytpu_torch as pt
from mollytpu_torch.ops import native, pair_kernel
from mollytpu_torch.ops.cutoffs import DistanceCutoff
from mollytpu_torch.ops.pairwise import CoulombEwald, LennardJones
from torch_parity import (CPU, box_path, jax_neighbors, jax_system, max_rel,
                          np64, port_neighbors, port_system)
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RC, LIST, ALPHA = 0.9, 1.0, 3.0
EXACT, POLY, POLY_SUM = 1e-10, 2e-6, 2e-5


def _jax_inters(use_neighbors):
    return (mt.LennardJones(cutoff=mt.DistanceCutoff(RC),
                            use_neighbors=use_neighbors, weight_special=0.5),
            mt.CoulombEwald(dist_cutoff=RC, alpha=ALPHA,
                            use_neighbors=use_neighbors,
                            weight_special=0.8333, approximate_erfc=False))


def _port_inters():
    return (LennardJones(cutoff=DistanceCutoff(RC), weight_special=0.5),
            CoulombEwald(dist_cutoff=RC, alpha=ALPHA, weight_special=0.8333))


def _place(n, side, seed, min_dist=0.25):
    rng = np.random.default_rng(seed)
    pts = []
    while len(pts) < n:
        c = rng.uniform(0.0, side, 3)
        d = np.array(pts) - c if pts else np.zeros((0, 3))
        d -= side * np.round(d / side)
        if not pts or np.min(np.linalg.norm(d, axis=1)) > min_dist:
            pts.append(c)
    return np.array(pts)


def _partial33():
    n = 33
    coords = np.array([[0.5 * (i % 8) + 0.11 * i, 0.45 * (i % 7),
                        0.4 * (i % 6)] for i in range(n)])
    return coords, 8.0, [], []


def _exclusions64():
    """Chain exclusions (i, i+1), (i, i+2), 1-4 pairs (i, i+3), and pairs
    with |j - i| > 31 (outside the bitmap window) among interacting atoms."""
    n, side = 64, 2.4
    coords = _place(n, side, 7)
    d = coords[:, None, :] - coords[None, :, :]
    d = np.linalg.norm(d - side * np.round(d / side), axis=-1)
    far = [(a, b) for a, b in zip(*np.nonzero((d > 0.05) & (d < 0.8)))
           if b - a > 31][:6]
    assert len(far) == 6
    excl = ([(i, i + 1) for i in range(n - 1)]
            + [(i, i + 2) for i in range(n - 2)] + far[:3])
    spec = [(i, i + 3) for i in range(0, n - 3, 2)] + far[3:]
    return coords, side, excl, spec


CASES = {"partial33": _partial33, "exclusions64": _exclusions64}


def _build(case):
    coords, side, excl, spec = CASES[case]()
    n = coords.shape[0]
    rng = np.random.default_rng(n)
    q = rng.uniform(-0.5, 0.5, n)
    q -= q.mean()
    sigma = rng.uniform(0.25, 0.35, n)
    eps = rng.uniform(0.1, 0.3, n)
    eps[::5] = 0.0     # hydrogen-like sites with no LJ
    jatoms = mt.make_atoms(n=n, mass=10.0, charge=jnp.asarray(q),
                           sigma=jnp.asarray(sigma), epsilon=jnp.asarray(eps),
                           dtype=jnp.float64)
    jb = mt.cubic(side, dtype=jnp.float64)
    jexcl = mt.Exclusions.build(n, excl_pairs=excl, special_pairs=spec)
    jc = jnp.asarray(coords)
    jdense = mt.System(atoms=jatoms, coords=jc, boundary=jb,
                       pairwise_inters=_jax_inters(False), exclusions=jexcl)
    finder = JaxBlockPairFinder.setup(jb, LIST, n, coords=jc, atoms=jatoms,
                                      block=32, lanes=128)
    nbs = finder.find(jc, jb, jexcl)
    assert int(nbs.overflow) == 0
    spec_j = build_fused_spec(_jax_inters(True))
    jpal = jax.jit(lambda c: pallas_block_nonbonded(
        spec_j, c, jb, jatoms, jexcl, nbs, finder, compute_energy=True))(jc)
    jref = jax.jit(lambda s: (mt.forces_virial(s, needs_virial=True),
                              mt.potential_energy(s)))(jdense)

    patoms = pt.make_atoms(n=n, mass=10.0, charge=q, sigma=sigma,
                           epsilon=eps, dtype=torch.float64, device=CPU)
    pb = pt.cubic(side, dtype=torch.float64, device=CPU)
    pexcl = pt.Exclusions.build(n, excl, spec, device=CPU)
    pc = torch.as_tensor(coords)
    nb = pt.BlockPairFinder.setup(pb, LIST, n, patoms).find(pc, pb, pexcl)
    ours = pair_kernel.block_nonbonded(
        pair_kernel.build_fused_spec(_port_inters()), pc, pb, patoms, pexcl,
        nb, compute_energy=True)
    return jpal, jref, ours


@pytest.fixture(scope="module", params=sorted(CASES))
def results(request):
    return _build(request.param)


def test_forces_match_dense_reference(results):
    _, ((f_ref, _), _), (f, _, _) = results
    assert max_rel(f_ref, f) < EXACT


def test_energy_and_virial_match_dense_reference(results):
    _, ((_, v_ref), e_ref), (_, e, v) = results
    assert float(e) == pytest.approx(float(e_ref), rel=EXACT, abs=EXACT)
    assert max_rel(v_ref, v) < EXACT


def test_matches_pallas_kernel(results):
    (f_pal, e_pal, v_pal), ((_, _), e_ref), (f, e, v) = results
    assert max_rel(f_pal, f) < POLY
    assert max_rel(v_pal, v) < POLY
    assert abs(float(e) - float(e_pal)) < POLY * max(1.0, abs(float(e_ref)))


def test_water_box_matches_pallas_kernel():
    """The 64-water PME box: pair forces, energy and virial of the Pallas
    kernel (interpret mode) against the plain twin on the same list radius.
    Energies here cancel strongly, so the energy bound is POLY times the
    summed magnitude of the O-O Coulomb pair terms, ~1e4 kJ/mol."""
    js, ps = jax_system("tiny64"), port_system("tiny64")
    nbs = jax_neighbors(js)
    spec_j = build_fused_spec(js.pairwise_inters)
    f_j, e_j, v_j = jax.jit(lambda c: pallas_block_nonbonded(
        spec_j, c, js.boundary, js.atoms, js.exclusions, nbs,
        js.neighbor_finder, compute_energy=True))(js.coords)
    f, e, v = pair_kernel.block_nonbonded(
        pair_kernel.build_fused_spec(ps.pairwise_inters), ps.coords,
        ps.boundary, ps.atoms, ps.exclusions, port_neighbors(ps),
        compute_energy=True)
    assert max_rel(f_j, f) < POLY
    assert max_rel(v_j, v) < POLY_SUM
    assert abs(float(e) - float(e_j)) < POLY * 1e4


def _unported(bad):
    """Interactions outside the kernel's modes, and every alchemical case
    the JAX package's build_fused_spec refuses, with the reason the error
    names."""
    import mollytpu_torch as pt
    from mollytpu_torch.ops.cutoffs import NoCutoff
    from mollytpu_torch.ops.mixing import LorentzMixing
    from mollytpu_torch.ops.pairwise import Coulomb
    lj = LennardJones(cutoff=DistanceCutoff(1.0))
    sc_lj = pt.LennardJonesSoftCoreBeutler(cutoff=DistanceCutoff(1.0))
    return {
        "mode": ((LennardJones(cutoff=NoCutoff()), Coulomb()),
                 "no finite cutoff"),
        "mixing": ((LennardJones(cutoff=DistanceCutoff(1.0),
                                 epsilon_mixing=LorentzMixing()),
                    CoulombEwald()), "Lorentz-Berthelot"),
        "sc-rf-beutler": ((lj, pt.CoulombSoftCoreBeutlerReactionField()),
                          "XLA pair path"),
        "sc-rf-gapsys": ((sc_lj, pt.CoulombSoftCoreGapsysReactionField()),
                         "XLA pair path"),
        "lambda-mixing": ((pt.LennardJonesSoftCoreBeutler(
            cutoff=DistanceCutoff(1.0), lambda_mixing=LorentzMixing()),
            CoulombEwald()), "lambda mixing LorentzMixing"),
        "coulomb-lambda-mixing": ((lj, pt.CoulombSoftCoreBeutlerEwald(
            lambda_mixing=LorentzMixing())), "MinimumMixing only"),
        "two-schedulers": ((sc_lj, pt.CoulombSoftCoreBeutlerEwald(
            scheduler=pt.QuartersLambdaScheduler())),
            "two lambda schedulers of different types"),
        "sc-lj-no-cutoff": ((pt.LennardJonesSoftCoreGapsys(
            cutoff=NoCutoff()), CoulombEwald()), "finite cutoff"),
        "sc-coulomb-no-cutoff": ((lj, pt.CoulombSoftCoreBeutler()),
                                 "finite cutoff"),
        "sc-coulomb-shifted": ((lj, pt.CoulombSoftCoreGapsys(
            cutoff=pt.ShiftedForceCutoff(1.0))),
            "ShiftedForceCutoff: only no cutoff or a distance cutoff"),
    }[bad]


@pytest.mark.parametrize("bad", [
    "mode", "mixing", "sc-rf-beutler", "sc-rf-gapsys", "lambda-mixing",
    "coulomb-lambda-mixing", "two-schedulers", "sc-lj-no-cutoff",
    "sc-coulomb-no-cutoff", "sc-coulomb-shifted"])
def test_unported_kernel_modes_raise(bad):
    """No finite cutoff (the dense all-pairs path), NBFix-style mixing, the
    soft-core reaction-field combinations (the JAX package's XLA pair
    path), lambda mixing other than the minimum, two schedulers of
    different types and soft-core terms without a finite distance cutoff
    are outside the kernel's modes; each error names its reason."""
    inters, reason = _unported(bad)
    with pytest.raises(NotImplementedError, match=reason):
        pair_kernel.build_fused_spec(inters)


def test_cuda_kernel_matches_plain_twin():
    """On a CUDA card: the kernel against its twin on the same f32 inputs
    (the bound is f32 rounding with atomics reordering the sums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    sys = pt.system_from_pdb(
        box_path("liquid512"),
        pt.ForceField(pt.TIP3P_XML), nonbonded_method="pme",
        dtype=torch.float32, device=dev,
        constraints="hbonds", rigid_water=True, dist_neighbors=1.15)
    nb = sys.neighbor_finder.find(sys.coords, sys.boundary, sys.exclusions)
    nb.pos4[:, :3] = sys.coords[nb.src]
    spec = pair_kernel.build_fused_spec(sys.pairwise_inters)
    before = native.LAUNCHES["pair_nonbonded"]
    f, e, v = pair_kernel.pair_nonbonded(spec, nb, sys.boundary,
                                         sys.n_atoms, True)
    assert native.LAUNCHES["pair_nonbonded"] == before + 1
    f0, e0, v0 = pair_kernel.pair_nonbonded_plain(spec, nb, sys.boundary,
                                                  sys.n_atoms, True)
    assert max_rel(f0, f) < 1e-5
    assert max_rel(v0, v) < 1e-5
    assert abs(float(e) - float(e0)) < 1e-5 * abs(float(e0))
    assert np.all(np.isfinite(np64(f)))
