"""The pair kernel's roofline probes (ops/pair_kernel.py ``probe``): their
plain twins against the JAX package's probes and against identities of the
full twin, and the rule that no main path takes a probe.

- ``distance_only`` (coef = r^2 * 1e-12 on live slots, energy 0) against
  pallas_block_nonbonded in interpret mode with MOLLYTPU_PAIR_VARIANT=
  distance_only, on the 64-atom exclusion system and the 64-water box. The
  JAX wrapper corrects far-window pairs with the real pair terms after its
  kernel, so both sides run without far-pair lists: the comparison is the
  probe's own sums. Float64 both sides; the Pallas kernel accumulates
  forces in moment form (sum coef x_j - x_i sum coef in block-local
  frames), which cancels a digit or two of the sixteen, so forces and
  virial agree to 1e-9 of their largest entry.
- ``noocc`` (no j-side forces of cross tiles): the full twin's forces are
  the noocc forces of the list plus those of its cross tiles swapped
  (I, J) -> (J, I); energy and virial are the full twin's. Float64, the
  same pair terms in another summation order: 1e-12.
- ``gather_only`` and ``preponly``: zero forces and energy.
"""

import dataclasses
import inspect

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
from mollytpu_torch.ops import pair_kernel
from torch_parity import (CPU, jax_neighbors, jax_system, np64,
                          port_neighbors, port_system)
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
from test_torch_pair_kernel import (LIST, _exclusions64, _jax_inters,
                                    _port_inters)

PROBE_TOL, SAME_TOL = 1e-9, 1e-12


def _exclusion_case():
    """(JAX call pieces, port pieces) of the 64-atom exclusion system."""
    coords, side, excl, spec = _exclusions64()
    n = coords.shape[0]
    rng = np.random.default_rng(n)
    q = rng.uniform(-0.5, 0.5, n)
    q -= q.mean()
    sigma = rng.uniform(0.25, 0.35, n)
    eps = rng.uniform(0.1, 0.3, n)
    eps[::5] = 0.0
    jatoms = mt.make_atoms(n=n, mass=10.0, charge=jnp.asarray(q),
                           sigma=jnp.asarray(sigma), epsilon=jnp.asarray(eps),
                           dtype=jnp.float64)
    jb = mt.cubic(side, dtype=jnp.float64)
    jexcl = mt.Exclusions.build(n, excl_pairs=excl, special_pairs=spec)
    jc = jnp.asarray(coords)
    finder = JaxBlockPairFinder.setup(jb, LIST, n, coords=jc, atoms=jatoms,
                                      block=32, lanes=128)
    jax_call = (build_fused_spec(_jax_inters(True)), jc, jb, jatoms, jexcl,
                finder.find(jc, jb, jexcl), finder)
    patoms = pt.make_atoms(n=n, mass=10.0, charge=q, sigma=sigma,
                           epsilon=eps, dtype=torch.float64, device=CPU)
    pb = pt.cubic(side, dtype=torch.float64, device=CPU)
    pexcl = pt.Exclusions.build(n, excl, spec, device=CPU)
    pc = torch.as_tensor(coords)
    nb = pt.BlockPairFinder.setup(pb, LIST, n, patoms).find(pc, pb, pexcl)
    port = (pair_kernel.build_fused_spec(_port_inters()), pc, pb, patoms, nb)
    return jax_call, port


def _water_case():
    """The same pieces for the 64-water PME box."""
    js, ps = jax_system("tiny64"), port_system("tiny64")
    jax_call = (build_fused_spec(js.pairwise_inters), js.coords, js.boundary,
                js.atoms, js.exclusions, jax_neighbors(js),
                js.neighbor_finder)
    port = (pair_kernel.build_fused_spec(ps.pairwise_inters), ps.coords,
            ps.boundary, ps.atoms, port_neighbors(ps))
    return jax_call, port


CASES = {"exclusions64": _exclusion_case, "water64": _water_case}


def _twin(port, compute_energy, probe=""):
    spec, coords, box, atoms, nb = port
    nbk, lam_role, _ = pair_kernel.kernel_inputs(spec, coords, atoms, nb)
    return pair_kernel.pair_nonbonded_plain(spec, nbk, box, coords.shape[0],
                                            compute_energy, lam_role,
                                            probe=probe)


def _rel(ref, got):
    ref, got = np64(ref), np64(got)
    return float(np.max(np.abs(ref - got)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_distance_only_matches_pallas_probe(case, monkeypatch):
    """The distance_only twin against the Pallas kernel's own
    distance_only variant, both without far-pair corrections."""
    (spec_j, jc, jb, jatoms, jexcl, nbs, finder), port = CASES[case]()
    no_far = jnp.zeros((0, 2), jnp.int32)
    jexcl = dataclasses.replace(jexcl, far_excl=no_far, far_spec=no_far)
    monkeypatch.setenv("MOLLYTPU_PAIR_VARIANT", "distance_only")
    f_j, e_j, v_j = jax.jit(lambda c: pallas_block_nonbonded(
        spec_j, c, jb, jatoms, jexcl, nbs, finder, compute_energy=True))(jc)
    f, e, v = _twin(port, True, "distance_only")
    assert float(np.max(np.abs(np64(f_j)))) > 0.0
    assert _rel(f_j, f) < PROBE_TOL
    assert _rel(v_j, v) < PROBE_TOL
    assert float(e_j) == 0.0 and float(e) == 0.0


@pytest.mark.parametrize("case", sorted(CASES))
def test_noocc_twin_drops_the_j_side_of_cross_tiles(case):
    """noocc of the list plus noocc of its cross tiles swapped is the full
    twin; energy and virial are the full twin's."""
    _, port = CASES[case]()
    spec, coords, box, atoms, nb = port
    f, e, v = _twin(port, True)
    f_i, e_i, v_i = _twin(port, True, "noocc")
    cross = nb.pairs[:, 0] != nb.pairs[:, 1]
    assert bool(cross.any()) and not bool(cross.all())
    swapped = dataclasses.replace(
        nb, pairs=nb.pairs[cross].flip(1).contiguous())
    f_j, _, _ = _twin((spec, coords, box, atoms, swapped), False, "noocc")
    assert _rel(f, f_i) > 1e-3         # the j side is a real share
    assert _rel(f, f_i + f_j) < SAME_TOL
    assert float(e_i) == pytest.approx(float(e), rel=SAME_TOL)
    assert _rel(v, v_i) < SAME_TOL


@pytest.mark.parametrize("probe", ["gather_only", "preponly"])
def test_load_only_probes_give_zero(probe):
    _, port = _water_case()
    f, e, v = _twin(port, True, probe)
    assert not bool(f.any()) and float(e) == 0.0 and not bool(v.any())


def test_block_nonbonded_never_takes_a_probe(monkeypatch):
    """The main-path entry has no probe keyword and calls kernel_inputs and
    pair_nonbonded without one; the force dispatch goes through it."""
    assert "probe" not in inspect.signature(
        pair_kernel.block_nonbonded).parameters
    seen = []
    real_inputs, real_pair = (pair_kernel.kernel_inputs,
                              pair_kernel.pair_nonbonded)

    def inputs(*args, **kw):
        seen.append(("kernel_inputs", kw.get("probe", "")))
        return real_inputs(*args, **kw)

    def pair(*args, **kw):
        seen.append(("pair_nonbonded", kw.get("probe", "")))
        return real_pair(*args, **kw)

    monkeypatch.setattr(pair_kernel, "kernel_inputs", inputs)
    monkeypatch.setattr(pair_kernel, "pair_nonbonded", pair)
    ps = port_system("tiny64")
    nb = port_neighbors(ps)
    pt.forces_virial(ps, nb)
    pt.potential_energy(ps, nb)
    assert seen == [("kernel_inputs", ""), ("pair_nonbonded", "")] * 2


def test_probe_names_and_instances_are_checked():
    """An unknown probe raises everywhere; the kernel probes have instances
    for forces-only Ewald launches in an orthorhombic box only, and the
    launch spec carries their ids."""
    _, (spec, coords, box, atoms, nb) = _water_case()
    n = coords.shape[0]
    with pytest.raises(ValueError, match="unknown probe"):
        pair_kernel.pair_nonbonded(spec, nb, box, n, probe="nogathr")
    with pytest.raises(ValueError, match="unknown probe"):
        pair_kernel.kernel_inputs(spec, coords, atoms, nb, probe="noOCC")
    forces = torch.zeros((n, 3))
    rf = dataclasses.replace(spec, coul_mode=2)
    with pytest.raises(ValueError, match="forces-only Ewald"):
        pair_kernel.launch_args(rf, nb, box, n, None, forces,
                                probe="noocc")
    with pytest.raises(ValueError, match="forces-only Ewald"):
        pair_kernel.launch_args(spec, nb, box, n, None, forces,
                                torch.zeros(7, dtype=torch.float64),
                                probe="distance_only")
    assert [pair_kernel._launch_spec(spec, nb, box, n, False, p).probe
            for p in ("", "preponly", "nogather", "gather_only",
                      "distance_only", "noocc")] == [0, 0, 0, 1, 2, 3]


def test_nogather_leaves_the_rebuild_coordinates():
    """nogather skips the per-call coordinate gather into the slot rows;
    without it the rows take this call's coordinates."""
    _, (spec, coords, box, atoms, nb) = _water_case()
    moved = coords + 0.01
    before = nb.pos4.clone()
    out, _, _ = pair_kernel.kernel_inputs(spec, moved, atoms, nb,
                                          probe="nogather")
    assert torch.equal(out.pos4, before)
    out, _, _ = pair_kernel.kernel_inputs(spec, moved, atoms, nb)
    assert torch.equal(out.pos4[:, :3], moved[nb.src])
    pair_kernel.kernel_inputs(spec, coords, atoms, nb)


def test_forces_only_calls_return_no_energy():
    """A forces-only evaluation returns energy and virial None (the CUDA
    wrapper then issues only the force fill and the launch); the force
    dispatch still returns a zero virial, as before."""
    _, port = _water_case()
    f, e, v = _twin(port, False)
    assert e is None and v is None and bool(f.any())
    ps = port_system("tiny64")
    _, vir = pt.forces_virial(ps, port_neighbors(ps))
    assert not bool(vir.any())
