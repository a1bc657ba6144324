"""K1c, the pair kernel's alchemical path: soft-core LJ (Beutler, Gapsys)
and soft-core Coulomb (Beutler, Gapsys; bare or under the Ewald screen) at
per-pair lambdas from per-atom (lambda, role) rows, and the scaled-charge
family. The plain twin (ops/pair_kernel.py) against the JAX package: its
_pair_terms_alch term by term, then over a cluster-pair list against
pallas_block_nonbonded in interpret mode (BlockPairFinder block=32,
lanes=128) and the dense all-pairs path on a 96-atom mixed-role fluid
(INSERT, DELETE and CORE atoms) in a cube and a 92/95/88 degree box, with
1-4 and far-window exclusions, at five lambdas. Then the per-call lambda
inputs, PME with a scheduler, and the guards of the launch layout.

Tolerances, float64 throughout:
- term by term: 1e-12 of max(1, |term|) per entry (the same formulas);
  the scaled Ewald case compares the exact erfc with the TPU kernel's
  degree-14 polynomial (< 6e-7 absolute), so 2e-6 of the largest entry;
- over the list against the Pallas kernel: 1e-9 of max(1, largest entry)
  for forces and virial, of max(1, |E|) for the energy (same formulas,
  other summation order); 2e-6 where the plain Ewald screen meets the
  polynomial erfc (the scaled family);
- against the dense path, as tests/test_kernel_consistency.py:318-377
  holds the Pallas kernel: the dense path differentiates the
  Abramowitz-Stegun erfc where the kernel takes the exact derivative of
  erfc, so soft-core Ewald forces agree to 2e-5 of the largest entry and
  energies to 1e-6 relative; Gapsys without Ewald to 1e-6; the scaled
  Ewald family, exact erfc against the dense path's rational one, to 1e-5.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.ops.blockpairs import BlockPairFinder as JaxBlockPairFinder
from mollytpu.ops.ewald import PME as JaxPME
from mollytpu.ops.pallas_pairwise import _pair_terms_alch as jax_terms_alch
from mollytpu.ops.pallas_pairwise import (build_fused_spec as
                                          jax_build_fused_spec,
                                          pallas_block_nonbonded)

import mollytpu_torch as pt
from mollytpu_torch.ops import pair_kernel
from mollytpu_torch.ops.blockpairs import BlockPairFinder
from mollytpu_torch.ops.ewald import PME
from torch_parity import CPU, max_rel, np64
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TERMS, EXACT, POLY = 1e-12, 1e-9, 2e-6
RC, LIST, N = 0.9, 0.9, 96
LAMS = (0.0, 0.3, 0.5, 0.8, 1.0)

#: soft-core and plain LJ: (class, cutoff class, radius, alpha)
LJS = {"beutler": ("LennardJonesSoftCoreBeutler", "DistanceCutoff", RC, 0.5),
       "beutler-sf": ("LennardJonesSoftCoreBeutler", "ShiftedForceCutoff",
                      0.85, 0.5),
       "gapsys": ("LennardJonesSoftCoreGapsys", "ShiftedForceCutoff", RC,
                  0.85),
       "gapsys-sp": ("LennardJonesSoftCoreGapsys", "ShiftedPotentialCutoff",
                     0.8, 0.85),
       "lj": ("LennardJones", "DistanceCutoff", RC, None)}
#: every Coulomb form of the alchemical path: soft-core bare and under
#: Ewald, and the scaled-charge family
COULS = ("none", "sc-beutler", "sc-gapsys", "sc-beutler-ewald",
         "sc-gapsys-ewald", "scaled", "rf-scaled", "ewald-scaled")
COMBOS = ([(lj, c) for lj in ("beutler", "gapsys") for c in COULS]
          + [("beutler-sf", "sc-beutler-ewald"), ("gapsys-sp", "sc-gapsys"),
             ("lj", "sc-beutler-ewald"), ("lj", "sc-gapsys")])


def _scheduler(mod, name):
    """The port's scheduler instance, or the JAX package's scheduler CLASS:
    its NAMD and EleScaled instances cannot call the schedule they share
    with the default one (mollytpu/free_energy/alchemy.py:62, :84 bind it as
    a method), while the class calls it as a function."""
    cls = getattr(mod, name)
    return cls if mod is mt else cls()


def _inters(mod, lj, coul, un=True, sched="DefaultLambdaScheduler"):
    """The combination's interactions from ``mod``: mollytpu (JAX) or
    mollytpu_torch, which export the same names."""
    cls, cut, rc, alpha = LJS[lj]
    kw = dict(use_neighbors=un, weight_special=0.5)
    if alpha is not None:
        kw.update(alpha=alpha, scheduler=_scheduler(mod, sched))
    out = [getattr(mod, cls)(cutoff=getattr(mod, cut)(rc), **kw)]
    kw = dict(use_neighbors=un, weight_special=0.8333,
              scheduler=_scheduler(mod, sched))
    if coul == "sc-beutler":
        out.append(mod.CoulombSoftCoreBeutler(
            cutoff=mod.DistanceCutoff(0.8), alpha=0.5, **kw))
    elif coul == "sc-gapsys":
        out.append(mod.CoulombSoftCoreGapsys(
            cutoff=mod.DistanceCutoff(RC), alpha=0.3, sigma_q=1.0, **kw))
    elif coul == "sc-beutler-ewald":
        out.append(mod.CoulombSoftCoreBeutlerEwald(
            dist_cutoff=RC, alpha_sc=0.5, alpha=3.0, **kw))
    elif coul == "sc-gapsys-ewald":
        out.append(mod.CoulombSoftCoreGapsysEwald(
            dist_cutoff=RC, alpha_sc=0.3, sigma_q=1.0, alpha=3.0, **kw))
    elif coul == "scaled":
        out.append(mod.CoulombScaled(cutoff=mod.DistanceCutoff(0.8), **kw))
    elif coul == "rf-scaled":
        out.append(mod.CoulombReactionFieldScaled(dist_cutoff=RC, **kw))
    elif coul == "ewald-scaled":
        out.append(mod.CoulombEwaldScaled(dist_cutoff=RC, alpha=3.0, **kw))
    return tuple(out)


def _elem_rel(a, b):
    """max |a - b| / max(1, |a|) entry by entry."""
    a, b = np64(a), np64(b)
    return float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(a))))


@pytest.mark.parametrize("lj, coul", COMBOS)
def test_pair_terms_alch_match_jax(lj, coul):
    """Spec and per-pair (energy, coef) against the TPU kernel's
    _pair_terms_alch on 4,000 random pairs from 0.08 nm to cut_max, with
    lam_s and lam_e on the five lambdas and in between, 1-4 pairs and
    eps = 0 (hydrogen-like) pairs included."""
    spec = pair_kernel.build_fused_spec(_inters(pt, lj, coul))
    spec_j = jax_build_fused_spec(_inters(mt, lj, coul))
    for field in ("lj_mode", "lj_rc", "lj_w", "coul_mode", "coul_rc", "ke",
                  "krf", "crf", "alpha", "coul_w", "cut_max", "lj_kind",
                  "lj_alpha", "coul_sc", "coul_alpha_sc", "coul_sigma_q",
                  "scale_q"):
        assert getattr(spec, field) == pytest.approx(getattr(spec_j, field),
                                                     rel=TERMS), field
    assert spec.needs_lam == spec_j.needs_lam
    assert type(spec.scheduler).__name__ == spec_j.scheduler.__name__
    rng = np.random.default_rng(sum(map(ord, lj + coul)))
    k = 4000
    r = rng.uniform(0.08, spec.cut_max, k)
    sig = rng.uniform(0.25, 0.35, k)
    eps = rng.uniform(0.05, 0.3, k) * (rng.uniform(size=k) > 0.2)
    qq = rng.uniform(-0.5, 0.5, k)
    special = rng.uniform(size=k) < 0.3
    grid = np.array(LAMS + (0.25, 0.75))
    lam_s = np.where(rng.uniform(size=k) < 0.5, rng.choice(grid, k),
                     rng.uniform(size=k))
    lam_e = np.where(rng.uniform(size=k) < 0.5, rng.choice(grid, k),
                     rng.uniform(size=k))
    r2 = r * r
    inv_r = 1.0 / np.sqrt(r2)
    e_j, c_j = jax_terms_alch(spec_j, *(jnp.asarray(a) for a in (
        r2, inv_r, r2 * inv_r, sig, eps, qq, special)), jnp.float64,
        jnp.asarray(lam_s), jnp.asarray(lam_e))
    e, c = pair_kernel._pair_terms_alch(spec, *(torch.as_tensor(a) for a in (
        r2, sig, eps, qq, special, lam_s, lam_e)))
    if coul == "ewald-scaled":
        assert max_rel(e_j, e) < POLY and max_rel(c_j, c) < POLY
    else:
        assert _elem_rel(e_j, e) < TERMS
        assert _elem_rel(c_j, c) < TERMS


def _place(n, boundary, seed, min_dist=0.3):
    """n points uniform in the cell, at least min_dist apart."""
    rng = np.random.default_rng(seed)
    h = np64(boundary.box_matrix())
    pts = []
    while len(pts) < n:
        c = torch.as_tensor(rng.uniform(0.0, 1.0, 3) @ h)
        if pts:
            d = torch.linalg.vector_norm(boundary.displacement(
                torch.stack(pts), c[None, :]), dim=1)
            if float(d.min()) <= min_dist:
                continue
        pts.append(c)
    return torch.stack(pts).numpy()


def _box(name, pkg):
    """A 3.0 nm cube or a 3.0 nm 92/95/88 degree box."""
    if name == "cube":
        return (mt.cubic(3.0, dtype=jnp.float64) if pkg is mt
                else pt.cubic(3.0, dtype=torch.float64, device=CPU))
    rad = [math.radians(a) for a in (92.0, 95.0, 88.0)]
    if pkg is mt:
        return mt.triclinic_from_lengths_angles((3.0,) * 3, rad,
                                                dtype=jnp.float64)
    return pt.triclinic_from_lengths_angles((3.0,) * 3, rad,
                                            dtype=torch.float64, device=CPU)


@functools.lru_cache(maxsize=None)
def _fluid(box):
    """The mixed-role fluid of tests/test_kernel_consistency.py:296-315 (4
    INSERT, 4 DELETE, the rest CORE atoms; sigma 0.3, eps 0.2, seeded
    charges), with every fifth atom hydrogen-like (eps 0), 1-4 and excluded
    pairs and pairs outside the bitmap window (|j - i| > 31)."""
    pb = _box(box, pt)
    coords = _place(N, pb, 21)
    d = torch.linalg.vector_norm(pb.displacement(
        torch.as_tensor(coords)[:, None, :],
        torch.as_tensor(coords)[None, :, :]), dim=-1).numpy()
    far = [(a, b) for a, b in zip(*np.nonzero((d > 0.05) & (d < 0.7)))
           if b - a > 31][:6]
    assert len(far) == 6
    excl = [(0, 1), (9, 10), (4, 5)] + [(i, i + 1) for i in range(20, 40)] \
        + far[:3]
    spec = [(2, 6), (0, 3)] + [(i, i + 3) for i in range(40, 60, 2)] \
        + far[3:]
    rng = np.random.default_rng(22)
    q = rng.uniform(-0.4, 0.4, N)
    q -= q.mean()
    eps = np.full(N, 0.2)
    eps[::5] = 0.0
    roles = np.zeros(N, dtype=np.int32)
    roles[:4] = 1
    roles[4:8] = 2
    return coords, excl, spec, q, eps, roles


def _jax_atoms(box, lam):
    coords, excl, spec, q, eps, roles = _fluid(box)
    return mt.make_atoms(n=N, mass=10.0, sigma=0.3, epsilon=jnp.asarray(eps),
                         charge=jnp.asarray(q), lam=lam,
                         alch_role=jnp.asarray(roles), dtype=jnp.float64)


def _port_atoms(box, lam):
    coords, excl, spec, q, eps, roles = _fluid(box)
    return pt.make_atoms(n=N, mass=10.0, sigma=0.3, epsilon=eps, charge=q,
                         lam=lam, alch_role=roles, dtype=torch.float64,
                         device=CPU)


@functools.lru_cache(maxsize=None)
def _jax_runners(box, lj, coul, sched="DefaultLambdaScheduler"):
    """(pallas(atoms), dense(atoms)) jitted once per box and combination,
    so the five lambdas reuse one compilation."""
    coords, excl, spec, q, eps, roles = _fluid(box)
    jb = _box(box, mt)
    jc = jnp.asarray(coords)
    jexcl = mt.Exclusions.build(N, excl_pairs=excl, special_pairs=spec)
    atoms = _jax_atoms(box, 1.0)
    finder = JaxBlockPairFinder.setup(jb, LIST, N, coords=jc, atoms=atoms,
                                      block=32, lanes=128)
    nbs = finder.find(jc, jb, jexcl)
    assert int(nbs.overflow) == 0
    spec_j = jax_build_fused_spec(_inters(mt, lj, coul, sched=sched))
    pal = jax.jit(lambda a: pallas_block_nonbonded(
        spec_j, jc, jb, a, jexcl, nbs, finder, compute_energy=True))
    inters = _inters(mt, lj, coul, un=False, sched=sched)

    def dense(a):
        s = mt.System(atoms=a, coords=jc, boundary=jb,
                      pairwise_inters=inters, exclusions=jexcl)
        return mt.forces_virial(s, needs_virial=True), mt.potential_energy(s)
    return pal, jax.jit(dense)


def _port(box, lj, coul, lam, list_lam=None, sched="DefaultLambdaScheduler"):
    """The twin through block_nonbonded at ``lam``, on a list built while
    the atoms held ``list_lam`` (default: the same lambda)."""
    coords, excl, spec, q, eps, roles = _fluid(box)
    pb = _box(box, pt)
    pexcl = pt.Exclusions.build(N, excl, spec, device=CPU)
    pc = torch.as_tensor(coords)
    built = _port_atoms(box, lam if list_lam is None else list_lam)
    nb = BlockPairFinder.setup(pb, LIST, N, built).find(pc, pb, pexcl)
    return pair_kernel.block_nonbonded(
        pair_kernel.build_fused_spec(_inters(pt, lj, coul, sched=sched)), pc,
        pb, _port_atoms(box, lam), pexcl, nb, compute_energy=True)


#: (lj, coul, dense force tolerance, dense energy tolerance, Pallas
#: tolerance, lambdas)
LIST_CASES = {
    "beutler-ewald": ("beutler", "sc-beutler-ewald", 2e-5, 1e-6, EXACT,
                      LAMS),
    "gapsys": ("gapsys", "sc-gapsys", 1e-6, 1e-6, EXACT, (0.25, 0.5, 0.75)),
    "gapsys-ewald": ("gapsys", "sc-gapsys-ewald", 2e-5, 1e-6, EXACT,
                     (0.3, 0.8)),
    "lj-scaled-ewald": ("lj", "ewald-scaled", 1e-5, 1e-5, POLY, (0.6,)),
}


@pytest.mark.parametrize("box, case, lam", [
    (box, case, lam) for case, c in LIST_CASES.items() for lam in c[5]
    for box in ("cube", "skewed")
    if box == "cube" or case == "beutler-ewald"])
def test_twin_matches_pallas_and_dense(box, case, lam):
    """Forces, energy and virial over the cluster-pair list at every
    lambda; the virial against the Pallas kernel (the dense path has its
    own form)."""
    lj, coul, tol_f, tol_e, tol_pal, _ = LIST_CASES[case]
    pal, dense = _jax_runners(box, lj, coul)
    atoms = _jax_atoms(box, lam)
    f_pal, e_pal, v_pal = pal(atoms)
    (f_ref, _), e_ref = dense(atoms)
    f, e, v = _port(box, lj, coul, lam)
    scale = max(1.0, abs(float(e_pal)))
    assert max_rel(f_pal, f) < tol_pal
    assert max_rel(v_pal, v) < tol_pal
    assert abs(float(e) - float(e_pal)) < tol_pal * scale
    assert max_rel(f_ref, f) < tol_f
    assert abs(float(e) - float(e_ref)) < tol_e * max(1.0, abs(float(e_ref)))


SCHEDULERS = ("DefaultLambdaScheduler", "NAMDLambdaScheduler",
              "QuartersLambdaScheduler", "EleScaledLambdaScheduler")


@pytest.mark.parametrize("sched", SCHEDULERS[1:])
@pytest.mark.parametrize("lam", [0.4, 0.7])
def test_schedulers_match_pallas(sched, lam):
    """Each scheduler's per-pair scales through the list: the twin against
    the Pallas kernel, Beutler LJ + soft-core Ewald, INSERT and DELETE
    atoms between their schedule's breakpoints."""
    pal, _ = _jax_runners("cube", "beutler", "sc-beutler-ewald", sched)
    f_pal, e_pal, v_pal = pal(_jax_atoms("cube", lam))
    f, e, v = _port("cube", "beutler", "sc-beutler-ewald", lam, sched=sched)
    assert max_rel(f_pal, f) < EXACT and max_rel(v_pal, v) < EXACT
    assert abs(float(e) - float(e_pal)) < EXACT * max(1.0, abs(float(e_pal)))


@pytest.mark.parametrize("case", ["beutler-ewald", "lj-scaled-ewald"])
def test_lambda_is_read_per_call(case):
    """A list built while the atoms held lambda 0.2, used at lambda 0.8,
    gives what a list built at 0.8 gives: neither the (lambda, role) rows
    nor the scaled charges are packed at rebuild. A plain call on the same
    list afterwards still sees the unscaled charges."""
    lj, coul = LIST_CASES[case][:2]
    f1, e1, v1 = _port("cube", lj, coul, 0.8)
    f2, e2, v2 = _port("cube", lj, coul, 0.8, list_lam=0.2)
    assert torch.equal(f1, f2) and torch.equal(v1, v2)
    assert float(e1) == float(e2)
    coords, excl, spec, q, eps, roles = _fluid("cube")
    pb = _box("cube", pt)
    pexcl = pt.Exclusions.build(N, excl, spec, device=CPU)
    pc = torch.as_tensor(coords)
    atoms = _port_atoms("cube", 0.2)
    nb = BlockPairFinder.setup(pb, LIST, N, atoms).find(pc, pb, pexcl)
    plain = pair_kernel.build_fused_spec(_inters(pt, "lj", "none") + (
        pt.CoulombEwald(dist_cutoff=RC, alpha=3.0, weight_special=0.8333),))
    ref = pair_kernel.block_nonbonded(plain, pc, pb, atoms, pexcl, nb, True)
    pair_kernel.block_nonbonded(pair_kernel.build_fused_spec(
        _inters(pt, lj, coul)), pc, pb, atoms, pexcl, nb, True)
    after = pair_kernel.block_nonbonded(plain, pc, pb, atoms, pexcl, nb,
                                        True)
    assert all(torch.equal(a, b) for a, b in zip(ref, after))


@pytest.mark.parametrize("case", ["beutler-ewald", "plain"])
def test_live_pair_count_is_the_kernels_work(case):
    """The bound's work count against a brute-force count over all atom
    pairs at lambda 0.3: every pair inside cut_max that the bitmaps do not
    exclude (far-window exclusions are evaluated, then corrected), and of
    those the pairs that take the LJ term (eps != 0 inside the LJ radius;
    on the soft-core path also lambda_s > 0, which DELETE pairs lack
    below lambda 0.5). Exact counts."""
    from mollytpu_torch.free_energy import alchemy
    coords, excl, spec14, q, eps, roles = _fluid("cube")
    pb = _box("cube", pt)
    atoms = _port_atoms("cube", 0.3)
    pc = torch.as_tensor(coords)
    nb = BlockPairFinder.setup(pb, LIST, N, atoms).find(
        pc, pb, pt.Exclusions.build(N, excl, spec14, device=CPU))
    inters = (_inters(pt, "beutler", "sc-beutler-ewald")
              if case == "beutler-ewald"
              else _inters(pt, "lj", "sc-beutler-ewald")[:1]
              + (pt.CoulombEwald(dist_cutoff=RC, alpha=3.0),))
    spec = pair_kernel.build_fused_spec(inters)
    nbk, lam_role, _ = pair_kernel.kernel_inputs(spec, pc, atoms, nb)
    pairs, lj_pairs = pair_kernel.live_pair_count(spec, nbk, pb, N, lam_role)

    i, j = np.triu_indices(N, k=1)
    r = np64(torch.linalg.vector_norm(pb.displacement(pc[i], pc[j]), dim=1))
    windowed = {(a, b) for a, b in excl if b - a <= 31}
    live = (r < spec.cut_max) & np.array(
        [(a, b) not in windowed for a, b in zip(i, j)])
    lj = live & (eps[i] * eps[j] != 0) & (r < spec.lj_rc)
    if spec.needs_lam:
        ti, tj = torch.as_tensor(roles[i]), torch.as_tensor(roles[j])
        lam_s = np64(alchemy.sterics_lambda(
            spec.scheduler, torch.full((len(i),), 0.3), ti, tj))
        lj &= lam_s > 0
        assert int(lj.sum()) < int((live & (eps[i] * eps[j] != 0)).sum())
    assert (pairs, lj_pairs) == (float(live.sum()), float(lj.sum()))


def test_lambda_rows_layout():
    """(lambda, role) per sorted slot in the slots' dtype, zero for the
    padding slots."""
    coords, excl, spec, q, eps, roles = _fluid("cube")
    pb = _box("cube", pt)
    atoms = _port_atoms("cube", 0.3)
    nb = BlockPairFinder.setup(pb, LIST, N, atoms).find(
        torch.as_tensor(coords), pb, pt.Exclusions.build(N, device=CPU))
    rows = pair_kernel.lambda_rows(atoms, nb)
    assert rows.shape == (nb.pos4.shape[0], 2)
    assert rows.dtype == torch.float64 and rows.is_contiguous()
    ids = nb.ids.long()
    real = ids < N
    assert torch.all(rows[~real] == 0)
    assert torch.all(rows[real, 0] == 0.3)
    assert torch.equal(rows[real, 1], torch.as_tensor(
        roles, dtype=torch.float64)[ids[real]])


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_pme_with_scheduler_matches_jax(sched):
    """PME on the scaled charges: energy, forces and virial against the
    JAX PME with the same scheduler (scatter mesh), 1e-10 relative."""
    rng = np.random.default_rng(5)
    n = 120
    coords = rng.uniform(0.0, 3.0, (n, 3))
    q = rng.uniform(-0.8, 0.8, n)
    q -= q.mean()
    lam = rng.uniform(0.0, 1.0, n)
    roles = rng.integers(0, 3, n).astype(np.int32)
    ja = mt.make_atoms(n=n, charge=jnp.asarray(q), lam=jnp.asarray(lam),
                       alch_role=jnp.asarray(roles), dtype=jnp.float64)
    pa = pt.make_atoms(n=n, charge=q, lam=lam, alch_role=roles,
                       dtype=torch.float64, device=CPU)
    jb = mt.cubic(3.0, dtype=jnp.float64)
    pb = pt.cubic(3.0, dtype=torch.float64, device=CPU)
    jp = JaxPME.setup(jb, dist_cutoff=1.0, dtype=jnp.float64,
                      scheduler=_scheduler(mt, sched))
    jp = dataclasses.replace(jp, mesh_method="scatter")
    pp = PME.setup(pb, dist_cutoff=1.0, dtype=torch.float64,
                   scheduler=_scheduler(pt, sched))
    jc, pc = jnp.asarray(coords), torch.as_tensor(coords)
    e_j, (f_j, v_j) = jax.jit(lambda c: (
        jp.energy(c, jb, ja), jp.force_virial(c, jb, ja,
                                              needs_virial=True)))(jc)
    e_p = pp.energy(pc, pb, pa)
    f_p, v_p = pp.force_virial(pc, pb, pa, needs_virial=True)
    assert float(e_p) == pytest.approx(float(e_j), rel=1e-10, abs=1e-10)
    assert max_rel(f_j, f_p) < 1e-10 and max_rel(v_j, v_p) < 1e-10
    # the scheduler changes the sum: at these lambdas it scales charges
    e_plain = PME.setup(pb, dist_cutoff=1.0, dtype=torch.float64).energy(
        pc, pb, pa)
    assert abs(float(e_plain) - float(e_p)) > 1.0
