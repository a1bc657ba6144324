"""The general pair path against the JAX package, float64 on the CPU: every
pairwise interaction through the dense engine and the neighbor-table
engine (ops/nonbonded.py), in an orthorhombic and a triclinic box (and an
open box for the dense engine), every mixing rule and cutoff, NBFix
tables, the safe-where cases, DPD's noise and force, and the repaired
use_neighbors dispatch of forces.py.

Tolerances: energies within 1e-10 relative; forces and virial within 1e-8
of rms|F| (the same formulas, in another summation order). DPD's float32
uniforms are bit for bit JAX's; its Box-Muller transform is evaluated
with correctly rounded float64 log, sqrt and cos, where XLA's float32 log
and cos are approximations of its own, so xi agrees to 3 ulp of float32,
and the DPD forces are compared on JAX's xi.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.ops import nonbonded as jnb
from mollytpu.ops.cutoffs import cutoff_distance as jax_cutoff_distance
from mollytpu.ops.neighbors import find_neighbors as jax_find_neighbors

import mollytpu_torch as pt
from mollytpu_torch.ops import nonbonded as tnb
from mollytpu_torch.ops import pair_kernel
from torch_parity import CPU, jax_xi, np64, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL_E, REL_F = 1e-10, 1e-8
#: atoms, and the neighbor table's width: (N, N) tables give the neighbor
#: engine the dense engine's shapes, so JAX's eager evaluation compiles
#: each operation once for both
N = 40
RC = 0.9
LIST = 1.05

#: name -> the interaction's keyword arguments, with the cutoff (an
#: object of either package) as a (class name, args) pair; RC everywhere
#: a radius is taken, so the neighbor table (LIST) holds every pair
POTENTIALS = {
    "LennardJones": dict(cutoff=("DistanceCutoff", RC), weight_special=0.5),
    "LennardJonesSoftCoreBeutler": dict(cutoff=("DistanceCutoff", RC),
                                        alpha=0.5, weight_special=0.5),
    "LennardJonesSoftCoreGapsys": dict(cutoff=("ShiftedForceCutoff", RC),
                                       alpha=0.85, weight_special=0.5),
    "AshbaughHatch": dict(cutoff=("ShiftedPotentialCutoff", RC),
                          weight_special=0.5),
    "SoftSphere": dict(cutoff=("DistanceCutoff", RC)),
    "Mie": dict(m=5.0, n=10.0, cutoff=("DistanceCutoff", RC),
                weight_special=0.5),
    "Buckingham": dict(cutoff=("ShiftedForceCutoff", RC),
                       weight_special=0.5),
    "DoubleExponential": dict(alpha=16.5, beta=4.5,
                              cutoff=("DistanceCutoff", RC),
                              weight_special=0.5),
    "DoubleExponentialSoftCore": dict(alpha=16.5, beta=4.5,
                                      cutoff=("DistanceCutoff", RC),
                                      weight_special=0.5),
    "Gravity": dict(G=3.0, cutoff=("DistanceCutoff", RC)),
    "Coulomb": dict(cutoff=("DistanceCutoff", RC), weight_special=0.8333),
    "CoulombScaled": dict(cutoff=("DistanceCutoff", RC),
                          weight_special=0.8333),
    "CoulombReactionField": dict(dist_cutoff=RC, weight_special=0.8333),
    "CoulombReactionFieldScaled": dict(dist_cutoff=RC,
                                       weight_special=0.8333),
    "CoulombEwald": dict(dist_cutoff=RC, alpha=3.0, weight_special=0.8333),
    "CoulombEwaldScaled": dict(dist_cutoff=RC, alpha=3.0,
                               approximate_erfc=False),
    "CoulombSoftCoreBeutler": dict(cutoff=("DistanceCutoff", RC), alpha=0.5,
                                   weight_special=0.8333),
    "CoulombSoftCoreGapsys": dict(cutoff=("DistanceCutoff", RC), alpha=0.3,
                                  weight_special=0.8333),
    "CoulombSoftCoreBeutlerEwald": dict(dist_cutoff=RC, alpha_sc=0.5,
                                        alpha=3.0, weight_special=0.8333),
    "CoulombSoftCoreGapsysEwald": dict(dist_cutoff=RC, alpha_sc=0.3,
                                       alpha=3.0),
    "CoulombSoftCoreBeutlerReactionField": dict(dist_cutoff=RC, alpha=0.5,
                                                weight_special=0.8333),
    "CoulombSoftCoreGapsysReactionField": dict(dist_cutoff=RC,
                                               weight_special=0.8333),
    "Yukawa": dict(cutoff=("DistanceCutoff", RC), kappa=2.0,
                   weight_special=0.8333),
    "DPDInteraction": dict(a=25.0, gamma=4.5, sigma=3.0, r_c=RC, dt=0.01),
}

#: boxes: a 2.3 nm cube, a 2.4 nm 95/100/85 degree cell, and none
BOXES = ("ortho", "triclinic", "open")


def build(mod, name, use_neighbors=True, **over):
    """The interaction ``name`` of ``mod`` (mollytpu or mollytpu_torch)."""
    kw = dict(POTENTIALS[name], **over)
    if isinstance(kw.get("cutoff"), tuple):
        cname, *args = kw["cutoff"]
        kw["cutoff"] = getattr(mod, cname)(*args)
    kw["use_neighbors"] = use_neighbors
    return getattr(mod, name)(**kw)


@functools.lru_cache(maxsize=None)
def system(box, n=N, seed=3):
    """n atoms at least 0.2 nm apart with random parameters, 1-2 / 1-3
    exclusions and 1-4 pairs along index chains, a few alchemical atoms
    of both roles, and random velocities: (numpy arrays, exclusion
    pairs)."""
    rng = np.random.default_rng(seed)
    if box == "ortho":
        basis = np.diag([2.3, 2.3, 2.3])
    elif box == "triclinic":
        basis = np.asarray(jax.device_get(mt.triclinic_from_lengths_angles(
            (2.4, 2.4, 2.4), np.radians((95.0, 100.0, 85.0)),
            dtype=jnp.float64).basis))
    else:
        basis = np.diag([1.6, 1.6, 1.6])
    pts = []
    while len(pts) < n:
        c = rng.uniform(0.0, 1.0, 3) @ basis
        if box != "open" and pts:
            d = np.asarray(jax.device_get(_jax_box(box).displacement(
                jnp.asarray(np.array(pts)), jnp.asarray(c))))
            if np.min(np.linalg.norm(d, axis=1)) < 0.2:
                continue
        elif pts and np.min(np.linalg.norm(np.array(pts) - c, axis=1)) < 0.2:
            continue
        pts.append(c)
    params = dict(
        mass=rng.uniform(10.0, 20.0, n), charge=rng.uniform(-0.6, 0.6, n),
        sigma=rng.uniform(0.25, 0.35, n), epsilon=rng.uniform(0.2, 1.0, n),
        lam=np.where(np.arange(n) < 8, rng.uniform(0.0, 1.0, n), 1.0),
        alch_role=np.where(np.arange(n) < 4, 1,
                           np.where(np.arange(n) < 8, 2, 0)),
        atom_type=rng.integers(0, 4, n),
        buck_A=rng.uniform(1e5, 3e5, n), buck_B=rng.uniform(25.0, 40.0, n),
        buck_C=rng.uniform(1e-3, 3e-3, n))
    params["epsilon"][5] = 0.0     # a hydrogen-like atom
    excl = [(i, i + 1) for i in range(0, 20)] + [(i, i + 2)
                                                  for i in range(0, 20)]
    spec = [(i, i + 3) for i in range(0, 20)]
    vels = rng.normal(size=(n, 3))
    return np.array(pts), basis, params, excl, spec, vels


def _jax_box(box):
    if box == "ortho":
        return mt.cubic(2.3, dtype=jnp.float64)
    if box == "triclinic":
        return mt.triclinic_from_lengths_angles(
            (2.4, 2.4, 2.4), np.radians((95.0, 100.0, 85.0)),
            dtype=jnp.float64)
    return mt.rectangular([np.inf] * 3, dtype=jnp.float64)


def _port_box(box):
    if box == "ortho":
        return pt.cubic(2.3, dtype=torch.float64, device=CPU)
    if box == "triclinic":
        return pt.Triclinic(torch.as_tensor(np64(_jax_box(box).basis)))
    return pt.rectangular([np.inf] * 3, dtype=torch.float64, device=CPU)


def inputs(box):
    """(JAX (atoms, coords, boundary, exclusions, velocities), the port's
    the same)."""
    pts, _, p, excl, spec, vels = system(box)
    ja = mt.make_atoms(n=N, dtype=jnp.float64, **p)
    ta = pt.make_atoms(n=N, dtype=torch.float64, device=CPU, **p)
    jx = mt.Exclusions.build(N, excl, spec)
    tx = pt.Exclusions.build(N, excl, spec, device=CPU)
    return ((ja, jnp.asarray(pts), _jax_box(box), jx, jnp.asarray(vels)),
            (ta, torch.as_tensor(pts), _port_box(box), tx,
             torch.as_tensor(vels)))


@pytest.fixture
def jax_noise(monkeypatch):
    """The port's DPD forces on JAX's xi."""
    monkeypatch.setattr(pt.DPDInteraction, "_xi",
                        lambda self, i, j, step_n: jax_xi(self.seed, i, j,
                                                          step_n))


def assert_match(ref, ours, rms_of):
    """Forces or a virial within REL_F of rms|F| (at least 1)."""
    ref, ours = np64(ref), np64(ours)
    scale = max(1.0, float(np.sqrt((np64(rms_of) ** 2).sum(axis=1).mean())))
    assert np.max(np.abs(ref - ours)) / scale < REL_F


def assert_energy(ref, ours):
    ref, ours = float(ref), float(ours)
    assert abs(ref - ours) <= REL_E * max(1.0, abs(ref))


def run_both(jinters, tinters, engine, box, step_n=3):
    """(JAX, port) (energy, forces, virial) on the same inputs."""
    (ja, jc, jb, jx, jv), (ta, tc, tb, tx, tv) = inputs(box)
    if engine == "dense":
        jm, tm = jnb.dense_pair_mask(N, jx), tnb.dense_pair_mask(N, tx)
        ej = jnb.dense_energy(jinters, ja, jc, jb, jm)
        fj, vj = jnb.dense_forces(jinters, ja, jc, jb, jm, velocities=jv,
                                  step_n=step_n, needs_virial=True)
        et = tnb.dense_energy(tinters, ta, tc, tb, tm)
        ft, vt = tnb.dense_forces(tinters, ta, tc, tb, tm, velocities=tv,
                                  step_n=step_n, needs_virial=True)
        return (ej, fj, vj), (et, ft, vt)
    jnbs = jax_find_neighbors(mt.DistanceNeighborFinder(LIST, 1, N), jc,
                              jb, jx)
    tnbs = pt.find_neighbors(pt.DistanceNeighborFinder(LIST, 1, N), tc, tb,
                             tx)
    assert int(tnbs.overflow) == 0
    np.testing.assert_array_equal(np.asarray(jnbs.idx), tnbs.idx.numpy())
    ej = jnb.neighbor_energy(jinters, ja, jc, jb, jnbs)
    fj, vj = jnb.neighbor_forces(jinters, ja, jc, jb, jnbs, velocities=jv,
                                 step_n=step_n, needs_virial=True)
    et = tnb.neighbor_energy(tinters, ta, tc, tb, tnbs)
    ft, vt = tnb.neighbor_forces(tinters, ta, tc, tb, tnbs, velocities=tv,
                                 step_n=step_n, needs_virial=True)
    return (ej, fj, vj), (et, ft, vt)


CASES = [(name, engine, box) for name in POTENTIALS
         for engine in ("dense", "neighbor") for box in BOXES
         if not (engine == "neighbor" and box == "open")]


@pytest.mark.parametrize("name, engine, box", CASES)
def test_potential_matches_jax(name, engine, box, jax_noise):
    (ej, fj, vj), (et, ft, vt) = run_both(
        (build(mt, name),), (build(pt, name),), engine, box)
    assert np.isfinite(np64(ft)).all()
    assert_energy(ej, et)
    assert_match(fj, ft, fj)
    assert_match(vj, vt, fj)


MIXINGS = ("LorentzMixing", "GeometricMixing", "WaldmanHaglerMixing",
           "FenderHalseyMixing", "InverseMixing")


@pytest.mark.parametrize("rule", MIXINGS)
def test_mixing_rule_matches_jax(rule):
    """Each rule as the sigma and the epsilon mixing of LJ, through the
    neighbor engine, and the rule's values themselves."""
    rng = np.random.default_rng(5)
    x, y = rng.uniform(0.2, 1.0, 50), rng.uniform(0.2, 1.0, 50)
    jr, tr = getattr(mt, rule)(), getattr(pt, rule)()
    if rule == "WaldmanHaglerMixing":
        pairs = [(jr.mix_sigma(x, y), tr.mix_sigma(*map(torch.as_tensor,
                                                         (x, y)))),
                 (jr.mix_epsilon(x, y, y, x), tr.mix_epsilon(
                     *map(torch.as_tensor, (x, y, y, x))))]
    else:
        pairs = [(jr.mix(x, y), tr.mix(torch.as_tensor(x),
                                       torch.as_tensor(y)))]
    for a, b in pairs:
        np.testing.assert_allclose(np64(b), np64(a), rtol=1e-14)
    (ej, fj, vj), (et, ft, vt) = run_both(
        (build(mt, "LennardJones", sigma_mixing=jr, epsilon_mixing=jr),),
        (build(pt, "LennardJones", sigma_mixing=tr, epsilon_mixing=tr),),
        "neighbor", "ortho")
    assert_energy(ej, et)
    assert_match(fj, ft, fj)
    assert_match(vj, vt, fj)


def test_minimum_lambda_mixing_and_nbfix_match_jax():
    """MinimumMixing's values, and an NBFix table (MixingException over
    Lorentz / geometric, type pairs in both orders, a later entry
    overriding an earlier one) through both engines."""
    a = np.array([0.2, 0.7, 1.3]), np.array([0.5, 0.1, 1.5])
    np.testing.assert_array_equal(
        np64(pt.MinimumMixing.mix(*map(torch.as_tensor, a))),
        np64(mt.MinimumMixing.mix(*a)))
    table = dict(keys_i=(0, 2, 1), keys_j=(1, 2, 0))

    def rules(mod, sig, eps):
        return dict(
            sigma_mixing=mod.MixingException(mod.LorentzMixing(),
                                             mod.ExceptionTable(
                                                 values=sig, **table)),
            epsilon_mixing=mod.MixingException(mod.GeometricMixing(),
                                               mod.ExceptionTable(
                                                   values=eps, **table)))

    for engine in ("dense", "neighbor"):
        (ej, fj, vj), (et, ft, vt) = run_both(
            (build(mt, "LennardJones",
                   **rules(mt, (0.31, 0.27, 0.33), (0.4, 1.2, 0.9))),),
            (build(pt, "LennardJones",
                   **rules(pt, (0.31, 0.27, 0.33), (0.4, 1.2, 0.9))),),
            engine, "ortho")
        assert_energy(ej, et)
        assert_match(fj, ft, fj)
        assert_match(vj, vt, fj)


CUTOFFS = {"NoCutoff": (), "DistanceCutoff": (RC,),
           "ShiftedPotentialCutoff": (RC,), "ShiftedForceCutoff": (RC,),
           "CubicSplineCutoff": (0.7, RC), "PolynomialCutoff": (0.7, RC)}


@pytest.mark.parametrize("cutoff", CUTOFFS)
def test_cutoff_matches_jax(cutoff):
    """Each cutoff on LJ + Yukawa through the dense engine (every pair,
    so NoCutoff is exact too)."""
    args = CUTOFFS[cutoff]
    (ej, fj, vj), (et, ft, vt) = run_both(
        tuple(build(mt, name, cutoff=getattr(mt, cutoff)(*args))
              for name in ("LennardJones", "Yukawa")),
        tuple(build(pt, name, cutoff=getattr(pt, cutoff)(*args))
              for name in ("LennardJones", "Yukawa")), "dense", "ortho")
    assert_energy(ej, et)
    assert_match(fj, ft, fj)
    assert_match(vj, vt, fj)
    assert (pt.cutoff_distance(getattr(pt, cutoff)(*args))
            == jax_cutoff_distance(getattr(mt, cutoff)(*args)))


def _views(p, i, j, mod):
    """Per-pair atom views of the system's parameters at atoms i and j:
    JAX's as scalars (vmap), the port's as tensors."""
    if mod is mt:
        a = mt.make_atoms(n=N, dtype=jnp.float64, **p)
        return a.view(i), a.view(j)
    a = pt.make_atoms(n=N, dtype=torch.float64, device=CPU, **p)

    def view(idx):
        return pt.Atoms(*(None if t is None else t[torch.as_tensor(idx)]
                          for t in (getattr(a, f.name)
                                    for f in dataclasses.fields(a))))
    return view(i), view(j)


SAFE_WHERE = {
    # r exactly at the cutoff, on every cutoff kind
    "at-cutoff": dict(r=RC, zero=None, lam=None),
    # zero sigma, epsilon, and lambda
    "zero-sigma": dict(r=0.4, zero="sigma", lam=None),
    "zero-epsilon": dict(r=0.4, zero="epsilon", lam=None),
    "zero-lambda": dict(r=0.4, zero=None, lam=0.0),
    # the Gapsys soft cores at lambda 1, where their radius is exactly 0
    "gapsys-lambda-1": dict(r=0.4, zero=None, lam=1.0),
}


def _safe_where_cases(name):
    """The safe-where cases that reach a masked branch of ``name``: at the
    cutoff, the forms that clip r at their dist_cutoff themselves (those
    with a ``cutoff`` go through its ``apply``, which LJ holds with every
    kind); zero sigma / epsilon where a shortcut or the sigma mixing of a
    soft core reads them; zero lambda where lambda enters; lambda 1 for
    the Gapsys soft cores, whose radius is 0 there."""
    cases = set()
    if "cutoff" not in POTENTIALS[name] or name == "LennardJones":
        cases.add("at-cutoff")
    if (("Coulomb" not in name or "Beutler" in name)
            and name not in ("Gravity", "Buckingham", "Yukawa")):
        cases |= {"zero-sigma", "zero-epsilon"}
    if "SoftCore" in name or "Scaled" in name or name == "AshbaughHatch":
        cases.add("zero-lambda")
    if "Gapsys" in name:
        cases.add("gapsys-lambda-1")
    return cases


@pytest.mark.parametrize("case", SAFE_WHERE)
def test_safe_where_cases_match_jax(case):
    """Energy and dU/dr of every potential at the cases where a masked
    branch is infinite or undefined: finite, and equal to JAX's."""
    c = SAFE_WHERE[case]
    _, _, p, *_ = system("ortho")
    p = {k: np.array(v) for k, v in p.items()}
    i, j = np.arange(10, 20), np.arange(20, 30)
    if c["zero"]:
        p[c["zero"]][i] = 0.0
    if c["lam"] is not None:
        p["lam"][:] = c["lam"]
        p["alch_role"][i] = 1
    ji, jj = _views(p, i, j, mt)
    ti, tj = _views(p, i, j, pt)
    special = np.zeros(len(i), bool)
    special[::3] = True
    # each potential the case concerns, with its own cutoff; at the
    # cutoff, LJ with every kind that differentiates u or clips r too
    variants = [(name, {}) for name in POTENTIALS
                if name != "DPDInteraction" and case in _safe_where_cases(name)]
    if case == "at-cutoff":
        variants += [("LennardJones", dict(cutoff=cut)) for cut in (
            ("ShiftedPotentialCutoff", RC), ("ShiftedForceCutoff", RC),
            ("CubicSplineCutoff", 0.7, RC), ("PolynomialCutoff", 0.7, RC))]
    for name, over in variants:
        jint, tint = build(mt, name, **over), build(pt, name, **over)
        r = np.full(len(i), c["r"])

        def e_one(rr, a, b, s):
            return jint.energy(rr, a, b, s)

        e_j = jax.vmap(e_one)(jnp.asarray(r), ji, jj, jnp.asarray(special))
        g_j = jax.vmap(jax.grad(e_one))(jnp.asarray(r), ji, jj,
                                        jnp.asarray(special))
        rt = torch.as_tensor(r).requires_grad_(True)
        e_t = tint.energy(rt, ti, tj, torch.as_tensor(special))
        (g_t,) = torch.autograd.grad(e_t.sum(), rt)
        label = f"{name} {over}"
        assert np.isfinite(np64(g_t)).all(), label
        np.testing.assert_allclose(np64(e_t), np64(e_j), rtol=REL_E,
                                   atol=1e-12, err_msg=label)
        np.testing.assert_allclose(np64(g_t), np64(g_j), rtol=1e-9,
                                   atol=1e-9, err_msg=label)


def test_dpd_uniforms_bit_for_bit_and_xi_within_3_ulp():
    """The hash's float32 uniforms equal JAX's bit for bit; xi equals it
    to 3 ulp (the Box-Muller step, see the module docstring), and most of
    the values bit for bit."""
    rng = np.random.default_rng(11)
    i = rng.integers(0, 50_000, 20_000)
    j = rng.integers(0, 50_000, 20_000)
    d = pt.DPDInteraction()
    for step in (0, 17, 2 ** 31 + 5):
        lo, hi = np.minimum(i, j).astype(np.uint32), np.maximum(i, j)
        h = np.uint32(d.seed)
        with np.errstate(over="ignore"):
            for v in (lo, hi.astype(np.uint32),
                      np.uint32(step & 0xFFFFFFFF)):
                h = (h ^ v) * np.uint32(0x85EBCA6B)
                h = (h ^ (h >> np.uint32(13))) * np.uint32(0xC2B2AE35)
                h = h ^ (h >> np.uint32(16))
            h2 = (h ^ np.uint32(0x68E31DA4)) * np.uint32(0x85EBCA6B)
            h2 = (h2 ^ (h2 >> np.uint32(13))) * np.uint32(0xC2B2AE35)
        # the uniforms as the JAX package forms them
        u1_j = np.asarray((jnp.asarray(h).astype(jnp.float32) + 1.0)
                          / 4294967296.0)
        u2_j = np.asarray(jnp.asarray(h2).astype(jnp.float32) / 4294967296.0)
        u1, u2 = pt.ops.pairwise.dpd_uniforms(
            d.seed, torch.as_tensor(i), torch.as_tensor(j), step)
        np.testing.assert_array_equal(u1.numpy(), u1_j)
        np.testing.assert_array_equal(u2.numpy(), u2_j)
        xi_j = np.asarray(mt.DPDInteraction()._xi(jnp.asarray(i),
                                                  jnp.asarray(j), step))
        xi = d._xi(torch.as_tensor(i), torch.as_tensor(j), step).numpy()
        ulp = np.abs(xi.view(np.int32).astype(np.int64)
                     - xi_j.view(np.int32).astype(np.int64))
        assert ulp.max() <= 3 and np.mean(ulp == 0) > 0.85


def test_dpd_force_vec_matches_jax(jax_noise):
    """force_vec per pair, against JAX's vmapped force_vec."""
    pts, _, p, _, _, vels = system("ortho")
    rng = np.random.default_rng(2)
    i, j = rng.integers(0, N, 300), rng.integers(0, N, 300)
    dr = pts[j] - pts[i]
    r = np.linalg.norm(dr, axis=1)
    spec = np.zeros(300, bool)
    ji, jj = _views(p, i, j, mt)
    ti, tj = _views(p, i, j, pt)
    dj, dt = mt.DPDInteraction(r_c=1.2), pt.DPDInteraction(r_c=1.2)
    f_j = jax.vmap(lambda a, b, c, d, e, f, g, h, s: dj.force_vec(
        a, b, c, d, e, f, g, h, s, 9))(
        jnp.asarray(dr), jnp.asarray(r), jnp.asarray(i), jnp.asarray(j), ji,
        jj, jnp.asarray(vels[i]), jnp.asarray(vels[j]), jnp.asarray(spec))
    f_t = dt.force_vec(*map(torch.as_tensor, (dr, r, i, j)), ti, tj,
                       *map(torch.as_tensor, (vels[i], vels[j], spec)), 9)
    assert_match(f_j, f_t, f_j)


def test_use_neighbors_false_runs_dense_as_jax():
    """The repair: an uncut LJ with use_neighbors=False sums every pair
    (the dense engine), as JAX does, beside a listed Coulomb on a
    cluster-pair list. The port used to send both to the pair kernel over
    that list, which loses every LJ pair beyond the Coulomb cutoff."""
    (ja, jc, jb, jx, _), (ta, tc, tb, tx, _) = inputs("ortho")
    j_inters = (mt.LennardJones(), build(mt, "Coulomb"))
    t_inters = (pt.LennardJones(), build(pt, "Coulomb"))
    jsys = mt.System(atoms=ja, coords=jc, boundary=jb, exclusions=jx,
                     pairwise_inters=j_inters)
    jnbs = jax_find_neighbors(mt.DistanceNeighborFinder(LIST, 1, N), jc,
                              jb, jx)
    finder = pt.BlockPairFinder.setup(tb, LIST, N, ta)
    tsys = pt.System(atoms=ta, coords=tc, boundary=tb, exclusions=tx,
                     pairwise_inters=t_inters, neighbor_finder=finder)
    nb = pt.find_neighbors(finder, tc, tb, tx)
    fj, vj = mt.forces_virial(jsys, jnbs, needs_virial=True)
    ft, vt = pt.forces_virial(tsys, nb, needs_virial=True)
    assert_match(fj, ft, fj)
    assert_match(vj, vt, fj)
    e_j = mt.potential_energy(jsys, jnbs)
    assert_energy(e_j, pt.potential_energy(tsys, nb))
    # the old dispatch: both interactions to the kernel (its twin here)
    spec = pair_kernel.build_fused_spec(t_inters)
    assert spec.cut_max == RC
    f_old, e_old, _ = pair_kernel.block_nonbonded(spec, tc, tb, ta, tx, nb,
                                                  compute_energy=True)
    assert abs(float(e_old) - float(e_j)) > 1e-3
    assert np.max(np.abs(np64(f_old) - np64(fj))) > 1e-4


def test_block_list_with_refused_interaction_raises():
    """Listed interactions the kernel refuses, on a cluster-pair list,
    raise naming the cell finder; on a neighbor table they run."""
    (_, _, _, _, _), (ta, tc, tb, tx, _) = inputs("ortho")
    inter = build(pt, "Buckingham")
    finder = pt.BlockPairFinder.setup(tb, LIST, N, ta)
    tsys = pt.System(atoms=ta, coords=tc, boundary=tb, exclusions=tx,
                     pairwise_inters=(inter,), neighbor_finder=finder)
    with pytest.raises(NotImplementedError, match="neighbor_finder=\"cell\""):
        pt.forces_virial(tsys, pt.find_neighbors(finder, tc, tb, tx))
    cell = pt.CellListNeighborFinder.setup(tb, LIST, N, n_steps=1)
    f, _ = pt.forces_virial(tsys, pt.find_neighbors(cell, tc, tb, tx))
    assert np.isfinite(np64(f)).all()


def _norm(obj):
    """An interaction's or finder's fields, nested, with stateless tags
    (schedulers) by class name."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__, {f.name: _norm(getattr(obj, f.name))
                                     for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(_norm(x) for x in obj)
    if isinstance(obj, (int, float, bool, str, type(None))):
        return obj
    return type(obj).__name__


@pytest.mark.parametrize("finder", ("none", "distance", "cell"))
def test_bridge_carries_interactions_and_finders(finder):
    """bridge.system_from_arrays carries every pairwise class, mixing rule
    (with its NBFix table) and cutoff by name, JAX's finders with their
    fields, and the Buckingham columns of Atoms."""
    from mollytpu_torch.bridge import system_from_arrays
    (ja, jc, jb, jx, jv), (ta, *_) = inputs("ortho")
    extra = {"LennardJones": [dict(
        sigma_mixing=("MixingException", "LorentzMixing"),
        cutoff=("PolynomialCutoff", 0.7, RC))], "Mie": [dict(
            sigma_mixing=("WaldmanHaglerMixing",),
            epsilon_mixing=("InverseMixing",),
            cutoff=("CubicSplineCutoff", 0.7, RC))]}

    def inters(mod):
        out = []
        for name in POTENTIALS:
            for over in [{}] + extra.get(name, []):
                over = dict(over)
                for key in ("sigma_mixing", "epsilon_mixing"):
                    if key in over:
                        rule = over[key]
                        over[key] = (mod.MixingException(
                            getattr(mod, rule[1])(), mod.ExceptionTable(
                                (0, 1), (2, 3), (0.3, 0.31)))
                            if rule[0] == "MixingException"
                            else getattr(mod, rule[0])())
                out.append(build(mod, name, **over))
        return tuple(out)

    make = {"none": lambda mod: None,
            "distance": lambda mod: mod.DistanceNeighborFinder(LIST, 7, 33),
            "cell": lambda mod: mod.CellListNeighborFinder.setup(
                _jax_box("ortho") if mod is mt else _port_box("ortho"),
                LIST, N, n_steps=4)}[finder]
    js = mt.System(atoms=ja, coords=jc, boundary=jb, velocities=jv,
                   exclusions=jx, pairwise_inters=inters(mt),
                   neighbor_finder=make(mt))
    ps = system_from_arrays(jax.device_get(js), device=CPU)
    assert _norm(ps.pairwise_inters) == _norm(inters(pt))
    assert _norm(ps.neighbor_finder) == _norm(make(pt))
    for name in ("buck_A", "buck_B", "buck_C", "lam", "alch_role"):
        np.testing.assert_array_equal(np64(getattr(ps.atoms, name)),
                                      np64(getattr(ta, name)))
