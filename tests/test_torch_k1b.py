"""K1b, the pair kernel's modes beyond LJ + Ewald in an orthorhombic box:
shifted-potential, shifted-force and uncut LJ, plain and reaction-field
Coulomb, separate LJ and Coulomb radii, and triclinic boxes. The plain twin
(ops/pair_kernel.py) against the JAX package: its _pair_terms term by term,
then over a cluster-pair list against pallas_block_nonbonded in interpret
mode (BlockPairFinder block=32, lanes=128, as tests/test_kernel_consistency
.py runs it) and the dense all-pairs path, in a cube, a 92/95/88 degree box
and a rhombic dodecahedron, with 1-4 and far-window exclusions. Then the
list in triclinic boxes: completeness against 27 images, the box-size
check and the stale-list check.

Tolerances, float64 throughout:
- term by term: 1e-12 of the largest |term| (the same formulas);
- over the list: 1e-9 of max(1, largest entry) for forces and virial and
  of max(1, |E|) for the energy (plain and reaction-field Coulomb are exact
  on both sides; only the summation order differs). With Ewald the Pallas
  kernel's polynomial erfc (< 6e-7 absolute) allows 2e-6 against it, and
  1e-10 holds against the dense path.
"""

import ctypes
import functools
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.ops.blockpairs import BlockPairFinder as JaxBlockPairFinder
from mollytpu.ops.pallas_pairwise import _pair_terms as jax_pair_terms
from mollytpu.ops.pallas_pairwise import (build_fused_spec as
                                          jax_build_fused_spec,
                                          pallas_block_nonbonded)

import mollytpu_torch as pt
from mollytpu_torch.boundary import mic_displacement
from mollytpu_torch.ops import pair_kernel
from mollytpu_torch.ops.blockpairs import (CLUSTER, BlockPairFinder,
                                           unlisted_min_distance)
from torch_parity import CPU, LIST_RADIUS, box_path, max_rel, np64
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TERMS, EXACT, POLY = 1e-12, 1e-9, 2e-6
LIST = 1.0

#: (lj_mode, coul_mode, lj_rc, coul_rc): every non-alchemical mode pair
#: build_fused_spec can produce, with LJ and Coulomb radii that differ
#: both ways, so each term's own mask inside cut_max is exercised
CASES = {"lj1": (1, 0, 0.9, 0.0), "lj2": (2, 0, 0.9, 0.0),
         "lj3": (3, 0, 0.9, 0.0),
         "lj1-plain": (1, 1, 0.8, 0.9), "lj2-plain": (2, 1, 0.9, 0.75),
         "lj3-plain": (3, 1, 0.8, 0.9),
         "lj1-rf": (1, 2, 0.9, 0.9), "lj2-rf": (2, 2, 0.8, 0.9),
         "lj3-rf": (3, 2, 0.9, 0.8),
         "lj4-plain": (4, 1, 0.0, 0.9), "lj4-rf": (4, 2, 0.0, 0.9),
         "rf": (0, 2, 0.0, 0.9), "lj1-ewald": (1, 3, 0.9, 0.9)}

_LJ_CUTOFF = {1: "DistanceCutoff", 2: "ShiftedPotentialCutoff",
              3: "ShiftedForceCutoff", 4: "NoCutoff"}

#: triclinic boxes: edge (nm) and angles (degrees); "cubic" is a 2.4 nm cube
BOXES = {"cubic": (2.4, (90.0, 90.0, 90.0)),
         "skewed": (2.6, (92.0, 95.0, 88.0)),
         "dodeca": (3.0, pt.DODECAHEDRON)}


def _inters(mod, case, use_neighbors):
    """The case's interactions from ``mod``: mollytpu (JAX) or
    mollytpu_torch, which export the same names."""
    lj_mode, coul_mode, lj_rc, coul_rc = CASES[case]
    kw = dict(use_neighbors=use_neighbors, weight_special=0.5)
    out = []
    if lj_mode:
        cut = getattr(mod, _LJ_CUTOFF[lj_mode])
        out.append(mod.LennardJones(
            cutoff=cut() if lj_mode == 4 else cut(lj_rc), **kw))
    kw["weight_special"] = 0.8333
    if coul_mode == 1:
        out.append(mod.Coulomb(cutoff=mod.DistanceCutoff(coul_rc), **kw))
    elif coul_mode == 2:
        out.append(mod.CoulombReactionField(dist_cutoff=coul_rc, **kw))
    elif coul_mode == 3:
        if mod is mt:
            kw["approximate_erfc"] = False
        out.append(mod.CoulombEwald(dist_cutoff=coul_rc, alpha=3.0, **kw))
    return tuple(out)


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][1] != 3])
def test_pair_terms_match_jax(case):
    """Spec and per-pair (energy, coef) against the TPU kernel's
    _pair_terms on 4,000 random pairs inside cut_max, 1-4 and hydrogen-like
    (eps = 0) pairs included."""
    spec = pair_kernel.build_fused_spec(_inters(pt, case, True))
    spec_j = jax_build_fused_spec(_inters(mt, case, True))
    for field in ("lj_mode", "lj_rc", "lj_w", "coul_mode", "coul_rc", "ke",
                  "krf", "crf", "coul_w", "cut_max"):
        assert getattr(spec, field) == pytest.approx(getattr(spec_j, field),
                                                     rel=TERMS), field
    rng = np.random.default_rng(sum(map(ord, case)))
    k = 4000
    r = rng.uniform(0.15, spec.cut_max, k)
    sig = rng.uniform(0.25, 0.35, k)
    eps = rng.uniform(0.05, 0.3, k) * (rng.uniform(size=k) > 0.2)
    qq = rng.uniform(-0.5, 0.5, k)
    special = rng.uniform(size=k) < 0.3
    r2 = r * r
    inv_r = 1.0 / np.sqrt(r2)
    e_j, c_j = jax_pair_terms(spec_j, *(jnp.asarray(a) for a in (
        r2, inv_r, r2 * inv_r, sig, eps, qq, special)), jnp.float64)
    e, c = pair_kernel._pair_terms(spec, *(torch.as_tensor(a) for a in (
        r2, sig, eps, qq, special)))
    assert max_rel(e_j, e) < TERMS
    assert max_rel(c_j, c) < TERMS


def _place(n, boundary, seed, min_dist=0.25):
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
    side, angles = BOXES[name]
    if name == "cubic":
        return (mt.cubic(side, dtype=jnp.float64) if pkg is mt
                else pt.cubic(side, dtype=torch.float64, device=CPU))
    rad = [math.radians(a) for a in angles]
    if pkg is mt:
        return mt.triclinic_from_lengths_angles((side,) * 3, rad,
                                                dtype=jnp.float64)
    return pt.triclinic_from_lengths_angles((side,) * 3, rad,
                                            dtype=torch.float64, device=CPU)


@functools.lru_cache(maxsize=None)
def _system(name):
    """64 atoms in box ``name`` with chain exclusions (i, i+1), (i, i+2),
    1-4 pairs (i, i+3) and pairs with |j - i| > 31 (outside the bitmap
    window) among interacting atoms; parameters from a numpy seed."""
    n = 64
    pb = _box(name, pt)
    coords = _place(n, pb, 7)
    d = torch.linalg.vector_norm(pb.displacement(
        torch.as_tensor(coords)[:, None, :],
        torch.as_tensor(coords)[None, :, :]), dim=-1).numpy()
    far = [(a, b) for a, b in zip(*np.nonzero((d > 0.05) & (d < 0.8)))
           if b - a > 31][:6]
    assert len(far) == 6
    excl = ([(i, i + 1) for i in range(n - 1)]
            + [(i, i + 2) for i in range(n - 2)] + far[:3])
    spec = [(i, i + 3) for i in range(0, n - 3, 2)] + far[3:]
    rng = np.random.default_rng(n)
    q = rng.uniform(-0.5, 0.5, n)
    q -= q.mean()
    sigma = rng.uniform(0.25, 0.35, n)
    eps = rng.uniform(0.1, 0.3, n)
    eps[::5] = 0.0     # hydrogen-like sites with no LJ
    return coords, excl, spec, q, sigma, eps


def _run(name, case):
    coords, excl, spec, q, sigma, eps = _system(name)
    n = coords.shape[0]
    jatoms = mt.make_atoms(n=n, mass=10.0, charge=jnp.asarray(q),
                           sigma=jnp.asarray(sigma), epsilon=jnp.asarray(eps),
                           dtype=jnp.float64)
    jb = _box(name, mt)
    jexcl = mt.Exclusions.build(n, excl_pairs=excl, special_pairs=spec)
    jc = jnp.asarray(coords)
    dense = mt.System(atoms=jatoms, coords=jc, boundary=jb,
                      pairwise_inters=_inters(mt, case, False),
                      exclusions=jexcl)
    finder = JaxBlockPairFinder.setup(jb, LIST, n, coords=jc, atoms=jatoms,
                                      block=32, lanes=128)
    nbs = finder.find(jc, jb, jexcl)
    assert int(nbs.overflow) == 0
    spec_j = jax_build_fused_spec(_inters(mt, case, True))
    pal = jax.jit(lambda c: pallas_block_nonbonded(
        spec_j, c, jb, jatoms, jexcl, nbs, finder, compute_energy=True))(jc)
    ref = jax.jit(lambda s: (mt.forces_virial(s, needs_virial=True),
                             mt.potential_energy(s)))(dense)

    patoms = pt.make_atoms(n=n, mass=10.0, charge=q, sigma=sigma,
                           epsilon=eps, dtype=torch.float64, device=CPU)
    pb = _box(name, pt)
    pexcl = pt.Exclusions.build(n, excl, spec, device=CPU)
    pc = torch.as_tensor(coords)
    nb = BlockPairFinder.setup(pb, LIST, n, patoms).find(pc, pb, pexcl)
    ours = pair_kernel.block_nonbonded(
        pair_kernel.build_fused_spec(_inters(pt, case, True)), pc, pb,
        patoms, pexcl, nb, compute_energy=True)
    return pal, ref, ours


@pytest.mark.parametrize("name, case", [
    ("cubic", "lj1-rf"), ("cubic", "lj2-plain"), ("cubic", "lj4-rf"),
    ("cubic", "lj3"), ("skewed", "lj3-rf"), ("skewed", "lj1-ewald"),
    ("dodeca", "lj1-rf"), ("dodeca", "lj2-rf")])
def test_twin_matches_pallas_and_dense(name, case):
    """Forces, energy and virial. Uncut LJ (lj_mode 4) stops at the
    Coulomb cutoff in the kernel but not in the dense path, so there the
    dense path is another function and only the Pallas kernel is held."""
    (f_pal, e_pal, v_pal), ((f_ref, v_ref), e_ref), (f, e, v) = _run(name,
                                                                     case)
    pal = POLY if CASES[case][1] == 3 else EXACT
    scale = max(1.0, abs(float(e_pal)))
    if CASES[case][0] != 4:
        assert max_rel(f_ref, f) < EXACT
        assert max_rel(v_ref, v) < EXACT
        assert abs(float(e) - float(e_ref)) < EXACT * scale
    assert max_rel(f_pal, f) < pal
    assert max_rel(v_pal, v) < pal
    assert abs(float(e) - float(e_pal)) < pal * scale


def _cluster_of_atom(nb, n):
    slot = torch.empty(n, dtype=torch.int64)
    ids = nb.ids.to(torch.int64)
    real = ids < n
    slot[ids[real]] = torch.nonzero(real).flatten()
    return (slot // CLUSTER).numpy()


def _nearest_image_distances(boundary, coords):
    """(N, N) shortest distance over the 27 images of the fractional-
    rounding displacement: the brute-force minimum image."""
    base = boundary.displacement(coords[:, None, :], coords[None, :, :])
    shifts = torch.tensor(list(itertools.product((-1, 0, 1), repeat=3)),
                          dtype=coords.dtype) @ boundary.box_matrix()
    return torch.stack([torch.linalg.vector_norm(base + s, dim=-1)
                        for s in shifts]).amin(dim=0)


@pytest.mark.parametrize("case", ["skewed300", "dodeca300", "dodeca64water"])
def test_triclinic_list_covers_27_image_pairs(case):
    """Every atom pair within the list radius (shortest of 27 images) lies
    in a listed tile of the fractional-AABB list."""
    if case == "dodeca64water":
        sys = pt.system_from_pdb(box_path("dodeca64"),
                                 pt.ForceField(pt.TIP3P_XML),
                                 dtype=torch.float64, device=CPU,
                                 constraints="hbonds", rigid_water=True,
                                 dist_neighbors=LIST_RADIUS)
        coords, boundary, radius = sys.coords, sys.boundary, LIST_RADIUS
        nb = sys.neighbor_finder.find(coords, boundary, sys.exclusions)
    else:
        boundary = _box(case[:-3], pt)
        rng = np.random.default_rng(2)
        coords = torch.as_tensor(rng.uniform(0.0, 1.0, (300, 3))) @ \
            boundary.basis
        atoms = pt.make_atoms(n=300, mass=1.0, sigma=0.3, epsilon=0.2,
                              dtype=torch.float64, device=CPU)
        radius = LIST
        nb = BlockPairFinder.setup(boundary, radius, 300, atoms).find(
            coords, boundary, pt.Exclusions.build(300, device=CPU))
    n = coords.shape[0]
    d = _nearest_image_distances(boundary, coords).numpy()
    ii, jj = np.nonzero(np.triu(d < radius, k=1))
    assert len(ii) > 100
    cl = _cluster_of_atom(nb, n)
    ci, cj = np.minimum(cl[ii], cl[jj]), np.maximum(cl[ii], cl[jj])
    listed = {tuple(p) for p in nb.pairs.tolist()}
    assert not [(a, b) for a, b in zip(ci, cj) if (a, b) not in listed]


def test_small_triclinic_box_is_refused():
    """The dodecahedron of edge 3.0 nm is 2.12 nm wide across its c faces:
    too narrow for a 1.15 nm list radius, though its edges are not."""
    box = _box("dodeca", pt)
    atoms = pt.make_atoms(n=10, mass=1.0, dtype=torch.float64, device=CPU)
    with pytest.raises(ValueError, match="side/2"):
        BlockPairFinder.setup(box, LIST_RADIUS, 10, atoms)


@pytest.mark.parametrize("move", [0.05, 0.4])
def test_unlisted_min_distance_in_triclinic_box(move):
    """In a dodecahedron of edge 7 nm: exact below the cutoff (large
    moves), a lower bound of at least the cutoff otherwise (small moves),
    against all atom pairs of unlisted cluster pairs."""
    n, cutoff = 3000, 1.0
    rad = [math.radians(a) for a in pt.DODECAHEDRON]
    boundary = pt.triclinic_from_lengths_angles((7.0,) * 3, rad,
                                                dtype=torch.float64,
                                                device=CPU)
    rng = np.random.default_rng(6)
    coords = torch.as_tensor(rng.uniform(0.0, 1.0, (n, 3))) @ boundary.basis
    atoms = pt.make_atoms(n=n, mass=1.0, dtype=torch.float64, device=CPU)
    nb = BlockPairFinder.setup(boundary, LIST_RADIUS, n, atoms).find(
        coords, boundary, pt.Exclusions.build(n, device=CPU))
    assert nb.n_pairs < nb.n_clusters * (nb.n_clusters + 1) // 2
    moved = coords + torch.as_tensor(rng.uniform(-move, move, (n, 3)))
    moved[11] += boundary.basis[2]      # a whole cell image changes nothing
    got = float(unlisted_min_distance(nb, moved, boundary, cutoff))
    cl = _cluster_of_atom(nb, n)
    listed = np.zeros((nb.n_clusters,) * 2, dtype=bool)
    p = nb.pairs.numpy()
    listed[p[:, 0], p[:, 1]] = listed[p[:, 1], p[:, 0]] = True
    brute = math.inf
    for s in range(0, n, 500):       # rows in chunks: (500, n, 3) at a time
        unlisted = ~listed[cl[s:s + 500, None], cl[None, :]]
        d = torch.linalg.vector_norm(mic_displacement(
            boundary, moved[s:s + 500, None, :], moved[None, :, :]),
            dim=-1).numpy()
        if unlisted.any():
            brute = min(brute, float(d[unlisted].min()))
    if brute < cutoff:
        assert got == pytest.approx(brute, abs=1e-12)
    else:
        assert cutoff <= got <= brute + 1e-12
    assert (brute < cutoff) == (move > 0.1)


class _Stream:
    """Stands in for a torch.cuda.Stream: a handle, and the streams it was
    told to wait for."""

    def __init__(self, handle):
        self.cuda_stream, self.waited = handle, []

    def wait_stream(self, other):
        self.waited.append(other)


def _cpu_launch_args(monkeypatch, spec, nb, box, stream):
    """launch_args on CPU tensors with ``stream`` as the current stream,
    its CUDA input checks stubbed."""
    monkeypatch.setattr(pair_kernel, "_check_cuda_input", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: stream)
    forces = torch.zeros((64, 3), dtype=torch.float32)
    return pair_kernel.launch_args(spec, nb, box, 64, None, forces)


def test_launch_spec_layout(monkeypatch):
    """The ctypes struct the launcher reads: 6 ints, 12 floats, then the
    lambda path's 4 ints and 3 floats and the probe id, no padding, in
    csrc/pair_nonbonded.cu's LaunchSpec order; radii that need no mask
    inside cut_max are sent as inf, and a launch without lambda says so.
    The box is no field of it: launch_args hands the launcher, in its mic
    slot, the call's boundary's f32 minimum-image row (mic_row_tensor)."""
    L = pair_kernel._Launch
    assert ctypes.sizeof(L) == 26 * 4 and L.probe.offset == 25 * 4
    assert not hasattr(L, "mic") and L.cut2.offset == 6 * 4
    assert L.crf.offset == 17 * 4
    assert L.use_lam.offset == 18 * 4 and L.coul_sigma_q.offset == 24 * 4
    spec = pair_kernel.build_fused_spec(_inters(pt, "lj3-rf", True))
    box = _box("skewed", pt)
    nb = BlockPairFinder.setup(box, LIST, 64, pt.make_atoms(
        n=64, mass=1.0, dtype=torch.float64, device=CPU)).find(
        torch.as_tensor(_system("skewed")[0]), box,
        pt.Exclusions.build(64, device=CPU))
    launch = pair_kernel._launch_spec(spec, nb, box, 64, True)
    assert (launch.lj_mode, launch.coul_mode, launch.triclinic) == (3, 2, 1)
    assert math.isinf(launch.lj_rc2)
    assert launch.coul_rc2 == pytest.approx(0.64)
    assert launch.cut2 == pytest.approx(0.81)
    assert launch.krf == pytest.approx(spec.krf)
    assert (launch.use_lam, launch.lj_kind, launch.coul_sc) == (0, 0, 0)
    assert pair_kernel.instance_family(spec, box) == "coul2-triclinic"
    monkeypatch.setattr(pair_kernel, "_LAST_STREAM", {})
    moved = box.scale(1.01)
    for b in (box, moved):
        args = _cpu_launch_args(monkeypatch, spec, nb, b, _Stream(7))
        row = b.mic_row_tensor(torch.float32)
        assert args[6] == row.data_ptr() and args[-1][1] is row
        assert args[-2] == 7
    assert moved.mic_row_tensor(torch.float32).tolist() == pytest.approx(
        (1.01 * box.mic_row_tensor()[:6]).tolist()
        + (box.mic_row_tensor()[6:] / 1.01).tolist(), rel=1e-6)


def test_launch_stream_order(monkeypatch):
    """The kernel's box row lives in one __constant__ buffer written on the
    launch's stream: a launch on another stream than the last one first
    waits for the work queued there; launches on one stream never wait."""
    monkeypatch.setattr(pair_kernel, "_LAST_STREAM", {})
    spec = pair_kernel.build_fused_spec(_inters(pt, "lj1-ewald", False))
    box = _box("cubic", pt)
    nb = BlockPairFinder.setup(box, LIST, 64, pt.make_atoms(
        n=64, mass=1.0, dtype=torch.float64, device=CPU)).find(
        torch.as_tensor(_system("cubic")[0]), box,
        pt.Exclusions.build(64, device=CPU))
    a, b = _Stream(1), _Stream(2)
    for s in (a, a, b, b, a):
        _cpu_launch_args(monkeypatch, spec, nb, box, s)
    assert a.waited == [b] and b.waited == [a]
