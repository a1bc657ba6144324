"""mollytpu_torch.ops.bonded against mollytpu.ops.bonded (float64, CPU):
every bonded kind on synthetic lists, as tests/test_bonded.py builds them,
in an orthorhombic and a triclinic box; the edge geometries (a near-
collinear angle, planar torsions, FENE past its clip); the virial; a kind
added with register_term; all kinds through one all_specific_forces call.

Tolerances: the port writes the JAX package's gradients by hand, so both
sides evaluate the same functions in another order: energies to 1e-10
relative, forces to 1e-8 of rms|F|, the virial to 1e-8 of its largest
entry (observed ~1e-15)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.ops import bonded as jb

import mollytpu_torch as pt
from mollytpu_torch.ops import bonded as pb
from torch_parity import CPU, np64
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL_E, TOL_F, TOL_V = 1e-10, 1e-8, 1e-8
L = 2.0
N_ATOMS, N_ROWS = 40, 30
BASIS = np.array([[L, 0.0, 0.0], [0.3, L, 0.0], [0.2, -0.4, L]])


def boxes(kind):
    if kind == "ortho":
        return (mt.rectangular([L, L, L], dtype=jnp.float64),
                pt.rectangular([L, L, L], dtype=torch.float64, device=CPU))
    return (mt.Triclinic(jnp.asarray(BASIS)),
            pt.triclinic(BASIS, dtype=torch.float64, device=CPU))


def params(kind, rng, k=N_ROWS):
    """Parameters of ``kind`` that keep every term finite on the random
    coordinates (FENE's r0 above the box diagonal's half)."""
    u = rng.uniform
    return {
        "harmonic_bond": dict(k=u(100, 200, k), r0=u(0.1, 0.3, k)),
        "morse_bond": dict(D=u(1, 5, k), a=u(1, 3, k), r0=u(0.1, 0.3, k)),
        "fene_bond": dict(k=u(10, 50, k), r0=u(1.8, 2.5, k),
                          sigma=u(0.5, 1.0, k), epsilon=u(0.1, 1, k)),
        "harmonic_angle": dict(k=u(10, 50, k), theta0=u(1, 2.5, k)),
        "cosine_angle": dict(k=u(10, 50, k), theta0=u(1, 2.5, k)),
        "urey_bradley": dict(kangle=u(10, 50, k), theta0=u(1, 2.5, k),
                             kbond=u(10, 50, k), r0=u(0.1, 0.3, k)),
        "periodic_torsion": dict(periodicity=rng.integers(1, 4, k) * 1.0,
                                 phase=u(0, 3, k), k=u(1, 10, k)),
        "rb_torsion": dict(coeffs=u(-10, 10, (k, 6))),
        "harmonic_torsion": dict(k=u(1, 10, k), theta0=u(-3, 3, k)),
        "position_restraint": dict(k=u(100, 200, k), x0=u(0, L, (k, 3))),
        "ewald_exclusion": dict(kqq=u(-100, 100, k), alpha=np.full(k, 3.1)),
    }[kind]


ARITY = {"harmonic_bond": 2, "morse_bond": 2, "fene_bond": 2,
         "harmonic_angle": 3, "cosine_angle": 3, "urey_bradley": 3,
         "periodic_torsion": 4, "rb_torsion": 4, "harmonic_torsion": 4,
         "position_restraint": 1, "ewald_exclusion": 2}
BUILDER = {"harmonic_bond": "harmonic_bonds", "morse_bond": "morse_bonds",
           "fene_bond": "fene_bonds", "harmonic_angle": "harmonic_angles",
           "cosine_angle": "cosine_angles", "urey_bradley": "urey_bradleys",
           "periodic_torsion": "periodic_torsions",
           "rb_torsion": "rb_torsions",
           "harmonic_torsion": "harmonic_torsions",
           "position_restraint": "position_restraints",
           "ewald_exclusion": "ewald_exclusions"}


def lists(kind, idx, p):
    """The same list built by each package's builder from numpy arrays."""
    cols = [idx[:, a] for a in range(idx.shape[1])]
    jl = getattr(jb, BUILDER[kind])(*cols, **{k: jnp.asarray(v)
                                              for k, v in p.items()})
    pl = getattr(pb, BUILDER[kind])(*cols, **p, dtype=torch.float64,
                                    device=CPU)
    return jl, pl


def random_lists(kind, rng):
    idx = np.stack([rng.permutation(N_ATOMS)[:ARITY[kind]]
                    for _ in range(N_ROWS)])
    return lists(kind, idx, params(kind, rng))


@jax.jit
def jax_terms(slist, coords, box):
    """(energy, forces, virial) of one list, compiled once per list."""
    return (jb.specific_energy(slist, coords, box),
            *jb.specific_forces(slist, coords, box, needs_virial=True))


def compare(jl, pl, coords, jbox, pbox):
    """(rel dE, max|dF|/rms|F|, max|dvir|/max|vir|) of one list."""
    e_j, f_j, v_j = jax_terms(jl, jnp.asarray(coords), jbox)
    e_j = float(e_j)
    x = torch.as_tensor(coords)
    e_p = float(pb.specific_energy(pl, x, pbox))
    f_p, v_p = pb.specific_forces(pl, x, pbox, needs_virial=True)
    f_j, v_j = np64(f_j), np64(v_j)
    rms = np.sqrt((f_j ** 2).sum(1).mean())
    return (abs(e_p - e_j) / max(abs(e_j), 1e-300),
            np.abs(np64(f_p) - f_j).max() / rms,
            np.abs(np64(v_p) - v_j).max() / max(np.abs(v_j).max(), 1e-300))


@pytest.mark.parametrize("box", ["ortho", "triclinic"])
@pytest.mark.parametrize("kind", sorted(ARITY))
def test_kind_matches_jax(kind, box):
    rng = np.random.default_rng(sorted(ARITY).index(kind))
    coords = rng.uniform(0, L, size=(N_ATOMS, 3))
    jl, pl = random_lists(kind, rng)
    assert pl.kind == kind and pl.atom_idx.shape == (N_ROWS, ARITY[kind])
    assert sorted(pl.params) == sorted(jl.params)
    de, df, dv = compare(jl, pl, coords, *boxes(box))
    assert de < TOL_E and df < TOL_F
    if kind == "position_restraint":
        # the reference atom is the restrained atom: no virial
        x = torch.as_tensor(coords)
        assert not pb.specific_forces(pl, x, boxes(box)[1],
                                      needs_virial=True)[1].any()
    else:
        assert dv < TOL_V


def _geometry(kind, shape):
    """Coordinates and a list at an edge geometry."""
    one = lambda v: np.asarray([v], dtype=np.float64)  # noqa: E731
    if kind == "angle":
        # near-collinear: 1e-7 rad from pi
        c = np.array([[0.1, 0.0, 0.0], [0.0, 0.0, 0.0],
                      [-0.12, 1.2e-8, 0.0]]) + 0.5
        return c, lists("harmonic_angle", np.array([[0, 1, 2]]),
                        dict(k=one(40.0), theta0=one(1.9)))
    if kind == "angle-cos":
        c = np.array([[0.1, 0.0, 0.0], [0.0, 0.0, 0.0],
                      [-0.12, 0.0, 1.0e-9]]) + 0.5
        return c, lists("cosine_angle", np.array([[0, 1, 2]]),
                        dict(k=one(20.0), theta0=one(1.9)))
    if kind in ("cis", "trans"):
        y = 0.1 if kind == "cis" else -0.1
        c = np.array([[0.0, 0.1, 0.0], [0.0, 0.0, 0.0], [0.1, 0.0, 0.0],
                      [0.1, y, 0.0]]) + 0.5
        idx = np.array([[0, 1, 2, 3]] * 3)
        rng = np.random.default_rng(5)
        name, p = {"periodic": ("periodic_torsion", dict(
            periodicity=np.array([1.0, 2.0, 3.0]),
            phase=np.array([0.0, 0.4, math.pi]), k=np.array([7.0, 3, 2]))),
            "rb": ("rb_torsion", dict(coeffs=rng.uniform(-10, 10, (3, 6)))),
            "harmonic": ("harmonic_torsion", dict(
                k=np.array([5.0, 4, 3]),
                theta0=np.array([0.3, -3.0, math.pi])))}[shape]
        return c, lists(name, idx, p)
    # FENE: one bond past its clip (r > r0), one inside with WCA on
    c = np.array([[0.5, 0.5, 0.5], [1.1, 0.5, 0.5], [0.5, 0.9, 0.5]])
    return c, lists("fene_bond", np.array([[0, 1], [0, 2]]), dict(
        k=np.array([30.0, 30.0]), r0=np.array([0.5, 1.5]),
        sigma=np.array([0.3, 0.42]), epsilon=np.array([1.0, 1.0])))


@pytest.mark.parametrize("geometry, shape", [
    ("angle", None), ("angle-cos", None), ("cis", "periodic"),
    ("trans", "periodic"), ("cis", "rb"), ("trans", "rb"),
    ("cis", "harmonic"), ("trans", "harmonic"), ("fene", None)])
def test_edge_geometries_match_jax(geometry, shape):
    coords, (jl, pl) = _geometry(geometry, shape)
    jbox, pbox = boxes("ortho")
    x = torch.as_tensor(coords)
    e_j, f_j, v_j = jax_terms(jl, jnp.asarray(coords), jbox)
    e_j = float(e_j)
    f_p, v_p = pb.specific_forces(pl, x, pbox, needs_virial=True)
    assert float(pb.specific_energy(pl, x, pbox)) == pytest.approx(
        e_j, rel=TOL_E, abs=1e-12)
    scale = max(np.sqrt((np64(f_j) ** 2).sum(1).mean()), 1.0)
    assert np.abs(np64(f_p) - np64(f_j)).max() / scale < TOL_F
    assert np.abs(np64(v_p) - np64(v_j)).max() / scale < TOL_F
    assert torch.isfinite(f_p).all()
    if geometry == "fene":
        # past the clip the FENE part exerts no force (jnp.clip's gradient)
        assert float(f_p[1].abs().max()) == 0.0


def test_register_term_matches_jax():
    """A user kind, registered in both packages: the port's forces come
    from torch.autograd, JAX's from jax.grad."""
    def jax_fn(c, boundary, p):
        r = jnp.sqrt(jnp.sum(boundary.displacement(c[0], c[1]) ** 2))
        return p["k"] * (r - p["r0"]) ** 4

    def port_fn(x, boundary, p):
        d = boundary.displacement(x[:, 0], x[:, 1])
        r = torch.sqrt((d * d).sum(-1))
        return p["k"] * (r - p["r0"]) ** 4

    jb.register_term("quartic_bond_test", jax_fn)
    pb.register_term("quartic_bond_test", port_fn)
    rng = np.random.default_rng(11)
    idx = np.stack([rng.permutation(N_ATOMS)[:2] for _ in range(N_ROWS)])
    k, r0 = rng.uniform(10, 20, N_ROWS), rng.uniform(0.1, 0.3, N_ROWS)
    jl = jb.SpecificList("quartic_bond_test", jnp.asarray(idx, jnp.int32), {
        "k": jnp.asarray(k), "r0": jnp.asarray(r0),
        "weight": jnp.ones(N_ROWS)})
    pl = pb.SpecificList("quartic_bond_test", torch.as_tensor(idx), {
        "k": torch.as_tensor(k), "r0": torch.as_tensor(r0),
        "weight": torch.ones(N_ROWS, dtype=torch.float64)})
    coords = rng.uniform(0, L, size=(N_ATOMS, 3))
    de, df, dv = compare(jl, pl, coords, *boxes("triclinic"))
    assert de < TOL_E and df < TOL_F and dv < TOL_V


def test_all_kinds_in_one_call_match_jax(monkeypatch):
    """Every built-in kind in one all_specific_forces call, which gathers
    and scatters once and runs without torch.autograd."""
    rng = np.random.default_rng(3)
    coords = rng.uniform(0, L, size=(N_ATOMS, 3))
    pairs = [random_lists(kind, rng) for kind in sorted(ARITY)]
    jbox, pbox = boxes("triclinic")
    f_j, v_j = jax.jit(lambda ls, c, b: jb.all_specific_forces(
        ls, c, b, needs_virial=True))(tuple(j for j, _ in pairs),
                                      jnp.asarray(coords), jbox)

    def no_autograd(*a, **k):
        raise AssertionError("a built-in kind called torch.autograd")

    monkeypatch.setattr(torch.autograd, "grad", no_autograd)
    seen = []
    index_add = torch.Tensor.index_add_
    monkeypatch.setattr(torch.Tensor, "index_add_", lambda self, *a, **k: (
        seen.append(a[1].shape[0]), index_add(self, *a, **k))[1])
    f_p, v_p = pb.all_specific_forces(tuple(p for _, p in pairs),
                                      torch.as_tensor(coords), pbox,
                                      needs_virial=True)
    assert seen == [N_ROWS * sum(ARITY.values())]
    rms = np.sqrt((np64(f_j) ** 2).sum(1).mean())
    assert np.abs(np64(f_p) - np64(f_j)).max() / rms < TOL_F
    assert np.abs(np64(v_p) - np64(v_j)).max() / np.abs(
        np64(v_j)).max() < TOL_V


def test_weight_and_empty_lists():
    """The weight column scales each row; empty lists contribute nothing."""
    _, pl = lists("harmonic_bond", np.array([[0, 1], [0, 1]]), dict(
        k=np.array([100.0, 100.0]), r0=np.array([0.2, 0.2]),
        weight=np.array([1.0, 0.0])))
    x = torch.tensor([[0.0, 0.0, 0.0], [0.3, 0.0, 0.0]], dtype=torch.float64)
    box = boxes("ortho")[1]
    assert float(pb.specific_energy(pl, x, box)) == pytest.approx(0.5)
    empty = pb.harmonic_angles([], [], [], k=[], theta0=[],
                               dtype=torch.float64, device=CPU)
    f, v = pb.all_specific_forces((empty, pl), x, box, needs_virial=True)
    f1, v1 = pb.specific_forces(pl, x, box, needs_virial=True)
    assert torch.equal(f, f1) and torch.equal(v, v1)
    assert float(pb.specific_energy(empty, x, box)) == 0.0
