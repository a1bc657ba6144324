"""PME in any periodic box, its in-mesh exclusions, the Ewald exclusion
list, the reference Ewald sum and the exact (27-image) triclinic minimum
image of mollytpu_torch against the JAX package, float64.

- PME against JAX's PME in both its mesh forms ("scatter", which the port
  carries, and the TPU's dense one-hot form), on random charges in a
  skewed box (92/95/88 degrees) and on the 64-water rhombic dodecahedron:
  1e-10 relative (summation order and FFT rounding), mesh_dims equal.
- The same PME against a triclinic Ewald reciprocal sum written here in
  numpy (no test of the JAX package holds a triclinic PME): at
  error_tol=1e-5, 2e-4 relative, as tests/test_ewald.py holds the cube.
- A diagonal Triclinic box against Orthorhombic: 1e-12.
- The triclinic virial against a central finite difference of the energy
  under strain: 1e-6 of its largest entry.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.ops import bonded as jax_bonded
from mollytpu.ops.ewald import PME as JaxPME
from mollytpu.ops.ewald import Ewald as JaxEwald
from mollytpu.ops.ewald import ewald_exclusion_list as jax_exclusion_list

import mollytpu_torch as pt
from mollytpu_torch.bridge import system_from_arrays
from mollytpu_torch.ops import bonded
from mollytpu_torch.ops.ewald import PME
from torch_parity import CPU, jax_system, max_rel, np64, port_system
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-10
LENGTHS = (2.6, 2.9, 3.1)
ANGLES = tuple(math.radians(a) for a in (92.0, 95.0, 88.0))


def _charges(n, seed):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-0.8, 0.8, n)
    q[-1] = -q[:-1].sum() + 0.05                # slightly non-neutral
    return rng, q


def _skewed(n=150, seed=2, lengths=LENGTHS, angles=ANGLES):
    """Random charges in (and a little outside) a skewed box: JAX's and the
    port's coordinates, box and atoms."""
    rng, q = _charges(n, seed)
    jb = mt.boundary.triclinic_from_lengths_angles(lengths, angles,
                                                   dtype=jnp.float64)
    pb = pt.triclinic_from_lengths_angles(lengths, angles,
                                          dtype=torch.float64, device=CPU)
    coords = rng.uniform(-0.1, 1.1, (n, 3)) @ np64(jb.basis)
    return (jnp.asarray(coords), jb,
            mt.make_atoms(n=n, charge=jnp.asarray(q), dtype=jnp.float64),
            torch.as_tensor(coords), pb,
            pt.make_atoms(n=n, charge=q, dtype=torch.float64, device=CPU))


def _check(jinter, pinter, jc, jb, ja, pc, pb, pa, tol=TOL):
    e_j, (f_j, v_j) = jax.jit(lambda c: (
        jinter.energy(c, jb, ja),
        jinter.force_virial(c, jb, ja, needs_virial=True)))(jc)
    assert float(pinter.energy(pc, pb, pa)) == pytest.approx(
        float(e_j), rel=tol, abs=tol)
    f_p, v_p = pinter.force_virial(pc, pb, pa, needs_virial=True)
    assert max_rel(f_j, f_p) < tol
    assert max_rel(v_j, v_p) < tol


@pytest.mark.parametrize("mesh_method", ["scatter", "dense"])
def test_skewed_box_pme_matches_jax(mesh_method):
    jc, jb, ja, pc, pb, pa = _skewed()
    jp = dataclasses.replace(JaxPME.setup(jb, dist_cutoff=1.0,
                                          dtype=jnp.float64),
                             mesh_method=mesh_method)
    pp = PME.setup(pb, dist_cutoff=1.0, dtype=torch.float64)
    assert pp.mesh_dims == jp.mesh_dims
    _check(jp, pp, jc, jb, ja, pc, pb, pa)


@pytest.mark.parametrize("mesh_method", ["scatter", "dense"])
def test_dodecahedron_water_pme_matches_jax(mesh_method):
    """The 64-water dodecahedron's PME with its real charges, each side
    built by its own system_from_pdb; the mesh is sized from the basis
    diagonal on both sides."""
    js, ps = jax_system("dodeca64"), port_system("dodeca64")
    jp = dataclasses.replace(js.general_inters[0], mesh_method=mesh_method)
    pp = ps.general_inters[0]
    assert isinstance(ps.boundary, pt.Triclinic)
    assert pp.mesh_dims == jp.mesh_dims
    _check(jp, pp, js.coords, js.boundary, js.atoms, ps.coords, ps.boundary,
           ps.atoms)


def _ewald_reciprocal(coords, q, basis, alpha, kmax, ke):
    """Reciprocal Ewald energy and forces in a triclinic box, summed over
    the mesh vectors m = n @ inv(basis).T, |n_d| <= kmax, plus the self and
    background terms; numpy, float64."""
    inv = np.linalg.inv(basis)
    vol = abs(np.linalg.det(basis))
    ints = np.arange(-kmax, kmax + 1)
    n = np.stack(np.meshgrid(ints, ints, ints, indexing="ij"),
                 axis=-1).reshape(-1, 3)
    n = n[np.any(n != 0, axis=1)]
    m = n @ inv.T
    m2 = (m * m).sum(axis=1)
    f = np.exp(-math.pi ** 2 * m2 / alpha ** 2) / m2
    phase = 2.0 * math.pi * coords @ m.T                       # (N, K)
    s = (q[:, None] * np.exp(1j * phase)).sum(axis=0)
    energy = ke / (2.0 * math.pi * vol) * np.sum(f * np.abs(s) ** 2)
    # F_i = (2 ke q_i / V) sum_m f(m) m Im(exp(2 pi i m.r_i) conj(S))
    im = np.imag(np.exp(1j * phase) * np.conj(s)[None, :])
    forces = 2.0 * ke * q[:, None] / vol * ((im * f[None, :]) @ m)
    energy += -ke * alpha / math.sqrt(math.pi) * np.sum(q * q)
    energy += -ke * math.pi / (2.0 * alpha ** 2) * q.sum() ** 2 / vol
    return energy, forces


def test_triclinic_pme_matches_numpy_ewald_sum():
    _, _, _, pc, pb, pa = _skewed(n=12, seed=5, lengths=(2.0, 2.1, 2.2))
    pme = PME.setup(pb, dist_cutoff=0.9, error_tol=1e-5,
                    dtype=torch.float64)
    e_ref, f_ref = _ewald_reciprocal(pc.numpy(), pa.charge.numpy(),
                                     pb.basis.numpy(), pme.alpha, 18,
                                     pme.coulomb_const)
    assert float(pme.energy(pc, pb, pa)) == pytest.approx(e_ref, rel=2e-4)
    f, _ = pme.force_virial(pc, pb, pa)
    assert max_rel(f_ref, f) < 2e-4


def test_diagonal_triclinic_equals_orthorhombic():
    jc, _, _, pc, _, pa = _skewed(n=80, seed=6)
    sides = [2.6, 2.9, 3.1]
    tri = pt.triclinic(np.diag(sides), dtype=torch.float64, device=CPU)
    ortho = pt.rectangular(sides, dtype=torch.float64, device=CPU)
    pme = PME.setup(ortho, dtype=torch.float64)
    assert PME.setup(tri, dtype=torch.float64).mesh_dims == pme.mesh_dims
    assert float(pme.energy(pc, tri, pa)) == pytest.approx(
        float(pme.energy(pc, ortho, pa)), rel=1e-12)
    for nv in (False, True):
        f1, v1 = pme.force_virial(pc, tri, pa, needs_virial=nv)
        f2, v2 = pme.force_virial(pc, ortho, pa, needs_virial=nv)
        assert max_rel(f2, f1) < 1e-12 and max_rel(v2, v1) < 1e-12


def test_triclinic_virial_is_the_strain_derivative():
    """W_ab = -dE/d(eps_ab) with x -> x (I + eps)^T and the basis likewise,
    eps upper triangular so that the basis stays lower triangular."""
    _, _, _, pc, pb, pa = _skewed(n=60, seed=7)
    pme = PME.setup(pb, dtype=torch.float64)
    _, vir = pme.force_virial(pc, pb, pa, needs_virial=True)
    h = 1e-6

    def energy(a, b, step):
        eps = torch.zeros((3, 3), dtype=torch.float64)
        eps[a, b] = step
        f = torch.eye(3, dtype=torch.float64) + eps
        box = pt.Triclinic(pb.basis @ f.T)
        return float(pme.energy(pc @ f.T, box, pa))

    for a in range(3):
        for b in range(a, 3):
            dedeps = (energy(a, b, h) - energy(a, b, -h)) / (2 * h)
            assert abs(-dedeps - float(vir[a, b])) < 1e-6 * float(
                vir.abs().max()), (a, b)


def test_influence_is_cached_per_box_and_fresh_after_scale():
    _, _, _, pc, pb, pa = _skewed(n=40, seed=8)
    pme = PME.setup(pb, dtype=torch.float64)
    first = pme._influence(pb, torch.float64)
    assert pme._influence(pb, torch.float64) is first
    moved = pb.scale(torch.tensor(1.02, dtype=torch.float64))
    fresh = pt.Triclinic(pb.basis * 1.02)
    e_moved = pme.energy(pc * 1.02, moved, pa)
    e_fresh = pme.energy(pc * 1.02, fresh, pa)
    assert float(e_moved) == pytest.approx(float(e_fresh), rel=1e-13)
    assert pme._influence(moved, torch.float64) is not first
    f1, v1 = pme.force_virial(pc * 1.02, moved, pa, needs_virial=True)
    f2, v2 = pme.force_virial(pc * 1.02, fresh, pa, needs_virial=True)
    assert max_rel(f2, f1) < 1e-12 and max_rel(v2, v1) < 1e-12


def _excl_pairs(n):
    return ([(i, i + 1) for i in range(0, n - 1, 2)]
            + [(i, i + 2) for i in range(0, n - 2, 5)] + [(3, 97), (0, n - 1)])


@pytest.mark.parametrize("mesh_method", ["scatter", "dense"])
def test_pme_in_mesh_exclusions_match_jax(mesh_method):
    jc, jb, ja, pc, pb, pa = _skewed()
    pairs = _excl_pairs(pc.shape[0])
    jp = dataclasses.replace(JaxPME.setup(jb, excl_pairs=pairs,
                                          dtype=jnp.float64),
                             mesh_method=mesh_method)
    pp = PME.setup(pb, excl_pairs=pairs, dtype=torch.float64)
    _check(jp, pp, jc, jb, ja, pc, pb, pa)
    # and carried by the bridge
    bridged = system_from_arrays(jax.device_get(mt.System(
        atoms=ja, coords=jc, boundary=jb, general_inters=(jp,))),
        device=CPU)
    _check(jp, bridged.general_inters[0], jc, jb, ja, pc, pb, pa)


def test_ewald_exclusion_list_matches_jax():
    jc, jb, ja, pc, pb, pa = _skewed()
    pairs = _excl_pairs(pc.shape[0])
    q = pa.charge.numpy()
    jl = jax_exclusion_list(pairs, q, 3.1, 138.935458, dtype=jnp.float64)
    pl = pt.ewald_exclusion_list(pairs, q, 3.1, 138.935458,
                                 dtype=torch.float64, device=CPU)
    e_j = jax_bonded.specific_energy(jl, jc, jb)
    f_j, v_j = jax_bonded.specific_forces(jl, jc, jb, needs_virial=True)
    assert float(bonded.specific_energy(pl, pc, pb)) == pytest.approx(
        float(e_j), rel=TOL)
    f_p, v_p = bonded.specific_forces(pl, pc, pb, needs_virial=True)
    assert max_rel(f_j, f_p) < TOL and max_rel(v_j, v_p) < TOL


def test_ewald_sum_matches_jax():
    """The reference Ewald sum (orthorhombic) with exclusions: energy, and
    forces by autograd against JAX's autodiff, through the bridge."""
    rng, q = _charges(30, 9)
    sides = [2.0, 2.2, 2.4]
    coords = rng.uniform(0.0, 2.0, (30, 3))
    jb = mt.rectangular(jnp.asarray(sides), dtype=jnp.float64)
    pb = pt.rectangular(sides, dtype=torch.float64, device=CPU)
    ja = mt.make_atoms(n=30, charge=jnp.asarray(q), dtype=jnp.float64)
    pa = pt.make_atoms(n=30, charge=q, dtype=torch.float64, device=CPU)
    pairs = np.asarray([(0, 1), (2, 3), (4, 9)], dtype=np.int32)
    je = JaxEwald(dist_cutoff=0.9, error_tol=1e-5, kmax=8,
                  excl_i=jnp.asarray(pairs[:, 0]),
                  excl_j=jnp.asarray(pairs[:, 1]))
    pe = system_from_arrays(jax.device_get(mt.System(
        atoms=ja, coords=jnp.asarray(coords), boundary=jb,
        general_inters=(je,))), device=CPU).general_inters[0]
    assert isinstance(pe, pt.Ewald)
    jc, pc = jnp.asarray(coords), torch.as_tensor(coords)
    assert float(pe.energy(pc, pb, pa)) == pytest.approx(
        float(je.energy(jc, jb, ja)), rel=TOL)
    f_j, _ = je.force_virial(jc, jb, ja)
    f_p, _ = pe.force_virial(pc, pb, pa)
    assert max_rel(f_j, f_p) < TOL


def test_exact_minimum_image_matches_jax():
    """An unreduced box (b and c leaning far over a) where rounding the
    fractional coordinates misses the shortest image: the 27-image search
    matches JAX's, and scale, where, to and the bridge keep the flag."""
    basis = np.array([[2.0, 0.0, 0.0], [1.9, 1.0, 0.0], [0.3, 0.2, 1.0]])
    jb = mt.Triclinic(jnp.asarray(basis), approx_images=False)
    pb = pt.triclinic(basis, dtype=torch.float64, device=CPU,
                      approx_images=False)
    rng = np.random.default_rng(10)
    xi, xj = rng.uniform(0, 2, (500, 3)), rng.uniform(0, 2, (500, 3))
    exact = pb.displacement(torch.as_tensor(xi), torch.as_tensor(xj))
    np.testing.assert_allclose(exact.numpy(), np64(jb.displacement(
        jnp.asarray(xi), jnp.asarray(xj))), rtol=0, atol=1e-12)
    approx = dataclasses.replace(pb, approx_images=True).displacement(
        torch.as_tensor(xi), torch.as_tensor(xj))
    shorter = (exact.norm(dim=1) < approx.norm(dim=1) - 1e-9).sum()
    assert int(shorter) > 10
    moved = pb.scale(torch.tensor(1.01, dtype=torch.float64))
    assert not moved.approx_images
    assert not pb.where(torch.tensor(True), moved).approx_images
    assert not pb.to(dtype=torch.float32).approx_images
    bridged = system_from_arrays(jax.device_get(mt.System(
        atoms=mt.make_atoms(n=2, dtype=jnp.float64),
        coords=jnp.zeros((2, 3)), boundary=jb)), device=CPU)
    assert bridged.boundary.approx_images is False
