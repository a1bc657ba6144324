"""PME, the Ewald exclusion correction and the LJ dispersion correction of
mollytpu_torch against the JAX package, float64. The JAX PME runs in both
its mesh forms ("scatter", which the port carries, and the TPU's dense
one-hot form); all three compute the same sums, so energies, forces and
virials agree to 1e-10 relative (summation order and FFT rounding)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.ops.ewald import EwaldExclusionCorrection as JaxExclusion
from mollytpu.ops.ewald import PME as JaxPME
from mollytpu.models.setup import make_dispersion_correction as jax_disp

import mollytpu_torch as pt
from mollytpu_torch.ops.ewald import EwaldExclusionCorrection, PME
from mollytpu_torch.models.setup import make_dispersion_correction
from torch_parity import CPU, max_rel
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-10
SIDES = [2.6, 2.9, 3.1]


def _inputs(n=150, seed=2):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-0.3, 3.4, (n, 3))    # some outside the box
    q = rng.uniform(-0.8, 0.8, n)
    q[-1] = -q[:-1].sum() + 0.05                # slightly non-neutral
    sigma = rng.uniform(0.2, 0.4, n)
    eps = rng.uniform(0.0, 0.6, n)
    jatoms = mt.make_atoms(n=n, charge=jnp.asarray(q),
                           sigma=jnp.asarray(sigma),
                           epsilon=jnp.asarray(eps), dtype=jnp.float64)
    patoms = pt.make_atoms(n=n, charge=q, sigma=sigma, epsilon=eps,
                           dtype=torch.float64, device=CPU)
    return (jnp.asarray(coords), mt.rectangular(jnp.asarray(SIDES),
                                                dtype=jnp.float64), jatoms,
            torch.as_tensor(coords), pt.rectangular(
                SIDES, dtype=torch.float64, device=CPU),
            patoms)


def _check(jinter, pinter, jc, jb, ja, pc, pb, pa):
    e_j, (f_j, v_j) = jax.jit(lambda c: (
        jinter.energy(c, jb, ja),
        jinter.force_virial(c, jb, ja, needs_virial=True)))(jc)
    e_p = float(pinter.energy(pc, pb, pa))
    assert e_p == pytest.approx(float(e_j), rel=TOL, abs=TOL)
    f_p, v_p = pinter.force_virial(pc, pb, pa, needs_virial=True)
    assert max_rel(f_j, f_p) < TOL
    assert max_rel(v_j, v_p) < TOL
    f0, v0 = pinter.force_virial(pc, pb, pa, needs_virial=False)
    assert max_rel(f_j, f0) < TOL
    assert torch.all(v0 == 0)


@pytest.mark.parametrize("mesh_method", ["scatter", "dense"])
@pytest.mark.parametrize("smooth", [True, False])
def test_pme_matches_jax(mesh_method, smooth):
    jc, jb, ja, pc, pb, pa = _inputs()
    jp = JaxPME.setup(jb, dist_cutoff=1.0, dtype=jnp.float64,
                      smooth_dims=smooth)
    jp = dataclasses.replace(jp, mesh_method=mesh_method)
    pp = PME.setup(pb, dist_cutoff=1.0, dtype=torch.float64,
                   smooth_dims=smooth)
    assert pp.mesh_dims == jp.mesh_dims
    _check(jp, pp, jc, jb, ja, pc, pb, pa)


def test_pme_water_box_matches_jax():
    """The 64-water box with its real charges and mesh (24, 24, 24)."""
    from torch_parity import jax_system, port_system
    js, ps = jax_system("tiny64"), port_system("tiny64")
    _check(js.general_inters[0], ps.general_inters[0], js.coords,
           js.boundary, js.atoms, ps.coords, ps.boundary, ps.atoms)


def test_exclusion_correction_matches_jax():
    """Chain-like pairs inside the +-31 window plus far pairs outside it:
    the JAX windowed sweep + far list against the port's sparse list."""
    jc, jb, ja, pc, pb, pa = _inputs()
    n = pc.shape[0]
    pairs = ([(i, i + 1) for i in range(n - 1)]
             + [(i, i + 3) for i in range(0, n - 3, 3)]
             + [(2, 90), (10, 140), (0, n - 1)])
    alpha = 2.6
    _check(JaxExclusion.setup(n, pairs, alpha),
           EwaldExclusionCorrection.setup(pairs, alpha), jc, jb, ja, pc, pb,
           pa)


def test_dispersion_correction_matches_jax():
    jc, jb, ja, pc, pb, pa = _inputs()
    sigma, eps = pa.sigma.numpy(), pa.epsilon.numpy()
    jd = jax_disp(sigma, eps, 1.0, jnp.float64)
    pd = make_dispersion_correction(sigma, eps, 1.0)
    assert pd.factor_6 == pytest.approx(jd.factor_6, rel=1e-12)
    assert pd.factor_12 == pytest.approx(jd.factor_12, rel=1e-12)
    _check(jd, pd, jc, jb, ja, pc, pb, pa)
