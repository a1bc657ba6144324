"""The collective variables and biases of mollytpu_torch
(free_energy/cv.py, free_energy/bias.py, awh.GridBias) against the JAX
package, float64 on seeded numpy coordinates in a cube and in a triclinic
box. The port's objects are carried from the JAX ones by the bridge
(free_energy_from_arrays).

Tolerances: both sides evaluate the same formulas in float64 (the Kabsch
SVD through LAPACK on both), so CV values and gradients agree to 1e-10
relative (gradients relative to their largest entry), bias energies to
1e-12 and bias forces and virials to 1e-10 of their largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt

import mollytpu_torch as pt
from mollytpu_torch.bridge import free_energy_from_arrays
from mollytpu_torch.free_energy.awh import interp
from torch_parity import CPU, max_rel, np64
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-10
N_ATOMS = 12


def _boxes():
    """(JAX box, port box) pairs: a 2.2 nm cube and a skewed cell."""
    tri = mt.triclinic_from_lengths_angles(
        (2.2, 2.4, 2.6), np.radians((75.0, 80.0, 70.0)), dtype=jnp.float64)
    return {"cube": (mt.cubic(2.2, dtype=jnp.float64),
                     pt.cubic(2.2, dtype=torch.float64, device=CPU)),
            "triclinic": (tri, pt.triclinic(np64(tri.basis),
                                            dtype=torch.float64,
                                            device=CPU))}


BOXES = _boxes()


def _coords(box_name):
    """Uniform coordinates in the box's cell, seeded."""
    jbox = BOXES[box_name][0]
    f = np.random.default_rng(5).uniform(size=(N_ATOMS, 3))
    return np64(jbox.from_fractional(jnp.asarray(f)))


def _jax_cvs(coords):
    rng = np.random.default_rng(6)
    g1, g2 = jnp.arange(3), jnp.arange(5, 8)
    return {
        "CalcSingleDist": mt.CalcSingleDist(0, 5),
        "CalcDist": mt.CalcDist(group1=g1, group2=g2),
        "CalcMinDist": mt.CalcMinDist(group1=g1, group2=g2, beta=50.0),
        "CalcMaxDist": mt.CalcMaxDist(group1=g1, group2=g2, beta=50.0),
        "CalcCMDist": mt.CalcCMDist(
            group1=jnp.arange(5), group2=jnp.arange(5, 10),
            masses1=jnp.asarray(rng.uniform(1.0, 16.0, 5)),
            masses2=jnp.asarray(rng.uniform(1.0, 16.0, 5))),
        "CalcRg": mt.CalcRg(group=jnp.arange(10),
                            masses=jnp.asarray(rng.uniform(1.0, 16.0, 10))),
        # a reference displaced by 0.1 nm of noise: distinct singular
        # values, where the SVD's gradient is defined
        "CalcRMSD": mt.CalcRMSD(
            reference=jnp.asarray(coords[:6] + rng.normal(0.0, 0.1, (6, 3))),
            group=jnp.arange(6)),
        "CalcTorsion": mt.CalcTorsion(0, 1, 2, 3),
    }


CV_NAMES = tuple(_jax_cvs(np.zeros((N_ATOMS, 3))))


@pytest.mark.parametrize("box", tuple(BOXES))
@pytest.mark.parametrize("name", CV_NAMES)
def test_cv_value_and_gradient_match_jax(name, box):
    jbox, tbox = BOXES[box]
    x = _coords(box)
    jcv = _jax_cvs(x)[name]
    cv = free_energy_from_arrays(jax.device_get(jcv), device=CPU)
    assert type(cv) is getattr(pt, name)
    v_j = float(jcv.value(jnp.asarray(x), jbox))
    v = float(cv.value(torch.as_tensor(x), tbox))
    assert np.isfinite(v) and v == pytest.approx(v_j, rel=TOL, abs=TOL)
    g_j = mt.cv_gradient(jcv, jnp.asarray(x), jbox)
    g = pt.cv_gradient(cv, torch.as_tensor(x), tbox)
    assert g.shape == (N_ATOMS, 3)
    assert max_rel(g_j, g) < TOL


BIAS_CVS = np.concatenate([np.linspace(-3.5, 3.5, 57), [0.35, 0.45, 0.4]])


def _jax_biases():
    return {
        "LinearBias": mt.LinearBias(k=-3.5),
        "SquareBias": mt.SquareBias(k=2000.0, cv0=0.4),
        "FlatBottomSquareBias": mt.FlatBottomSquareBias(k=800.0, cv0=0.4,
                                                        width=0.1),
        "PeriodicFlatBottomBias": mt.PeriodicFlatBottomBias(
            k=150.0, cv0=3.0, width=0.3),
    }


@pytest.mark.parametrize("name", tuple(_jax_biases()))
def test_bias_energy_matches_jax(name):
    jb = _jax_biases()[name]
    b = free_energy_from_arrays(jax.device_get(jb), device=CPU)
    assert type(b) is getattr(pt, name)
    e_j = np64(jb(jnp.asarray(BIAS_CVS)))
    e = np64(b(torch.as_tensor(BIAS_CVS)))
    np.testing.assert_allclose(e, e_j, rtol=1e-12, atol=1e-12)
    # a Python float in, as the PMF grids call it
    assert float(b(float(BIAS_CVS[3]))) == pytest.approx(float(e_j[3]),
                                                         rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("box", tuple(BOXES))
@pytest.mark.parametrize("name", CV_NAMES)
def test_bias_potential_forces_match_jax(name, box):
    """A BiasPotential on each CV: forces by autograd and the isotropic
    strain virial, against the JAX package's jax.grad."""
    jbox, tbox = BOXES[box]
    x = _coords(box)
    jcv = _jax_cvs(x)[name]
    v0 = float(jcv.value(jnp.asarray(x), jbox))
    jbp = mt.BiasPotential(bias=mt.SquareBias(k=1500.0, cv0=v0 + 0.05),
                           cv=jcv)
    bp = free_energy_from_arrays(jax.device_get(jbp), device=CPU)
    f_j, w_j = jbp.force_virial(jnp.asarray(x), jbox, None, needs_virial=True)
    f, w = bp.force_virial(torch.as_tensor(x), tbox, None, needs_virial=True)
    assert max_rel(f_j, f) < TOL and max_rel(w_j, w) < TOL
    assert float(bp.energy(torch.as_tensor(x), tbox, None)) == pytest.approx(
        float(jbp.energy(jnp.asarray(x), jbox, None)), rel=TOL)


@pytest.mark.parametrize("where", ["inside", "below", "above", "knot"])
def test_grid_bias_matches_jax(where):
    """GridBias (jnp.interp in torch) on a distance CV: the energy and
    forces inside the grid, at a knot, and held flat outside it (zero
    force)."""
    jbox, tbox = BOXES["cube"]
    x = _coords("cube")
    jcv = mt.CalcSingleDist(0, 5)
    d = float(jcv.value(jnp.asarray(x), jbox))
    lo, hi = {"inside": (d - 0.31, d + 0.27), "below": (d + 0.1, d + 0.6),
              "above": (d - 0.6, d - 0.1), "knot": (d - 0.4, d + 0.4)}[where]
    centers = np.linspace(lo, hi, 9)
    values = np.random.default_rng(8).uniform(-5.0, 5.0, 9)
    jgb = mt.GridBias(cv=jcv, centers=jnp.asarray(centers),
                      values=jnp.asarray(values))
    gb = free_energy_from_arrays(jax.device_get(jgb), device=CPU)
    assert type(gb) is pt.GridBias
    e_j = float(jgb.energy(jnp.asarray(x), jbox, None))
    e = float(gb.energy(torch.as_tensor(x), tbox, None))
    assert e == pytest.approx(e_j, rel=1e-12, abs=1e-12)
    f_j, _ = jgb.force_virial(jnp.asarray(x), jbox, None)
    f, _ = gb.force_virial(torch.as_tensor(x), tbox, None)
    assert max_rel(f_j, f) < TOL
    if where in ("below", "above"):
        assert float(f.abs().max()) == 0.0
    else:
        assert float(f.abs().max()) > 0.0


def test_interp_matches_jnp_interp():
    """interp against jnp.interp on points inside, outside and on the
    knots, with a repeated knot."""
    xp = np.array([0.0, 0.5, 0.5, 1.0, 2.5])
    fp = np.array([1.0, -2.0, 3.0, 0.5, 4.0])
    x = np.concatenate([np.linspace(-1.0, 3.0, 41), xp])
    np.testing.assert_allclose(
        np64(interp(torch.as_tensor(x), torch.as_tensor(xp),
                    torch.as_tensor(fp))),
        np64(jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp))),
        rtol=1e-14, atol=1e-14)
