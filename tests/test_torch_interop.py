"""External calculators and the calculator facade of mollytpu_torch
(interop.py) against the JAX package, float64 on the CPU: the two cases of
tests/test_setup_utils.py:53-116 (a host function wrapping a Calculator
joins the general interactions and simulates; the periodic virial needs
fn_virial), ``from_ase`` on a stub with ASE's method names (ASE is not a
dependency), and Calculator on the 64-water reaction-field box through the
cluster-pair list (the pair kernel's twin; JAX's Pallas kernel in
interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt

import mollytpu_torch as pt
from mollytpu_torch.bridge import system_from_arrays
from torch_parity import CPU, jax_system, max_rel, np64, port_system
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-9


def _lj12():
    boundary = mt.cubic(3.0, dtype=jnp.float64)
    coords = mt.place_atoms(jax.random.PRNGKey(0), boundary, 12,
                            min_dist=0.35, dtype=jnp.float64)
    atoms = mt.make_atoms(n=12, mass=10.0, sigma=0.3, epsilon=0.2,
                          dtype=jnp.float64)
    vels = mt.random_velocities(jax.random.PRNGKey(1), atoms.mass, 50.0,
                                dtype=jnp.float64)
    return mt.System(atoms=atoms, coords=coords, boundary=boundary,
                     velocities=vels, pairwise_inters=(mt.LennardJones(
                         cutoff=mt.DistanceCutoff(1.0)),))


def _wrapped(mod, inner):
    """``inner``'s engine behind a host function, as the only interaction
    of an otherwise empty copy of the system."""
    calc = mod.Calculator(inner)

    def fn(c_np, box_np):
        return float(calc.energy(c_np)), np64(calc.forces(c_np))

    return inner.update(pairwise_inters=(), general_inters=(
        mod.ExternalCalculator(fn=fn, n_atoms=inner.n_atoms),))


def test_external_calculator_matches_jax():
    inner_j = _lj12()
    inner = system_from_arrays(jax.device_get(inner_j), device=CPU)
    outer_j, outer = _wrapped(mt, inner_j), _wrapped(pt, inner)
    e_in = float(pt.potential_energy(inner))
    e_out = float(pt.potential_energy(outer))
    assert e_out == pytest.approx(e_in, rel=1e-12)
    assert e_out == pytest.approx(float(mt.potential_energy(outer_j)),
                                  rel=TOL)
    f_out = pt.forces(outer)
    assert max_rel(f_out, pt.forces(inner)) < 1e-12
    assert max_rel(f_out, mt.forces(outer_j)) < TOL
    # it simulates end to end through the host function, as JAX's does
    final_j, _ = mt.simulate(outer_j, mt.VelocityVerlet(dt=0.001), 20)
    final, _, _ = pt.simulate(outer, pt.VelocityVerlet(dt=0.001), 20)
    np.testing.assert_allclose(np64(final.coords), np64(final_j.coords),
                               atol=TOL)


@pytest.mark.parametrize("mod", [mt, pt], ids=["jax", "torch"])
def test_external_calculator_pbc_virial(mod):
    """Under PBC the virial comes from fn_virial; without it needs_virial
    raises, and without needs_virial it is zero; in an open box the
    absolute form is used. Both packages give the same numbers."""
    kw = dict(dtype=torch.float64, device=CPU) if mod is pt else dict(
        dtype=jnp.float64)
    boundary = mod.cubic(3.0, **kw)
    atoms = mod.make_atoms(n=4, mass=1.0, sigma=0.3, epsilon=0.0, **kw)
    c = np.asarray([[0.1, 0.1, 0.1], [2.9, 0.1, 0.1], [1.5, 1.5, 1.5],
                    [0.1, 2.9, 0.1]])
    coords = torch.as_tensor(c) if mod is pt else jnp.asarray(c)
    f_host = np.arange(12.0).reshape(4, 3) - 5.5

    def fn(cc, b):
        return 1.0, f_host

    vir_ref = np.diag([1.0, 2.0, 3.0])
    ext = mod.ExternalCalculator(fn=fn, n_atoms=4,
                                 fn_virial=lambda cc, b: vir_ref)
    f, vir = ext.force_virial(coords, boundary, atoms, needs_virial=True)
    np.testing.assert_allclose(np64(vir), vir_ref)
    np.testing.assert_allclose(np64(f), f_host)
    bare = mod.ExternalCalculator(fn=fn, n_atoms=4)
    with pytest.raises(ValueError):
        bare.force_virial(coords, boundary, atoms, needs_virial=True)
    _, vir = bare.force_virial(coords, boundary, atoms, needs_virial=False)
    np.testing.assert_allclose(np64(vir), 0.0)
    _, vir = bare.force_virial(coords, mod.cubic(float("inf"), **kw), atoms,
                               needs_virial=True)
    np.testing.assert_allclose(np64(vir), -c.T @ f_host, rtol=1e-12)


class _StubASEAtoms:
    """ASE's Atoms methods the wrapper calls, over a harmonic tether in
    ASE units (eV, Angstrom)."""

    def __init__(self, x0_angstrom, k_ev_a2):
        self.x0, self.k = x0_angstrom, k_ev_a2
        self.positions = self.cell = self.calc = None

    def set_positions(self, x):
        self.positions = np.asarray(x)

    def set_cell(self, cell):
        self.cell = np.asarray(cell)

    def get_potential_energy(self):
        return 0.5 * self.k * float(np.sum((self.positions - self.x0) ** 2))

    def get_forces(self):
        return -self.k * (self.positions - self.x0)

    def get_stress(self, voigt=True):
        assert not voigt
        return np.diag([0.01, 0.02, 0.03])


@pytest.mark.parametrize("mod", [mt, pt], ids=["jax", "torch"])
def test_from_ase_converts_units(mod):
    rng = np.random.default_rng(5)
    x = rng.uniform(0.2, 1.8, (5, 3))
    x0 = x + rng.normal(0.0, 0.01, (5, 3))
    stub = _StubASEAtoms(x0 * 10.0, 2.0)
    ext = mod.ExternalCalculator.from_ase(stub, calc="calc", n_atoms=5,
                                          use_stress=True)
    kw = dict(dtype=torch.float64, device=CPU) if mod is pt else dict(
        dtype=jnp.float64)
    boundary = mod.cubic(2.0, **kw)
    atoms = mod.make_atoms(n=5, mass=1.0, **kw)
    coords = torch.as_tensor(x) if mod is pt else jnp.asarray(x)
    e = float(ext.energy(coords, boundary, atoms))
    f, vir = ext.force_virial(coords, boundary, atoms, needs_virial=True)
    ev = pt.interop.EV_TO_KJMOL
    assert e == pytest.approx(0.5 * 2.0 * np.sum((10 * (x - x0)) ** 2) * ev,
                              rel=1e-12)
    np.testing.assert_allclose(np64(f), -2.0 * 10 * (x - x0) * ev / 0.1,
                               rtol=1e-12)
    np.testing.assert_allclose(
        np64(vir), -8.0 * np.diag([0.01, 0.02, 0.03]) * ev * 1000.0,
        rtol=1e-12)
    assert stub.calc == "calc"
    np.testing.assert_allclose(stub.cell, np.diag([20.0, 20.0, 20.0]))


def test_calculator_matches_jax_on_the_water_box():
    js, ps = jax_system("tiny64", "cutoff"), port_system("tiny64", "cutoff")
    rng = np.random.default_rng(8)
    x = np64(js.coords) + rng.normal(0.0, 0.002, (js.n_atoms, 3))
    calc_j, calc = mt.Calculator(js), pt.Calculator(ps)
    e, f = calc.energy_and_forces(x)
    e_j, f_j = calc_j.energy_and_forces(jnp.asarray(x))
    assert float(e) == pytest.approx(float(e_j), rel=TOL)
    assert max_rel(f, f_j) < TOL
    # the facade is the engine at those coordinates
    at = ps.update(coords=torch.as_tensor(x))
    nbs = pt.find_neighbors(at.neighbor_finder, at.coords, at.boundary,
                            at.exclusions)
    assert float(e) == float(pt.potential_energy(at, nbs))
    assert torch.equal(f, pt.forces_virial(at, nbs)[0])
