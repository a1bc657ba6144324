"""The alchemical free-energy slice of mollytpu_torch against the JAX
package on the 512-water PME box (1,536 atoms, float64), one water
inserted alchemically: Beutler soft-core LJ + Beutler soft-core Ewald real
space, PME on the scheduled charges, the Ewald exclusion and dispersion
corrections (the JAX package's FEP production combination,
tests/test_kernel_consistency.py:318-339, on its PME water box). The port
system is built from public pieces, as a JAX user builds it with
System.update and set_lambda, and through the bridge; both must agree.

Checked: forces, virial and energy at lambda 0.75; U(x; lambda_k) at five
lambdas through LambdaHamiltonian.energies and
AlchemicalPartition.cross_energies on one list; MBAR on those cross
energies; 40 Langevin steps at lambda 0.75 with two rebuilds, fed JAX's
own noise.

Tolerances: both sides evaluate the same soft-core formulas (the
Abramowitz-Stegun erfc on both sides of the soft-cored Ewald screen) and
the same PME, so forces and virial agree to 1e-9 of their largest entry
and energies to 1e-9 relative (summation order); over 40 steps of 2 fs
that bounds coordinates to far below the 1e-6 nm and velocities to far
below the 1e-4 nm/ps used."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.sim.simulate import _make_chunk_fn

import mollytpu_torch as pt
from mollytpu_torch.bridge import system_from_arrays
from torch_parity import (CADENCE, CPU, LIST_RADIUS, jax_neighbors,
                          jax_system, max_rel, np64, port_neighbors,
                          port_system)
from torch_parity import alchemical as _alchemical
from torch_parity import jax_fresh_start
from torch_parity import solute_atoms as _solute
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DT, TEMP, FRICTION = 0.002, 300.0, 1.0
LAMS = (0.0, 0.25, 0.5, 0.75, 1.0)
TOL = 1e-9


@pytest.fixture(scope="module")
def fep():
    """JAX system, port systems (public pieces; bridge) and the solute
    mask, all at lambda 0.75 with the same seeded velocities."""
    js = jax_system("liquid512")
    coords = np64(js.coords)
    side = np64(js.boundary.side_lengths)
    mask = np.zeros(coords.shape[0], dtype=bool)
    mask[_solute(coords, side)] = True
    rng = np.random.default_rng(2)
    m = np64(js.atoms.mass)
    v = rng.normal(size=coords.shape) * np.sqrt(pt.units.KB * TEMP / m)[
        :, None]
    js = _alchemical(mt, js.update(velocities=jnp.asarray(v)), mask, 0.75)
    own = _alchemical(pt, port_system("liquid512"), mask, 0.75).update(
        velocities=torch.as_tensor(v))
    bridged = system_from_arrays(jax.device_get(js), device=CPU,
                                 dist_neighbors=LIST_RADIUS, n_steps=CADENCE)
    return js, own, bridged, mask


def test_public_pieces_equal_the_bridged_system(fep):
    _, own, bridged, _ = fep
    assert torch.equal(own.atoms.lam, bridged.atoms.lam)
    assert torch.equal(own.atoms.alch_role, bridged.atoms.alch_role)
    assert [type(i) for i in own.pairwise_inters] == \
        [type(i) for i in bridged.pairwise_inters]
    assert type(bridged.general_inters[0].scheduler) is \
        pt.DefaultLambdaScheduler
    f1, v1 = pt.forces_virial(own, port_neighbors(own), needs_virial=True)
    f2, v2 = pt.forces_virial(bridged, port_neighbors(bridged),
                              needs_virial=True)
    assert max_rel(f1, f2) < 1e-12 and max_rel(v1, v2) < 1e-12


def test_forces_virial_energy_match(fep):
    js, ps, _, _ = fep
    nbs = jax_neighbors(js)
    f_j, v_j = jax.jit(lambda s, nb: mt.forces_virial(
        s, nb, needs_virial=True))(js, nbs)
    e_j = jax.jit(mt.potential_energy)(js, nbs)
    nb = port_neighbors(ps)
    f, v = pt.forces_virial(ps, nb, needs_virial=True)
    e = pt.potential_energy(ps, nb)
    assert max_rel(f_j, f) < TOL and max_rel(v_j, v) < TOL
    assert float(e) == pytest.approx(float(e_j), rel=TOL)


def test_exclusion_correction_keeps_the_solute_offset(fep):
    """A reference-side observation the port mirrors: PME sums the
    scheduled charges, so below lambda 0.5 the inserted water carries no
    charge in PME, while the Ewald exclusion correction still subtracts its
    intramolecular erf(alpha r)/r terms with the full charges. The offset
    is the correction's energy over the solute alone: +212.6 kJ/mol for one
    TIP3P water (alpha 2.628 /nm of the 1.0 nm, 5e-4 Ewald), the JAX
    package's value to 1e-9 relative."""
    js, ps, _, mask = fep
    tm = torch.as_tensor(mask)
    at = pt.set_lambda(ps, 0.25, atom_mask=tm)
    pme, corr = (next(g for g in ps.general_inters if isinstance(g, cls))
                 for cls in (pt.PME, pt.EwaldExclusionCorrection))
    q = at.atoms.charge
    bare = dataclasses.replace(at.atoms, charge=torch.where(tm, 0.0, q))
    assert float(pme.energy(at.coords, at.boundary, at.atoms)) == \
        pytest.approx(float(dataclasses.replace(pme, scheduler=None).energy(
            at.coords, at.boundary, bare)), rel=1e-12)
    solute = dataclasses.replace(at.atoms, charge=torch.where(tm, q, 0.0))
    offset = float(corr.energy(at.coords, at.boundary, solute))
    j_corr = next(g for g in js.general_inters
                  if type(g).__name__ == "EwaldExclusionCorrection")
    j_solute = dataclasses.replace(js.atoms, charge=jnp.where(
        jnp.asarray(mask), js.atoms.charge, 0.0))
    assert offset == pytest.approx(float(j_corr.energy(
        js.coords, js.boundary, j_solute)), rel=1e-9)
    assert offset == pytest.approx(212.6, abs=0.1)


@pytest.fixture(scope="module")
def cross(fep):
    """U(x; lambda_k) of the lambda-0.75 frame, JAX and port, both ways."""
    js, ps, _, mask = fep
    nbs = jax_neighbors(js)
    lams = jnp.asarray(LAMS)
    jm = jnp.asarray(mask)
    h_j = jax.jit(lambda s, nb: mt.LambdaHamiltonian(atom_mask=jm).energies(
        s, lams, nb))(js, nbs)
    p_j = jax.jit(lambda s, nb: mt.AlchemicalPartition(
        atom_mask=jm).cross_energies(s, lams, nb))(js, nbs)
    nb = port_neighbors(ps)
    tm = torch.as_tensor(mask)
    h = pt.LambdaHamiltonian(atom_mask=tm).energies(ps, LAMS, nb)
    p = pt.AlchemicalPartition(atom_mask=tm).cross_energies(ps, LAMS, nb)
    return h_j, p_j, h, p, ps, nb


def test_lambda_hamiltonian_energies_match(cross):
    h_j, _, h, _, ps, nb = cross
    np.testing.assert_allclose(np64(h), np64(h_j), rtol=TOL)
    # lambda moves the energy: the inserted water couples to the solvent
    assert float(h[0] - h[-1]) > 10.0
    # the same list served all five; U at the frame's own lambda is the
    # energy of the frame
    assert float(h[3]) == pytest.approx(float(pt.potential_energy(ps, nb)),
                                        rel=1e-14)


def test_cross_energies_match(cross):
    """The port's cross energies equal LambdaHamiltonian.energies (its own
    and the JAX package's): the scheduled PME counts as perturbed and is
    evaluated at each lambda. The JAX package's cross energies keep it at
    the frame's lambda (mollytpu/free_energy/thermo.py:91-97), so they
    differ from its energies by the scheduled PME's change with lambda,
    except at the frame's own lambda: recorded here."""
    h_j, p_j, h, p, ps, _ = cross
    np.testing.assert_allclose(np64(p), np64(h), rtol=1e-12)
    np.testing.assert_allclose(np64(p), np64(h_j), rtol=TOL)
    tm = ps.atoms.alch_role != pt.ALCH_CORE
    pme = next(g for g in ps.general_inters if isinstance(g, pt.PME))

    def e_pme(lam):
        at = pt.set_lambda(ps, lam, atom_mask=tm)
        return float(pme.energy(at.coords, at.boundary, at.atoms))

    frame = LAMS.index(0.75)
    shift = np.array([e_pme(lam) - e_pme(LAMS[frame]) for lam in LAMS])
    np.testing.assert_allclose(np64(h_j) - np64(p_j), shift, rtol=1e-6,
                               atol=1e-6)
    assert np.all(np.abs(np.delete(shift, frame)) > 10.0)


def test_mbar_on_cross_energies(cross):
    """MBAR on a (K, K, 1) stack of the cross energies, one sample per
    window (the same frame): the port's solve satisfies the MBAR equations
    and its differences agree with the JAX sweeps run to convergence."""
    from mollytpu.free_energy import mbar as jax_mbar
    h_j, _, h, _, _, _ = cross
    e = np.repeat(np64(h)[None, :, None], len(LAMS), axis=0)
    temps = np.full(len(LAMS), TEMP)
    inp = pt.assemble_mbar_inputs(e, temperature=temps)
    jinp = jax_mbar.assemble_mbar_inputs(jnp.asarray(
        np.repeat(np64(h_j)[None, :, None], len(LAMS), axis=0)),
        temperature=jnp.asarray(temps))
    f = pt.iterate_mbar(inp)
    f_j = jax_mbar.iterate_mbar(jinp, n_iters=2000, newton_iters=0)
    np.testing.assert_allclose(np64(f), np64(f_j), rtol=0, atol=1e-6)
    assert np.all(np.isfinite(np64(f)))


def _noise_sequence(key, n_steps, shape):
    """The noise the JAX chunk runner draws: split, then normal(sub)."""
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.normal(sub, shape, jnp.float64)))
    return out


def test_trajectory_at_lambda_075_matches_jax(fep):
    """40 Langevin steps at lambda 0.75 (rebuilds at 20 and 40) against the
    JAX chunk runner with its own noise: coordinates within 1e-6 nm."""
    js, ps, _, _ = fep
    n_steps = 2 * CADENCE
    sim_j = mt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)
    nbs = jax_neighbors(js)
    key = jax.random.PRNGKey(11)
    run = jax.jit(partial(_make_chunk_fn(sim_j, False, js.neighbor_finder,
                                         align=0), n=n_steps))
    out_j, _, _, _ = run(jax_fresh_start(js, sim_j), nbs,
                         sim_j.init_aux(js, nbs), key, 0)
    noise = _noise_sequence(key, n_steps, (js.n_atoms, 3))
    sim = pt.Langevin(dt=DT, temperature=TEMP, friction=FRICTION)
    out, nb, _ = pt.simulate(ps, sim, n_steps,
                             noise=lambda k: torch.as_tensor(noise[k]))
    assert nb.step_built == n_steps
    np.testing.assert_allclose(np64(out.coords), np64(out_j.coords),
                               atol=1e-6)
    np.testing.assert_allclose(np64(out.velocities),
                               np64(out_j.velocities), atol=1e-4)
    assert torch.equal(out.atoms.lam, ps.atoms.lam)
    assert float(out.constraints[0].max_violation(out.coords,
                                                  out.boundary)) < 1e-9
