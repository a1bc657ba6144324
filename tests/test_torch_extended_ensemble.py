"""ExtendedStateSpace of mollytpu_torch (free_energy/extended_ensemble.py)
against the JAX package on the 64-water PME box, float64: the K-state
energies (state_energies) and reduced potentials (reduced_potentials) of a
lambda grid over one alchemically inserted water, of a subset of it
(``indices``), of umbrella windows, of a temperature ladder and of states
with and without a pressure; state application (apply_state,
integrator_for) and the carried space (bridge).

The plain PME box is held to the JAX package's dense exact-erfc system
(torch_parity.jax_exact_system), the alchemical box to its pair-list
system with the same Beutler soft-core forms on both sides
(torch_parity.alchemical, as tests/test_torch_fep_slice.py): energies and
reduced potentials agree to 1e-9 relative (summation order). With PME on
the scheduled charges the port's cross energies count PME as perturbed and
equal LambdaHamiltonian.energies; the JAX package's keep PME at the
frame's lambda (ROADMAP Queue 3), recorded here as a difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt

import mollytpu_torch as pt
from mollytpu_torch.bridge import free_energy_from_arrays
from torch_parity import (CPU, alchemical, jax_exact_system, jax_neighbors,
                          jax_system, np64, port_neighbors, port_system,
                          solute_atoms)
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-9
LAMS = (0.0, 0.3, 0.6, 1.0)
BOX = "tiny64"


def _mask():
    js = jax_system(BOX)
    mask = np.zeros(js.n_atoms, dtype=bool)
    mask[solute_atoms(np64(js.coords), np64(js.boundary.side_lengths))] = True
    return mask


def _space(mod, case, mask):
    """The case's ExtendedStateSpace in package ``mod``."""
    if case in ("lambda_grid", "lambda_subset", "scheduled_pme"):
        m = jnp.asarray(mask) if mod is mt else torch.as_tensor(mask)
        return mod.ExtendedStateSpace.lambda_grid(LAMS, temperature=300.0,
                                                  atom_mask=m)
    if case == "umbrella":
        oxy = np.nonzero(mask)[0][0]
        cv = mod.CalcSingleDist(int(oxy), int(oxy + 3))
        return mod.ExtendedStateSpace.umbrella_windows(
            [mod.BiasPotential(bias=mod.SquareBias(k=2000.0, cv0=c), cv=cv)
             for c in (0.5, 0.6, 0.65, 0.8)], temperature=300.0)
    if case == "temperature":
        return mod.ExtendedStateSpace.temperature_ladder((280.0, 300.0,
                                                          330.0))
    states = (mod.ThermoState(lam=1.0, temperature=300.0, pressure=0.06),
              mod.ThermoState(lam=1.0, temperature=310.0),
              mod.ThermoState(lam=1.0, temperature=290.0, pressure=0.1))
    return mod.ExtendedStateSpace(states)


CASES = ("lambda_grid", "lambda_subset", "umbrella", "temperature",
         "pressure")


@pytest.fixture(scope="module")
def frames():
    """(JAX system, its list, port system, its list) for the alchemical
    box (scheduled PME or not) and the plain PME box."""
    mask = _mask()
    out = {}
    for sched in (False, True):
        js = alchemical(mt, jax_system(BOX), mask, 1.0, scheduled_pme=sched)
        ps = alchemical(pt, port_system(BOX), mask, 1.0, scheduled_pme=sched)
        out[sched] = (js, jax_neighbors(js), ps, port_neighbors(ps))
    ps = port_system(BOX)
    out["plain"] = (jax_exact_system(BOX), None, ps, port_neighbors(ps))
    return out, mask


@pytest.mark.parametrize("case", CASES)
def test_state_energies_match_jax(frames, case):
    systems, mask = frames
    js, jnb, ps, nb = systems[False if case.startswith("lambda") else
                              "plain"]
    jspace = _space(mt, case, mask)
    space = _space(pt, case, mask)
    carried = free_energy_from_arrays(jax.device_get(jspace), device=CPU)
    idx = (3, 1) if case == "lambda_subset" else None
    e_j, u_j = jax.jit(lambda s, n: (
        jspace.state_energies(s, n, indices=idx),
        jspace.reduced_potentials(s, n, indices=idx)))(js, jnb)
    for sp in (space, carried):
        e = sp.state_energies(ps, nb, indices=idx)
        u = sp.reduced_potentials(ps, nb, indices=idx)
        assert e.dtype == torch.float64 and e.shape == (len(idx or sp.states),)
        np.testing.assert_allclose(np64(e), np64(e_j), rtol=TOL)
        np.testing.assert_allclose(np64(u), np64(u_j), rtol=TOL)
    if case == "lambda_subset":
        full = np64(space.state_energies(ps, nb))
        np.testing.assert_array_equal(np64(e), full[list(idx)])
    if case == "lambda_grid":
        # lambda moves the inserted water's energy
        assert float(e[0] - e[-1]) > 1.0
    if case == "umbrella":
        # one shared energy plus each window's bias
        u0 = float(pt.potential_energy(ps, nb))
        biases = [float(b.energy(ps.coords, ps.boundary, ps.atoms))
                  for b in space.biases]
        np.testing.assert_allclose(np64(e), u0 + np.array(biases),
                                   rtol=1e-14)
        assert len(set(biases)) == len(biases)


def test_scheduled_pme_cross_energies(frames):
    """With PME on the scheduled charges the port's state energies equal
    LambdaHamiltonian.energies (its own and the JAX package's); the JAX
    package's state energies keep PME at the frame's lambda (1.0), so they
    differ from them except there."""
    systems, mask = frames
    js, jnb, ps, nb = systems[True]
    jspace, space = _space(mt, "scheduled_pme", mask), _space(
        pt, "scheduled_pme", mask)
    e = np64(space.state_energies(ps, nb))
    np.testing.assert_allclose(e, np64(pt.LambdaHamiltonian(
        atom_mask=torch.as_tensor(mask)).energies(ps, LAMS, nb)), rtol=1e-12)
    h_j = jax.jit(lambda s, n: mt.LambdaHamiltonian(
        atom_mask=jnp.asarray(mask)).energies(s, jnp.asarray(LAMS), n))(
        js, jnb)
    np.testing.assert_allclose(e, np64(h_j), rtol=TOL)
    e_j = np64(jax.jit(lambda s, n: jspace.state_energies(s, n))(js, jnb))
    shift = e - e_j
    assert abs(shift[-1]) < 1e-6 * abs(e[-1])
    assert np.all(np.abs(shift[:-1]) > 1.0), shift


def test_apply_state_and_integrator(frames):
    """apply_state sets lambda on the masked atoms and appends the state's
    bias; integrator_for takes the state's temperature."""
    systems, mask = frames
    ps = systems[False][2]
    space = _space(pt, "lambda_grid", mask)
    at = space.apply_state(ps, 1)
    lam = np64(at.atoms.lam)
    assert np.all(lam[mask] == LAMS[1]) and np.all(lam[~mask] == 1.0)
    assert at.general_inters == ps.general_inters
    umb = _space(pt, "umbrella", mask)
    biased = umb.apply_state(systems["plain"][2], 2)
    assert biased.general_inters[-1] is umb.biases[2]
    ladder = _space(pt, "temperature", mask)
    sim = ladder.integrator_for(pt.Langevin(dt=0.002, temperature=300.0,
                                            friction=1.0), 2)
    assert sim.temperature == 330.0 and sim.dt == 0.002
    cursor = pt.free_energy.extended_ensemble.ActiveThermoState(ladder)
    assert cursor.move(7).temperature == 330.0 and cursor.index == 2
    np.testing.assert_allclose(ladder.betas(), _space(
        mt, "temperature", mask).betas(), rtol=1e-15)
