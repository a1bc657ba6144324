"""One alchemical window of GROMACS's water benchmark on the port's main
path, on the CPU: the committed SPC tile read by system_from_gromacs on
the cluster-pair list, the water whose oxygen is nearest the box centre
coupled by couple_molecule (Beutler soft-core LJ and Ewald real space on
the pair kernel's soft-core path, PME on the scheduled charges with the
excluded pairs inside PME) at lambda 0.75, held against the benchmark's
plain reference (benchmark/reference/spc_water_fep.py, float64): the
energy and forces, U at five lambdas by both cross-energy paths, and one
chunk of leap-frog with v-rescale. The lambda-dependent terms
(PerturbedTerms) equal the whole-system energies in float64; the coupled
PME differs from the unscaled exclusion correction by the solute's own
term; two planted faults fail the comparison.

The pair work is cut to a 0.6 nm cutoff (list radius 0.7 nm), as in
test_torch_water_gmx.py. Tolerances: forces 1e-4 of the reference's rms
per atom, energy 1e-5 relative (2.4e-6 read: the soft-core path screens
every pair with the Abramowitz-Stegun erfc, the reference with the exact
one), a chunk's positions 2e-5 nm; U_k - U(0.75)
against the reference's: 1e-3 kT on the lambda-dependent terms, 0.05 kT
on float32 totals of the whole 3,000-atom system (0.0074 kT read).
"""

import dataclasses
import json
import math
import os
import sys

import pytest
import torch

import mollytpu_torch as pt
from mollytpu_torch import tracing
from mollytpu_torch.free_energy import extended_ensemble
from mollytpu_torch.models import gromacs, waterbox
from mollytpu_torch.ops.ewald import EwaldExclusionCorrection

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from reference.precision import F64  # noqa: E402
from reference.spc_water_fep import SPCWaterFEP  # noqa: E402
from systems.gmx_water_fep import solute_mask  # noqa: E402

CPU = torch.device("cpu")
RC, RLIST = 0.6, 0.7
LAM = 0.75
LAMS = [0.0, 0.25, 0.5, 0.75, 1.0]
KT = 0.00831446261815324 * 300.0
CONFIG = os.path.join(BENCH, "configs", "gmx-water-fep-1536000.json")


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def config():
    with open(CONFIG) as fh:
        cfg = json.load(fh)
    cfg["water"]["tiles_per_side"] = 1
    cfg["mdp"]["rcoulomb"] = cfg["mdp"]["rvdw"] = RC
    return cfg


def build(tmp, dtype=torch.float32):
    gro = gromacs.read_gro(waterbox.SPC_TILE)
    top = waterbox.spc_topology(str(tmp / "spc.top"), len(gro[0]) // 3)
    return gromacs.system_from_gromacs(
        gro, top, nonbonded_method="pme", dist_cutoff=RC,
        dist_neighbors=RLIST, device=CPU, dtype=dtype, use_settles=True,
        dispersion_correction=False, velocities_from_gro=False,
        neighbor_finder="block", ewald_rtol=1e-5, fourier_spacing=0.12,
        pme_order=4)


def coupled(system, mask, lam=LAM):
    return pt.set_lambda(pt.couple_molecule(system, mask), lam, mask)


def neighbors(s):
    return pt.find_neighbors(s.neighbor_finder, s.coords, s.boundary,
                             s.exclusions, 0)


@pytest.fixture(scope="module")
def window(tmp_path_factory):
    """The tile started at 300 K from a seed with its central water coupled
    at lambda 0.75, the solute mask, and the reference at the same
    cutoff."""
    d = tmp_path_factory.mktemp("fep")
    s = gromacs.gen_vel_start(build(d), 300.0,
                              torch.Generator().manual_seed(2 ** 31 + 7))
    mask = solute_mask(s)
    return d, coupled(s, mask), mask, SPCWaterFEP(config(), F64, CPU, LAM)


def du_gap(u, u_ref):
    """max_k |(U_k - U(0.75)) - (U_ref,k - U_ref(0.75))| in kT."""
    k = LAMS.index(LAM)
    u, u_ref = u.double(), u_ref.double()
    return float(((u - u[k]) - (u_ref - u_ref[k])).abs().max()) / KT


def test_energy_and_forces_match_the_reference(window):
    _, s, mask, ref = window
    assert torch.equal(torch.nonzero(mask).flatten(), ref.solute)
    assert int(s.atoms.alch_role[mask].min()) == pt.ALCH_INSERT
    nb = neighbors(s)
    assert isinstance(nb, pt.BlockPairs)
    f = pt.forces(s, nb)
    f_ref = ref.forces(s.coords.double())
    rms = torch.sqrt((f_ref * f_ref).sum(1).mean())
    assert float((f.double() - f_ref).norm(dim=1).max() / rms) < 1e-4
    e, e_ref = float(pt.potential_energy(s, nb)), float(ref.energy(
        s.coords.double()))
    assert abs(e - e_ref) / abs(e_ref) < 1e-5


@pytest.mark.parametrize("path,tol", [("whole", 0.05),
                                      ("perturbed", 1e-3)])
def test_cross_energies_match_the_reference(window, path, tol):
    """U at the five lambdas from ExtendedStateSpace.state_energies, whole
    system per lambda or the lambda-dependent terms, against the
    reference's differences; the counter takes the five states on that
    path."""
    _, s, mask, ref = window
    nb = neighbors(s)
    terms = pt.PerturbedTerms.setup(s, mask) if path == "perturbed" else None
    space = pt.ExtendedStateSpace.lambda_grid(LAMS, 300.0, atom_mask=mask,
                                              perturbed_terms=terms)
    before = dict(extended_ensemble.STATE_EVALUATIONS)
    u = space.state_energies(s, nb)
    after = extended_ensemble.STATE_EVALUATIONS
    assert after[path] - before[path] == 5
    assert sum(after.values()) - sum(before.values()) == 5
    assert u.dtype == torch.float64 and u.shape == (5,)
    assert du_gap(u, ref.energies(s.coords.double(), LAMS)) < tol


def test_perturbed_terms_equal_the_lambda_hamiltonian_in_float64(window):
    """In float64 the lambda-dependent terms give the whole-system
    energies of LambdaHamiltonian to rounding, at a running lambda in each
    half of the schedule."""
    d, s32, mask, _ = window
    s = build(d, torch.float64).update(coords=s32.coords.double())
    for lam in (0.75, 0.25):
        c = coupled(s, mask, lam)
        nb = neighbors(c)
        whole = pt.LambdaHamiltonian(mask).energies(c, LAMS, nb)
        terms = pt.PerturbedTerms.setup(c, mask).energies(c, nb, LAMS)
        assert float((terms - whole).abs().max()) < 1e-8 * float(
            whole.abs().max())


def test_pme_charge_change_energy_is_the_energy_difference(window):
    """PME.charge_change_energy against two float64 energies of PME on
    the changed charges and on the charges as they are, with the excluded
    pairs inside PME: one row of no change, one of the solute's charges
    off and one of an arbitrary change."""
    d, s32, mask, _ = window
    c = coupled(build(d, torch.float64).update(coords=s32.coords.double()),
                mask)
    pme = dataclasses.replace(c.general_inters[0], scheduler=None)
    assert pme.excl_i.shape[0] > 0
    q, idx = c.atoms.charge, torch.nonzero(mask).flatten()
    dq = torch.stack([torch.zeros(3, dtype=torch.float64), -q[idx],
                      torch.tensor([0.3, -0.7, 0.05], dtype=torch.float64)])

    def energy(charge):
        atoms = dataclasses.replace(c.atoms, charge=charge)
        return float(pme.energy(c.coords, c.boundary, atoms))
    e0 = energy(q)
    want = torch.tensor([energy(q.index_add(0, idx, row)) - e0
                         for row in dq], dtype=torch.float64)
    got = pme.charge_change_energy(c.coords, c.boundary, q, idx, dq)
    assert got.dtype == torch.float64 and got.shape == (3,)
    assert float(got[0]) == 0.0
    assert float((got - want).abs().max()) < 1e-9 * abs(e0)


def test_chunk_matches_the_reference(window):
    """One chunk of 10 steps of leap-frog with v-rescale at lambda 0.75
    against the reference's SETTLE leap-frog from the same state with the
    same thermostat draws."""
    _, s, _, ref = window
    thermo = pt.VelocityRescaleThermostat(300.0, 0.1)
    sim = pt.Verlet(dt=0.002, coupling=(thermo,), remove_cm=False)
    gen = torch.Generator().manual_seed(13)
    nb = neighbors(s)
    aux = sim.init_aux(s, nb)
    state = gen.get_state()
    out, _, _, _ = pt.run_chunk(sim, s, nb, aux, 0, 10, generator=gen)
    replay = torch.Generator()
    replay.set_state(state)
    draws = []
    for _ in range(10):
        dr = thermo.draw(s, replay)
        draws.append((float(dr["r1"]), float(dr["g"])))
    x_ref, _ = ref.leapfrog(s.coords.double(), s.velocities.double(), 10,
                            0.002, 300.0, 0.1, draws)
    assert float(ref.mic(out.coords.double() - x_ref).norm(dim=1).max()) \
        < 2e-5


def _unscaled_exclusions(c, plain):
    """The coupled system with PME's excluded pairs handed back to the
    Ewald exclusion correction on the unscaled charges (the JAX
    package's convention, chip_smoke.py's fep_system)."""
    pme = c.general_inters[0]
    empty = pme.excl_i[:0]
    excl = [g for g in plain.general_inters
            if isinstance(g, EwaldExclusionCorrection)]
    return c.update(general_inters=(dataclasses.replace(
        pme, excl_i=empty, excl_j=empty), *excl))


@pytest.mark.parametrize("lam", [0.25, 0.75, 1.0])
def test_coupled_pme_differs_from_the_unscaled_correction_by_the_solute(
        window, lam):
    """The coupling call's PME against the exclusion correction on the
    unscaled charges: the whole difference is the solute's excluded
    pairs, -ke q_i q_j erf(alpha r) / r (s^2 - 1) at the charge scale s;
    0 at lambda 1."""
    d, s32, mask, _ = window
    plain = build(d, torch.float64).update(coords=s32.coords.double())
    c = coupled(plain, mask, lam)
    jax_like = _unscaled_exclusions(c, plain)
    nb = neighbors(c)
    diff = float(pt.potential_energy(c, nb) - pt.potential_energy(
        jax_like, nb))
    pme = c.general_inters[0]
    x, q = c.coords, c.atoms.charge
    idx = torch.nonzero(mask).flatten().tolist()
    scale = pt.DefaultLambdaScheduler.scale_elec(
        torch.tensor(lam, dtype=torch.float64),
        torch.tensor(pt.ALCH_INSERT))
    want = 0.0
    for a in range(3):
        for b in range(a + 1, 3):
            i, j = idx[a], idx[b]
            r = float(torch.linalg.vector_norm(x[j] - x[i]))
            want -= (pme.coulomb_const * float(q[i] * q[j])
                     * math.erf(pme.alpha * r) / r
                     * (float(scale) ** 2 - 1.0))
    assert diff == pytest.approx(want, rel=1e-9, abs=1e-9)


def _fault_unscaled_exclusions(c, plain):
    return _unscaled_exclusions(c, plain)


def _fault_no_softcore_coulomb(c, plain):
    lj, coul = c.pairwise_inters
    return c.update(pairwise_inters=(lj, dataclasses.replace(
        coul, alpha_sc=0.0)))


FAULTS = {"unscaled_exclusions": _fault_unscaled_exclusions,
          "no_softcore_coulomb": _fault_no_softcore_coulomb}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails_the_reference(window, fault):
    """Each fault moves the energy at lambda 0.75 beyond the 1e-5 the
    program meets, and U_k - U(0.75) beyond the 1e-3 kT of the
    lambda-dependent terms."""
    d, s, mask, ref = window
    broken = FAULTS[fault](s, build(d).update(coords=s.coords))
    nb = neighbors(broken)
    e_ref = float(ref.energy(s.coords.double()))
    assert abs(float(pt.potential_energy(broken, nb)) - e_ref) \
        / abs(e_ref) > 1e-5
    u = pt.LambdaHamiltonian(mask).energies(broken, LAMS, nb)
    assert du_gap(u, ref.energies(s.coords.double(), LAMS)) > 1e-3


def test_state_energies_run_under_the_fep_cross_span(window):
    _, s, mask, _ = window
    nb = neighbors(s)
    space = pt.ExtendedStateSpace.lambda_grid(
        LAMS, 300.0, atom_mask=mask,
        perturbed_terms=pt.PerturbedTerms.setup(s, mask))
    with tracing.recording(), torch.profiler.profile() as prof:
        space.state_energies(s, nb)
    names = [e.name for e in prof.events()]
    assert names.count("fep.cross") == 1
    assert "forces.pairs" not in names and "forces.pme" not in names


def test_coupling_refuses_what_it_cannot_couple(window):
    """couple_molecule needs LJ, Ewald real space and PME; PerturbedTerms
    needs the soft-core pair path."""
    d, s, mask, _ = window
    plain = build(d)
    rf = gromacs.system_from_gromacs(
        gromacs.read_gro(waterbox.SPC_TILE), str(d / "spc.top"),
        nonbonded_method="cutoff", dist_cutoff=RC, dist_neighbors=RLIST,
        device=CPU, use_settles=True, neighbor_finder="block")
    with pytest.raises(NotImplementedError, match="CoulombEwald"):
        pt.couple_molecule(rf, mask)
    with pytest.raises(NotImplementedError, match="one PME"):
        pt.couple_molecule(plain.update(general_inters=()), mask)
    with pytest.raises(NotImplementedError, match="soft-core"):
        pt.PerturbedTerms.setup(plain, mask)


def test_a_cap_that_leaves_out_a_partner_gives_nan(window):
    """The pair scan keeps the cap nearest atoms of each perturbed atom:
    with a cap that cannot hold every atom inside the cutoff the cross
    energies come back NaN, not short."""
    _, s, mask, _ = window
    nb = neighbors(s)
    terms = pt.PerturbedTerms.setup(s, mask)
    assert 64 < terms.cap < s.n_atoms
    assert bool(torch.isfinite(terms.energies(s, nb, LAMS)).all())
    short = dataclasses.replace(terms, cap=16)
    assert bool(torch.isnan(short.energies(s, nb, LAMS)).all())
