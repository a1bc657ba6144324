"""Shared helpers of the tests/test_torch_*.py parity tests: the same water
boxes built by the JAX package (the reference) and by mollytpu_torch, and
the JAX pair list / kernel call as tests/test_kernel_consistency.py uses it
(BlockPairFinder with block=32, lanes=128; Pallas in interpret mode)."""

import dataclasses
import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.models.forcefield import ForceField as JaxForceField
from mollytpu.models.setup import system_from_pdb as jax_system_from_pdb
from mollytpu.ops.blockpairs import BlockPairFinder as JaxBlockPairFinder
from mollytpu.ops.neighbors import find_neighbors as jax_find_neighbors

import mollytpu_torch as pt
from mollytpu_torch.ops.neighbors import find_neighbors

LIST_RADIUS = 1.15   # bench.py: 1.0 nm cutoff + 0.15 nm skin
CADENCE = 20

#: the device every port entry point of the tests is given: the port
#: builds on the CUDA card unless it is told otherwise
CPU = torch.device("cpu")

#: the water boxes of the parity tests: the bench tiny box (64 waters on a
#: 6.5 A lattice, 26 A box), 512 waters at liquid density, 64 waters in
#: a rhombic dodecahedron of edge 34 A (smallest perpendicular width
#: 2.40 nm, above twice the list radius), and the tiny box's lattice with
#: TIP4P-Ew waters (four sites each, M a virtual site)
BOXES = {"tiny64": dict(n_waters=64, spacing=6.5),
         "liquid512": dict(n_waters=512),
         "dodeca64": dict(n_waters=64, spacing=8.5,
                          angles=pt.DODECAHEDRON),
         "tip4p64": dict(n_waters=64, spacing=6.5, model="tip4pew")}
#: the boxes PME runs in (orthorhombic)
PME_BOXES = ("liquid512", "tiny64")

@functools.lru_cache(maxsize=None)
def _scratch_dir():
    return tempfile.mkdtemp(prefix="mollytpu_torch_tests_")


def box_path(name):
    path = os.path.join(_scratch_dir(), name + ".pdb")
    if not os.path.exists(path):
        pt.water_box_pdb(path, **BOXES[name])
    return path


def force_field_xml(name):
    """The force field a box is written for: TIP4P-Ew or TIP3P."""
    return (pt.TIP4PEW_XML if BOXES[name].get("model") == "tip4pew"
            else pt.TIP3P_XML)


@functools.lru_cache(maxsize=None)
def jax_system(name, method="pme", rigid=True, algorithm="shake"):
    """JAX-built f64 water box (PME or reaction field; rigid water, or
    flexible H-O-H angles with constrained O-H bonds, on SHAKE or LINCS)
    with its block-pair finder attached."""
    sys = jax_system_from_pdb(
        box_path(name), JaxForceField(force_field_xml(name)),
        nonbonded_method=method, dtype=jnp.float64, constraints="hbonds",
        rigid_water=rigid, dist_neighbors=LIST_RADIUS, build_cache=False,
        constraint_algorithm=algorithm)
    finder = JaxBlockPairFinder.setup(
        sys.boundary, LIST_RADIUS, sys.n_atoms, n_steps=CADENCE,
        coords=sys.coords, atoms=sys.atoms, block=32, lanes=128)
    return sys.update(neighbor_finder=finder)


@functools.lru_cache(maxsize=None)
def port_system(name, method="pme", rigid=True, algorithm="shake"):
    """The same box built by mollytpu_torch, f64 on the CPU."""
    return pt.system_from_pdb(
        box_path(name), pt.ForceField(force_field_xml(name)),
        nonbonded_method=method,
        dtype=torch.float64, device=CPU, constraints="hbonds",
        rigid_water=rigid, dist_neighbors=LIST_RADIUS,
        neighbor_n_steps=CADENCE, constraint_algorithm=algorithm)


@functools.lru_cache(maxsize=None)
def jax_exact_system(name, method="pme", rigid=True, algorithm="shake"):
    """The JAX-built f64 box on the JAX package's dense all-pairs engine
    with the exact erfc (approximate_pme=False) and the PME of the default
    build (its smoothed mesh, which the port's setup also takes): the
    reference the port's force field meets to 1e-9, where JAX's pair
    kernel's polynomial erfc is 1e-6 off."""
    sys = jax_system_from_pdb(
        box_path(name), JaxForceField(force_field_xml(name)),
        nonbonded_method=method, dtype=jnp.float64, constraints="hbonds",
        rigid_water=rigid, approximate_pme=False, build_cache=False,
        neighbor_finder=None, constraint_algorithm=algorithm)
    inters = tuple(dataclasses.replace(i, use_neighbors=False)
                   for i in sys.pairwise_inters)
    general = sys.general_inters
    if method == "pme":
        general = (jax_system(name, method, rigid).general_inters[0],) + \
            general[1:]
    return sys.update(pairwise_inters=inters, general_inters=general)


@functools.lru_cache(maxsize=None)
def jax_dense_rf_system(name="tiny64", seed=1, temp=300.0):
    """The reaction-field box built by the JAX package (f64), on its dense
    all-pairs path (no list: exact on both sides, and seconds to compile
    where the Pallas kernel in interpret mode takes tens), with seeded
    Maxwell-Boltzmann velocities."""
    sys = jax_system_from_pdb(
        box_path(name), JaxForceField(force_field_xml(name)),
        nonbonded_method="cutoff", dtype=jnp.float64, constraints="hbonds",
        rigid_water=True, build_cache=False, neighbor_finder=None)
    inters = tuple(dataclasses.replace(i, use_neighbors=False)
                   for i in sys.pairwise_inters)
    return seeded_velocities(sys.update(pairwise_inters=inters), seed, temp)


def jax_coupler_draws(coupler, key, n_atoms, n_dof):
    """The random numbers the JAX package's ``coupler.apply`` draws from
    ``key`` (mollytpu/sim/coupling.py), as the port's ``draws`` dict of
    tensors."""
    f64 = jnp.float64
    name = type(coupler).__name__
    k1, k2 = jax.random.split(key)
    out = {}
    if name == "CRescaleBarostat":
        out = {"xi": jax.random.normal(key, (), f64)}
    elif name == "VelocityRescaleThermostat":
        out = {"r1": jax.random.normal(k1, (), f64),
               "g": 2.0 * jax.random.gamma(k2, 0.5 * (n_dof - 1),
                                           dtype=f64)}
    elif name == "AndersenThermostat":
        out = {"u": jax.random.uniform(k1, (n_atoms,)),
               "z": jax.random.normal(k2, (n_atoms, 3), dtype=f64)}
    elif name == "MonteCarloBarostat":
        out = {"dv": jax.random.uniform(k1, (), f64, minval=-1.0,
                                        maxval=1.0),
               "u": jax.random.uniform(jax.random.fold_in(k2, 7), (), f64)}
        if coupler.coupling == "anisotropic":
            out["axis"] = jax.random.randint(k2, (), 0, 3)
        elif coupler.coupling == "semiisotropic":
            out["pick_z"] = jax.random.bernoulli(k2)
    return {k: torch.as_tensor(np.array(v)) for k, v in out.items()}


def jax_step_draws(key, n_steps, n_atoms, n_dof, couplers=()):
    """Per step of the JAX chunk runner from ``key`` (simulate.py:71): the
    step's Langevin noise, normal(sub), and each coupler's draws from the
    keys apply_couplers splits off sub (coupling.py:344-347)."""
    noise, draws = [], []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        noise.append(torch.as_tensor(np64(jax.random.normal(
            sub, (n_atoms, 3), jnp.float64))))
        per, ck = [], sub
        for c in couplers:
            ck, csub = jax.random.split(ck)
            per.append(jax_coupler_draws(c, csub, n_atoms, n_dof))
        draws.append(per)
    return noise, draws


def seeded_velocities(js, seed=1, temp=300.0):
    """The JAX system with Maxwell-Boltzmann velocities drawn by numpy;
    massless sites get none."""
    rng = np.random.default_rng(seed)
    m = np64(js.atoms.mass)
    v = rng.normal(size=(js.n_atoms, 3)) * np.sqrt(
        pt.units.KB * temp / np.where(m > 0, m, 1.0))[:, None]
    v[m == 0] = 0.0
    return js.update(velocities=jnp.asarray(v))


def jax_fresh_start(js, sim):
    """The JAX system as JAX's simulate hands it to the chunk runner at the
    start of a fresh run of ``sim`` (simulate.py:157-164): centre-of-mass
    motion removed when the integrator removes it. The port's simulate
    does the same; _make_chunk_fn alone does not."""
    if getattr(sim, "remove_cm", False):
        return js.update(velocities=mt.remove_cm_motion(js.masses,
                                                        js.velocities))
    return js


def jax_dense_steps(sim, js, key, n_steps):
    """n_steps of the JAX package's ``sim`` from ``js`` on its dense engine
    (no neighbor list), each step jitted once and called from a Python
    loop with the keys the chunk runner splits (simulate.py:71): the chunk
    runner's trajectory to rounding, without compiling its scan (seconds
    instead of tens). Returns (system, aux)."""
    step = jax.jit(lambda s, a, k, n: sim.step(s, None, a, n, k))
    aux = sim.init_aux(js, None)
    for n in range(n_steps):
        key, sub = jax.random.split(key)
        js, aux = step(js, aux, sub, n)
    return js, aux


def jax_noise_sequence(key, n_steps, shape, n_sub=None):
    """The noise the JAX chunk runner's steps draw from ``key``
    (simulate.py:71): per step, split, then normal(sub) for Langevin; for
    an MTS Langevin step of n_sub innermost substeps, one draw per substep
    from split(sub, n_sub + 1), taken from the end as the step pops its
    keys (integrators.py:514-531)."""
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        if n_sub is None:
            out.append(torch.as_tensor(np64(jax.random.normal(
                sub, shape, jnp.float64))))
        else:
            keys = jax.random.split(sub, n_sub + 1)
            out.append([torch.as_tensor(np64(jax.random.normal(
                keys[n_sub - 1 - s], shape, jnp.float64)))
                for s in range(n_sub)])
    return out


def solute_atoms(coords, side):
    """The atoms of the water whose oxygen lies nearest the box centre."""
    oxy = np.arange(0, coords.shape[0], 3)
    d = np.linalg.norm(coords[oxy] - 0.5 * side, axis=1)
    o = int(oxy[np.argmin(d)])
    return np.arange(o, o + 3)


def alchemical(mod, sys, mask, lam, scheduled_pme=True):
    """``sys`` (JAX or port, ``mod`` its package) with the solute INSERTed
    at ``lam``, the soft-core pair interactions and (``scheduled_pme``) PME
    on the scheduled charges, everything else as built."""
    n = sys.coords.shape[0]
    if mod is mt:
        roles = jnp.where(jnp.asarray(mask), mt.ALCH_INSERT, mt.ALCH_CORE)
        atoms = dataclasses.replace(
            sys.atoms, lam=jnp.ones(n, sys.coords.dtype),
            alch_role=roles.astype(jnp.int32))
    else:
        roles = torch.where(torch.as_tensor(mask), pt.ALCH_INSERT,
                            pt.ALCH_CORE).to(torch.int32)
        atoms = dataclasses.replace(
            sys.atoms, lam=torch.ones(n, dtype=sys.coords.dtype),
            alch_role=roles)
    w14 = sys.pairwise_inters[1].weight_special
    pair = (mod.LennardJonesSoftCoreBeutler(
                cutoff=mod.DistanceCutoff(1.0), alpha=0.5, use_neighbors=True,
                weight_special=sys.pairwise_inters[0].weight_special),
            mod.CoulombSoftCoreBeutlerEwald(
                dist_cutoff=1.0, alpha_sc=0.5, use_neighbors=True,
                weight_special=w14))
    general = tuple(
        dataclasses.replace(g, scheduler=mod.DefaultLambdaScheduler())
        if type(g).__name__ == "PME" and scheduled_pme else g
        for g in sys.general_inters)
    out = sys.update(atoms=atoms, pairwise_inters=pair,
                     general_inters=general)
    mask_t = jnp.asarray(mask) if mod is mt else torch.as_tensor(mask)
    return mod.set_lambda(out, lam, atom_mask=mask_t)


def jax_neighbors(sys):
    return jax_find_neighbors(sys.neighbor_finder, sys.coords, sys.boundary,
                              sys.exclusions, 0)


def port_neighbors(sys):
    return find_neighbors(sys.neighbor_finder, sys.coords, sys.boundary,
                          sys.exclusions, 0)


@jax.jit
def jax_forces_virial(sys, nbs):
    return mt.forces_virial(sys, nbs, needs_virial=True)


@jax.jit
def jax_potential_energy(sys, nbs):
    return mt.potential_energy(sys, nbs)


def np64(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float64)
    return np.array(jax.device_get(x), dtype=np.float64)


def max_rel(a, b):
    """max |a - b| over max(1, max |a|): the force and virial metric."""
    a, b = np64(a), np64(b)
    return float(np.max(np.abs(a - b)) / max(1.0, np.max(np.abs(a))))


@pytest.fixture
def one_torch_thread():
    """One torch thread for the test: under pytest-xdist every worker's
    thread pool would otherwise take every core, and the small tensors of
    the eager pair engines stall on the oversubscription."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_xi_fn(seed):
    return jax.jit(lambda i, j, step_n: mt.DPDInteraction(seed=seed)._xi(
        i, j, step_n))


def jax_xi(seed, i, j, step_n):
    """The JAX package's DPD pair noise (mollytpu/ops/pairwise.py:899) for
    the port's (i, j) index tensors, as a torch tensor: the port's
    DPDInteraction._xi made JAX's, to hold the rest of the DPD path to
    JAX on the same noise."""
    return torch.as_tensor(np.array(_jax_xi_fn(int(seed))(
        jnp.asarray(i.numpy()), jnp.asarray(j.numpy()), step_n)))
