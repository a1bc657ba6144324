"""Gradients through mollytpu_torch (autograd) against the JAX package's
(jax.grad), float64 on the CPU: every case of tests/test_gradients.py and
tests/test_param_gradients.py, each port gradient held two ways, against
JAX's gradient on the same inputs (1e-6 relative) and against the central
difference of the port's own function at JAX's tolerance. The pair
kernel has no backward: a gradient asked for through the cluster-pair
list raises, on the CPU twin as on the card.

Trajectory gradients run simulate_differentiable (VelocityVerlet on the
dense engine; Langevin with JAX's noise replayed: per step ``key, sub =
split(key)``, normal(sub)), with and without per-step checkpointing.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mollytpu as mt
from mollytpu.ops import bonded as jbd

import mollytpu_torch as pt
from mollytpu_torch.bridge import _pairwise, system_from_arrays
from mollytpu_torch.ops import bonded as pbd
from tests.test_interactions import ALL_INTERS, atom_view
from tests.test_param_gradients import BONDED_CASES, _COORDS4
from tests.test_simulation import lj_fluid
from torch_parity import CPU, jax_noise_sequence, np64, port_system
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F64 = torch.float64
#: port gradient against JAX's on the same inputs
REL_JAX = 1e-6


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _var(x):
    return _t(x).requires_grad_(True)


def _grad(f, p):
    """df/dp; zero where f does not depend on p (as jax.grad gives)."""
    out = f(p)
    if not out.requires_grad:
        return torch.zeros_like(p)
    (g,) = torch.autograd.grad(out, p, allow_unused=True)
    return torch.zeros_like(p) if g is None else g


def _fd(f, p0, h=1e-6):
    with torch.no_grad():
        return (float(f(_t(p0 + h))) - float(f(_t(p0 - h)))) / (2 * h)


def _with_atoms(sys, **fields):
    return sys.update(atoms=dataclasses.replace(sys.atoms, **fields))


# --- tests/test_gradients.py ------------------------------------------------


@pytest.mark.parametrize("name", ["sigma", "epsilon", "charge"])
def test_grad_energy_wrt_atom_params(name):
    """dE/d(sigma, epsilon, charge) of atom 3: JAX's, and the central
    difference to 1e-5 relative."""
    js = lj_fluid(n_atoms=12, box=2.0)
    q = jnp.linspace(-0.2, 0.2, 12, dtype=jnp.float64)
    js = js.update(atoms=dataclasses.replace(js.atoms, charge=q - jnp.mean(q)),
                   pairwise_inters=(mt.LennardJones(), mt.Coulomb()))
    ps = system_from_arrays(jax.device_get(js), device=CPU)
    base = np64(getattr(js.atoms, name))

    def e_port(p3):
        col = torch.cat([_t(base[:3]), p3.reshape(1), _t(base[4:])])
        return pt.potential_energy(_with_atoms(ps, **{name: col}))

    def e_jax(p3):
        col = jnp.asarray(base).at[3].set(p3)
        return mt.potential_energy(js.update(atoms=dataclasses.replace(
            js.atoms, **{name: col})))

    g = float(_grad(e_port, _var(base[3])))
    assert g == pytest.approx(float(jax.grad(e_jax)(base[3])), rel=REL_JAX)
    assert g == pytest.approx(_fd(e_port, base[3]), rel=1e-5)


def _trajectory_loss(mod, js, ps, sim, n_steps, key, noise, obs, remat):
    """obs(final system) after n_steps of simulate_differentiable from the
    system with all epsilons (JAX: the scalar eps) set to its argument."""
    if mod is mt:
        def loss(eps):
            s = js.update(atoms=dataclasses.replace(
                js.atoms, epsilon=jnp.full_like(js.atoms.epsilon, eps)))
            return obs(mt.simulate_differentiable(s, sim, n_steps, key=key))
        return loss

    def loss(eps):
        s = _with_atoms(ps, epsilon=eps.expand(ps.n_atoms))
        return obs(pt.simulate_differentiable(s, sim, n_steps, noise=noise,
                                              remat=remat))
    return loss


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "plain"])
def test_grad_through_trajectory(remat):
    """dE_final/d(epsilon) through 20 VelocityVerlet steps: JAX's, and the
    central difference (h 1e-5) to 2e-3 relative."""
    js = lj_fluid(n_atoms=10, box=2.0, temp=20.0)
    ps = system_from_arrays(jax.device_get(js), device=CPU)
    key = jax.random.PRNGKey(80)
    args = (20, key, None)
    g_j = float(jax.grad(_trajectory_loss(
        mt, js, ps, mt.VelocityVerlet(dt=0.001), *args, mt.potential_energy,
        remat))(jnp.float64(0.2)))
    loss = _trajectory_loss(pt, js, ps, pt.VelocityVerlet(dt=0.001), *args,
                            pt.potential_energy, remat)
    g = float(_grad(loss, _var(0.2)))
    assert np.isfinite(g)
    assert g == pytest.approx(g_j, rel=REL_JAX)
    assert g == pytest.approx(_fd(loss, 0.2, h=1e-5), rel=2e-3)


@pytest.fixture(scope="module")
def pme_case():
    boundary = mt.cubic(2.0, dtype=jnp.float64)
    coords = mt.place_atoms(jax.random.PRNGKey(81), boundary, 8,
                            min_dist=0.3, dtype=jnp.float64)
    q = jnp.linspace(-0.5, 0.5, 8, dtype=jnp.float64)
    q = q - jnp.mean(q)
    atoms = mt.make_atoms(n=8, mass=10.0, charge=q, sigma=0.3, epsilon=0.1,
                          dtype=jnp.float64)
    pme_j = mt.PME.setup(boundary, dist_cutoff=0.9, error_tol=1e-4,
                         dtype=jnp.float64)
    pb = pt.cubic(2.0, F64, CPU)
    pme = pt.PME.setup(pb, dist_cutoff=0.9, error_tol=1e-4, dtype=F64)
    pa = pt.make_atoms(n=8, mass=10.0, charge=np64(q), sigma=0.3,
                       epsilon=0.1, dtype=F64, device=CPU)
    return (pme_j, boundary, atoms, coords), (pme, pb, pa, np64(coords))


def test_grad_through_pme_coordinates(pme_case):
    """dE/dx through the hand-written spread, FFT and stencil: JAX's (the
    whole (N, 3)), and the central difference of x[2, 1] to 1e-5."""
    (pme_j, bj, aj, cj), (pme, pb, pa, c) = pme_case
    g_j = np64(jax.grad(lambda x: pme_j.energy(x, bj, aj))(cj))
    x = _var(c)
    g = np64(_grad(lambda xx: pme.energy(xx, pb, pa), x))
    np.testing.assert_allclose(g, g_j, rtol=REL_JAX, atol=1e-9)

    def e21(v):
        xx = _t(c).clone()
        xx[2, 1] = v
        return pme.energy(xx, pb, pa)

    assert g[2, 1] == pytest.approx(_fd(e21, c[2, 1]), rel=1e-5)


def test_grad_through_pme_charges_and_forces(pme_case):
    """dE/dq (JAX's, finite) and a gradient through the PME forces
    (d sum f^2 / dq, JAX's through its force_virial)."""
    (pme_j, bj, aj, cj), (pme, pb, pa, c) = pme_case
    q0 = np64(aj.charge)
    gq_j = np64(jax.grad(lambda qq: pme_j.energy(
        cj, bj, dataclasses.replace(aj, charge=qq)))(jnp.asarray(q0)))
    gq = np64(_grad(lambda qq: pme.energy(
        _t(c), pb, dataclasses.replace(pa, charge=qq)), _var(q0)))
    assert np.all(np.isfinite(gq))
    np.testing.assert_allclose(gq, gq_j, rtol=REL_JAX)

    def f2_port(qq):
        f, _ = pme.force_virial(_t(c), pb, dataclasses.replace(pa, charge=qq))
        return (f * f).sum()

    gf_j = np64(jax.grad(lambda qq: jnp.sum(pme_j.force_virial(
        cj, bj, dataclasses.replace(aj, charge=qq))[0] ** 2))(
        jnp.asarray(q0)))
    gf = np64(_grad(f2_port, _var(q0)))
    np.testing.assert_allclose(gf, gf_j, rtol=REL_JAX)

    def f2_q0(v):
        qq = _t(q0).clone()
        qq[0] = v
        return f2_port(qq)

    assert gf[0] == pytest.approx(_fd(f2_q0, q0[0]), rel=1e-5)


def test_grad_langevin_reparameterized():
    """d sum x^2 / d(scale) through 10 Langevin steps on JAX's noise:
    JAX's, and the central difference to 2e-3 relative."""
    js = lj_fluid(n_atoms=8, box=2.0, temp=50.0)
    ps = system_from_arrays(jax.device_get(js), device=CPU)
    key = jax.random.PRNGKey(82)
    sim_j = mt.Langevin(dt=0.001, temperature=50.0, friction=1.0)
    sim = pt.Langevin(dt=0.001, temperature=50.0, friction=1.0)

    def loss_j(scale):
        final = mt.simulate_differentiable(
            js.update(coords=js.coords * scale), sim_j, 10, key=key)
        return jnp.sum(final.coords ** 2)

    noise = jax_noise_sequence(key, 10, (8, 3))

    def loss(scale):
        final = pt.simulate_differentiable(
            ps.update(coords=ps.coords * scale), sim, 10,
            noise=lambda k: noise[k])
        return (final.coords ** 2).sum()

    g = float(_grad(loss, _var(1.0)))
    assert np.isfinite(g)
    assert g == pytest.approx(float(jax.grad(loss_j)(jnp.float64(1.0))),
                              rel=REL_JAX)
    assert g == pytest.approx(_fd(loss, 1.0), rel=2e-3)


def test_generator_draws_replay_under_checkpointing():
    """With the generator's draws (no injected noise) the checkpointed and
    the plain loop give the same trajectory and the same gradient: the
    recomputation draws what the forward pass drew."""
    js = lj_fluid(n_atoms=8, box=2.0, temp=50.0)
    ps = system_from_arrays(jax.device_get(js), device=CPU)
    sim = pt.Langevin(dt=0.001, temperature=50.0, friction=1.0)
    out = []
    for remat in (True, False):
        scale = _var(1.0)
        final = pt.simulate_differentiable(
            ps.update(coords=ps.coords * scale), sim, 6,
            generator=torch.Generator().manual_seed(3), remat=remat)
        loss = (final.coords ** 2).sum()
        out.append((final.coords.detach(),
                    torch.autograd.grad(loss, scale)[0]))
    assert torch.equal(out[0][0], out[1][0])
    assert float(out[0][1]) == pytest.approx(float(out[1][1]), rel=1e-12)


# --- tests/test_param_gradients.py ------------------------------------------


def _port_view(**kw):
    buck = kw.pop("buck", None)
    if buck is not None:
        kw.update(buck_A=buck[0], buck_B=buck[1], buck_C=buck[2])
    return pt.make_atoms(n=1, dtype=F64, device=CPU, **kw)


@pytest.mark.parametrize("inter,akw", ALL_INTERS,
                         ids=[type(i).__name__ for i, _ in ALL_INTERS])
def test_pairwise_param_grads(inter, akw):
    """dE/d(sigma, epsilon, charge, lambda) of the i-side atom at r 0.41 nm
    for every pairwise family: JAX's, and the central difference to 2e-5
    relative."""
    port_inter = _pairwise(inter)
    base = dict(charge=0.3, sigma=0.3, epsilon=0.2)
    base.update({k: v for k, v in akw.items() if k in ("lam", "alch_role",
                                                       "buck")})
    other = dict(charge=-0.25, sigma=0.25, epsilon=0.3,
                 **{k: v for k, v in akw.items()
                    if k not in ("charge", "sigma", "epsilon")})
    aj_j, aj = atom_view(**other), _port_view(**other)
    r, special = _t([0.41]), torch.zeros(1, dtype=torch.bool)
    params = ["sigma", "epsilon", "charge"] + (["lam"] if "lam" in akw
                                               else [])
    for name in params:
        def e_jax(p):
            return inter.energy(jnp.float64(0.41), atom_view(
                **{**base, name: p}), aj_j, jnp.asarray(False))

        def e_port(p):
            ai = dataclasses.replace(_port_view(**base),
                                     **{name: p.reshape(1)})
            return port_inter.energy(r, ai, aj, special).sum()

        p0 = float(base.get(name, 0.3))
        g = float(_grad(e_port, _var(p0)))
        label = f"{type(inter).__name__} d/d{name}"
        assert np.isfinite(g), label
        assert g == pytest.approx(float(jax.grad(e_jax)(jnp.float64(p0))),
                                  rel=REL_JAX, abs=1e-12), label
        assert g == pytest.approx(_fd(e_port, p0), rel=2e-5,
                                  abs=1e-9), label


PORT_BUILDERS = {
    "harmonic_bond": lambda **p: pbd.harmonic_bonds([0], [1], **p),
    "morse_bond": lambda **p: pbd.morse_bonds([0], [1], **p),
    "fene_bond": lambda **p: pbd.fene_bonds([0], [1], **p),
    "harmonic_angle": lambda **p: pbd.harmonic_angles([0], [1], [2], **p),
    "cosine_angle": lambda **p: pbd.cosine_angles([0], [1], [2], **p),
    "urey_bradley": lambda **p: pbd.urey_bradleys([0], [1], [2], **p),
    "periodic_torsion": lambda **p: pbd.periodic_torsions(
        [0], [1], [2], [3], periodicity=[2], **p),
    "harmonic_torsion": lambda **p: pbd.harmonic_torsions([0], [1], [2], [3],
                                                          **p),
    "ewald_exclusion": lambda **p: pbd.ewald_exclusions([0], [1], **p),
}


@pytest.mark.parametrize("name,make,params", BONDED_CASES,
                         ids=[c[0] for c in BONDED_CASES])
def test_bonded_param_grads(name, make, params):
    """dE/d(param) of every continuous parameter of every bonded family
    (the hand-written energies): JAX's, and the central difference to
    2e-5 relative."""
    jb, pb = mt.cubic(5.0, dtype=jnp.float64), pt.cubic(5.0, F64, CPU)
    x = _t(_COORDS4)
    for pname, p0 in params.items():
        def e_jax(p):
            kw = {k: jnp.asarray([p if k == pname else v], jnp.float64)
                  for k, v in params.items()}
            return jbd.specific_energy(make(**kw), _COORDS4, jb)

        def e_port(p):
            kw = {k: (p.reshape(1) if k == pname else _t([v]))
                  for k, v in params.items()}
            slist = PORT_BUILDERS[name](dtype=F64, device=CPU, **kw)
            return pbd.specific_energy(slist, x, pb)

        g = float(_grad(e_port, _var(p0)))
        label = f"{name} d/d{pname}"
        assert np.isfinite(g), label
        assert g == pytest.approx(float(jax.grad(e_jax)(jnp.float64(p0))),
                                  rel=REL_JAX, abs=1e-12), label
        assert g == pytest.approx(_fd(e_port, p0), rel=2e-5,
                                  abs=1e-9), label


def test_rb_torsion_coeff_grads():
    c0 = np.asarray([[9.28, 12.16, -13.12, -3.06, 26.24, -31.5]])
    jb, pb = mt.cubic(5.0, dtype=jnp.float64), pt.cubic(5.0, F64, CPU)
    g_j = np64(jax.grad(lambda c: jbd.specific_energy(jbd.rb_torsions(
        i=[0], j=[1], k_idx=[2], l=[3], coeffs=c), _COORDS4, jb))(
        jnp.asarray(c0)))

    def e_port(c):
        return pbd.specific_energy(pbd.rb_torsions(
            [0], [1], [2], [3], coeffs=c, dtype=F64, device=CPU),
            _t(_COORDS4), pb)

    g = np64(_grad(e_port, _var(c0)))
    np.testing.assert_allclose(g, g_j, rtol=REL_JAX, atol=1e-12)
    for idx in range(6):
        def e_idx(v):
            c = _t(c0).clone()
            c[0, idx] = v
            return e_port(c)

        assert g[0, idx] == pytest.approx(_fd(e_idx, c0[0, idx]), rel=2e-5,
                                          abs=1e-9), idx


def test_position_restraint_param_grads():
    jb, pb = mt.cubic(5.0, dtype=jnp.float64), pt.cubic(5.0, F64, CPU)
    x0 = np.asarray([[0.1, 0.0, 0.0]])

    def e_port(k):
        return pbd.specific_energy(pbd.position_restraints(
            [1], k.reshape(1), _t(x0), dtype=F64, device=CPU),
            _t(_COORDS4), pb)

    g_j = float(jax.grad(lambda k: jbd.specific_energy(
        jbd.position_restraints(i=[1], k=jnp.asarray([k], jnp.float64),
                                x0=jnp.asarray(x0)), _COORDS4, jb))(
        jnp.float64(500.0)))
    g = float(_grad(e_port, _var(500.0)))
    assert g == pytest.approx(g_j, rel=REL_JAX)
    assert g == pytest.approx(_fd(e_port, 500.0, h=1e-4), rel=1e-6)


def test_remd_observable_param_grad():
    """d/d(epsilon) of a T-REMD observable (the replicas' mean final energy
    plus a Metropolis weight) through two 6-step Langevin replicas on
    JAX's noise: JAX's, and the central difference to 5e-3 relative."""
    js = lj_fluid(n_atoms=8, box=2.0, temp=30.0)
    ps = system_from_arrays(jax.device_get(js), device=CPU)
    temps = (25.0, 35.0)
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    beta = 1.0 / (pt.units.KB * np.asarray(temps))

    def observable(e1, e2, exp, minimum):
        w = exp(minimum((beta[0] - beta[1]) * (e1 - e2), 0.0))
        return 0.5 * (e1 + e2) + 0.01 * w

    def obs_j(eps):
        s = js.update(atoms=dataclasses.replace(
            js.atoms, epsilon=jnp.full_like(js.atoms.epsilon, eps)))
        e = [mt.potential_energy(mt.simulate_differentiable(
            s, mt.Langevin(dt=0.001, temperature=t, friction=1.0), 6, key=k))
            for t, k in zip(temps, (k1, k2))]
        return observable(*e, jnp.exp, jnp.minimum)

    noise = [jax_noise_sequence(k, 6, (8, 3)) for k in (k1, k2)]

    def obs(eps):
        s = _with_atoms(ps, epsilon=eps.expand(ps.n_atoms))
        e = [pt.potential_energy(pt.simulate_differentiable(
            s, pt.Langevin(dt=0.001, temperature=t, friction=1.0), 6,
            noise=lambda k, z=z: z[k])) for t, z in zip(temps, noise)]
        return observable(*e, torch.exp,
                          lambda a, b: torch.clamp(a, max=b))

    g = float(_grad(obs, _var(0.2)))
    assert np.isfinite(g)
    assert g == pytest.approx(float(jax.grad(obs_j)(jnp.float64(0.2))),
                              rel=REL_JAX)
    assert g == pytest.approx(_fd(obs, 0.2, h=1e-5), rel=5e-3)


# --- the pair kernel's guard ------------------------------------------------


def test_pair_kernel_refuses_gradients_on_the_cpu():
    """A gradient through the cluster-pair list raises NotImplementedError
    naming the differentiable engines; without grad it runs."""
    ps = port_system("tiny64", "cutoff")
    nbs = pt.find_neighbors(ps.neighbor_finder, ps.coords, ps.boundary,
                            ps.exclusions)
    x = ps.coords.clone().requires_grad_(True)
    for fn in (pt.potential_energy, pt.forces):
        with pytest.raises(NotImplementedError, match="neighbor-table"):
            fn(ps.update(coords=x), nbs)
    eps = ps.atoms.epsilon.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="dense engine"):
        pt.potential_energy(_with_atoms(ps, epsilon=eps), nbs)
    with pytest.raises(NotImplementedError):
        pt.simulate_differentiable(ps.update(coords=x),
                                   pt.VelocityVerlet(dt=0.001), 1)
    with torch.no_grad():
        e = pt.potential_energy(ps.update(coords=x), nbs)
    assert float(e) == float(pt.potential_energy(ps, nbs))
