"""TSS of mollytpu_torch (free_energy/tss_graph.py, free_energy/tss.py)
against the JAX package, float64 on the CPU.

The window graphs and the estimators are the JAX package's pure-Python and
NumPy code: the graphs of tests/test_tss.py come out equal field by field,
and TSSState fed the same observations gives the same local estimates,
coupling, stitched free energies and jackknife, to 1e-12. TSSSimulation
runs on the 8-atom soft-core system of tests/test_free_energy.py (dense
engine, no list) with the JAX package's Langevin noise replayed into the
port (per replica: one key of split(key, n_replicas); per segment
``key, sub = split(key)``; one split of ``sub`` per step): after 12 cycles
the same rungs and windows and the same f (1e-9), with one replica and
with two.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mollytpu as mt
from mollytpu.free_energy import tss as jax_tss
from mollytpu.free_energy import tss_graph as jax_graph

import mollytpu_torch as pt
from mollytpu_torch.bridge import system_from_arrays
from mollytpu_torch.free_energy import tss, tss_graph
from torch_parity import CPU, jax_noise_sequence, np64
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-9


def _plain(obj):
    """An object as nested plain values: dataclasses and objects by their
    attributes (class name included), sequences as lists, arrays as
    lists."""
    if dataclasses.is_dataclass(obj) or hasattr(obj, "__dict__"):
        return {"class": type(obj).__name__,
                **{k: _plain(v) for k, v in vars(obj).items()}}
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


def _graphs(mod):
    b = mod.TSSGraphBuilder()
    mod.add_tss_edge(b, ["a", "b"], (4,), window_size=2)
    mod.add_tss_edge(b, ["b", "c"], (4,), window_size=2)
    return {"1d": mod.tss_grid_graph((4,), window_size=(2,), periodic=False),
            "periodic": mod.tss_grid_graph((4,), window_size=(2,),
                                           periodic=True),
            "2d": mod.tss_grid_graph((4, 4), window_size=(2, 2)),
            "12x4": mod.tss_grid_graph((12,), window_size=4),
            "edges": mod.build_tss_graph(b),
            "single": mod.single_window_tss_graph(5)}


@pytest.mark.parametrize("name", tuple(_graphs(tss_graph)))
def test_graph_matches_jax(name):
    g, g_j = _graphs(pt)[name], _graphs(mt)[name]
    assert isinstance(g, pt.TSSGraph)
    assert _plain(g) == _plain(g_j)
    if name == "single":
        return
    for w in range(len(g.windows)):
        for s in g.windows[w].state_indices:
            assert tss_graph.tss_swap_window(g, w, s) == \
                jax_graph.tss_swap_window(g_j, w, s)


def test_graph_validation_matches_jax():
    for mod in (pt, mt):
        with pytest.raises(ValueError):
            mod.tss_grid_graph((5,), window_size=(2,))
        with pytest.raises(ValueError):
            mod.tss_grid_graph((9,), window_size=(3,))
        with pytest.raises(ValueError):
            mod.TSSWindow(0, [0, 2])
    # the chip run's graph: 7 windows, at most 6 evaluation states each
    g = pt.tss_grid_graph((12,), window_size=4)
    assert len(g.windows) == 7
    assert max(len(w.evaluation_state_indices) for w in g.windows) == 6


def _state(mod, n_states=4):
    space = mod.ExtendedStateSpace.lambda_grid(
        np.linspace(1.0, 0.6, n_states), temperature=298.0)
    return mod.TSSState(
        space, graph=mod.tss_grid_graph((n_states,), window_size=(2,)),
        first_state=0, first_window=0, ETA=1.0, dens_reg=1e-4,
        history_forgetting=mod.TSSHistoryForgetting(alpha=0.0, phi=1.5))


def _observations(mod, state, rng, n_rep):
    """One cycle's observations: each replica in a random window, a random
    visited and next rung in it, random reduced potentials and weights."""
    out = []
    for ri in range(n_rep):
        w = int(rng.integers(len(state.windows)))
        local = list(state.windows[w].state_indices)
        u = rng.normal(0.0, 2.0, len(local))
        wts = rng.uniform(0.1, 1.0, len(local))
        out.append(mod._Observation(
            replica_index=ri, update_window=w,
            visited_state=int(rng.choice(local)),
            sampled_next_state=int(rng.choice(local)),
            log_den=float(rng.normal()), reduced_pot=u,
            weights=wts / wts.sum(), adaptive_values=None, pmf_samples=[]))
    return out


def _fold(mod, module):
    state = _state(mod)
    rng = np.random.default_rng(17)
    max_df = []
    for cycle in range(30):
        obs = _observations(module, state, rng, 1 + cycle % 2)
        max_df.append(state.apply_observations(obs))
    jk = mod.tss_free_energy_uncertainties(state)
    return dict(
        max_df=max_df, iteration=state.iteration,
        counts=list(state.window_update_counts),
        f=[e.f for e in state.estimators],
        tilts=[e.tilts for e in state.estimators],
        density=[e.density for e in state.estimators],
        coupling=_plain(state.coupling),
        reported=mod.tss_free_energies(state),
        visited=mod.tss_free_energies(state, visited_only=True),
        jk=(jk.free_energies, jk.standard_errors, jk.replicates,
            jk.epoch_indices, jk.epoch_weights))


def _assert_close(a, b, tol=1e-12):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_close(a[k], b[k], tol)
    elif isinstance(a, (list, tuple)) and not (
            a and isinstance(a[0], (int, float, np.floating))):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_close(x, y, tol)
    elif isinstance(a, str) or a is None or isinstance(a, bool):
        assert a == b
    else:
        np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                                   np.asarray(b, dtype=np.float64),
                                   rtol=tol, atol=tol)


def test_apply_observations_matches_jax():
    ours, ref = _fold(pt, tss), _fold(mt, jax_tss)
    _assert_close(ours, ref)
    assert np.all(np.isfinite(ours["reported"]))
    assert np.any(np.asarray(ours["jk"][1]) > 0)


def _softcore(mod):
    """The 8-atom soft-core system of tests/test_free_energy.py (JAX), or
    its bridged copy."""
    key = jax.random.PRNGKey(64)
    boundary = mt.cubic(2.0, dtype=jnp.float64)
    coords = mt.place_atoms(key, boundary, 8, min_dist=0.35,
                            dtype=jnp.float64)
    atoms = mt.make_atoms(n=8, mass=10.0, sigma=0.3, epsilon=0.3, lam=1.0,
                          alch_role=jnp.asarray([2, 2] + [0] * 6),
                          dtype=jnp.float64)
    vels = mt.random_velocities(jax.random.PRNGKey(65), atoms.mass, 80.0,
                                dtype=jnp.float64)
    js = mt.System(atoms=atoms, coords=coords, boundary=boundary,
                   velocities=vels,
                   pairwise_inters=(mt.LennardJonesSoftCoreBeutler(
                       alpha=0.5),))
    if mod is mt:
        return js
    return system_from_arrays(jax.device_get(js), device=CPU)


N_CYCLES, N_MD = 12, 10


def _tss_run(mod, n_rep, **run):
    space = mod.ExtendedStateSpace.lambda_grid(np.linspace(0.0, 1.0, 4),
                                               temperature=80.0)
    hist = mod.TSSHistoryForgetting() if n_rep > 1 else None
    state = mod.TSSState(space, graph=mod.tss_grid_graph((4,),
                                                         window_size=2),
                         history_forgetting=hist)
    sim = mod.TSSSimulation(
        state, _softcore(mod), mod.Langevin(dt=0.002, temperature=80.0,
                                            friction=5.0),
        n_md_steps=N_MD, n_cycles=N_CYCLES, log_freq=1, n_replicas=n_rep,
        first_states=None if n_rep == 1 else [0, 3])
    sim.run(**run)
    return sim, state


@pytest.mark.parametrize("n_rep", [1, 2])
def test_tss_simulation_matches_jax(n_rep):
    key = jax.random.PRNGKey(66)
    sim_j, st_j = _tss_run(mt, n_rep, key=key, seed=5)
    noise = {}
    for ri, rkey in enumerate(jax.random.split(key, n_rep)):
        for cycle in range(N_CYCLES):
            rkey, sub = jax.random.split(rkey)
            for k, z in enumerate(jax_noise_sequence(sub, N_MD, (8, 3))):
                noise[ri, cycle * N_MD + k] = z
    sim, st = _tss_run(pt, n_rep, seed=5,
                       noise=lambda ri, step_n: noise[ri, step_n])
    # rungs, windows and replica records equal; the logged |delta f| to TOL
    _assert_close(st.stats, st_j.stats, TOL)
    assert [(r.state_index, r.window) for r in sim.replicas] == \
        [(r.state_index, r.window) for r in sim_j.replicas]
    assert len(set(st.stats["visited_state"])) > 1
    for e, e_j in zip(st.estimators, st_j.estimators):
        np.testing.assert_allclose(e.f, e_j.f, rtol=0, atol=TOL)
    np.testing.assert_allclose(pt.tss_free_energies(st),
                               mt.tss_free_energies(st_j), rtol=0, atol=TOL)
    for r, r_j in zip(sim.replicas, sim_j.replicas):
        np.testing.assert_allclose(np64(r.sys.coords), np64(r_j.sys.coords),
                                   rtol=0, atol=TOL)
    assert sim.current_step == sim_j.current_step == N_CYCLES * N_MD
