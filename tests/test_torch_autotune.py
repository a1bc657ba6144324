"""The launch tuner (ops/autotune.py) and the flag registry (config.py)
of mollytpu_torch against the JAX package's: tune_launch's cadence rule
and choice of skin under an injected score table, its cache key field for
field against JAX's for the same system, the on-disk cache's round trip,
the tile shape (block 32 only; lanes taken and not kept), a failure other than a
stale or overflowed list propagating, and ENV_FLAGS / describe_env in
JAX's format listing exactly the flags the port reads."""

import dataclasses
import os
import re

import jax.numpy as jnp
import pytest
import torch

import mollytpu as mt
from mollytpu.ops import autotune as jax_autotune

import mollytpu_torch as pt
from mollytpu_torch.ops import autotune
from mollytpu_torch.sim.simulate import NeighborOverflow
from torch_parity import LIST_RADIUS, jax_system, port_system
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SKINS = (0.10, 0.20, 0.30)


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    """An empty on-disk cache and in-process cache for each test."""
    monkeypatch.setenv("MOLLYTPU_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(autotune, "_MEM_CACHE", {})
    return tmp_path


def tune(ps, score, **kw):
    return autotune.tune_launch(
        ps.boundary, 1.0, ps.n_atoms, ps.coords, atoms=ps.atoms,
        exclusions=ps.exclusions, inters=ps.pairwise_inters, cadence=20,
        skin=0.15, skins=SKINS, score=score, **kw)


def jax_cadence(cadence, skin, s):
    """mollytpu/ops/autotune.py:257-258."""
    return max(1, int(round(cadence * (s / skin) ** 2)))


@pytest.mark.parametrize("best", [0.10, 0.15, 0.20, 0.30])
def test_skin_and_cadence_follow_jax_s_rule(cache_dir, best):
    ps = port_system("tiny64")
    seen = []

    def score(skin, cadence):
        seen.append((skin, cadence))
        return 1.0 + abs(skin - best)

    out = tune(ps, score)
    assert seen == [(s, jax_cadence(20, 0.15, s)) for s in (0.15,) + SKINS]
    assert out == {"block": 32, "lanes": 256, "skin": best,
                   "cadence": jax_cadence(20, 0.15, best),
                   "ms_per_step": 1.0}


def test_cache_key_matches_jax():
    js, ps = jax_system("tiny64"), port_system("tiny64")
    args = (LIST_RADIUS, 10)
    want = jax_autotune.cache_key(js.n_atoms, js.boundary, args[0],
                                  js.pairwise_inters, jnp.float64, args[1])
    got = autotune.cache_key(ps.n_atoms, ps.boundary, args[0],
                             ps.pairwise_inters, torch.float64, args[1])
    # the device kind: "cpu" on both sides here
    assert got.split("|") == want.split("|")


def test_the_cache_round_trips(cache_dir):
    ps = port_system("tiny64")
    first = tune(ps, lambda s, c: 2.0 - s)
    path = cache_dir / "autotune_torch.json"
    assert path.exists()
    autotune._MEM_CACHE.clear()

    def refuse(s, c):
        raise AssertionError("a cached key was timed again")

    assert tune(ps, refuse) == first
    assert first["skin"] == 0.30


def test_a_failure_propagates_and_a_stale_or_full_list_is_skipped(
        cache_dir):
    ps = port_system("tiny64")

    def launch_error(s, c):
        raise RuntimeError("CUDA error: an illegal memory access")

    with pytest.raises(RuntimeError, match="illegal memory"):
        tune(ps, launch_error)

    def overflow_at_30(s, c):
        if s > 0.25:
            raise NeighborOverflow("neighbor list overflow by 3")
        if s > 0.15:
            raise pt.StaleNeighborList("a pair went missing")
        return 1.0 + s

    assert tune(ps, overflow_at_30)["skin"] == 0.10
    # without an injected score it times on the card, and there is none
    (cache_dir / "autotune_torch.json").unlink()
    autotune._MEM_CACHE.clear()
    with pytest.raises(RuntimeError, match="CUDA card"):
        tune(ps, None)


def test_tile_shape_is_the_warp_cluster():
    ps = port_system("tiny64")
    box, n, atoms = ps.boundary, ps.n_atoms, ps.atoms
    with pytest.raises(ValueError, match="32 x 32 cluster pairs"):
        pt.BlockPairFinder.setup(box, LIST_RADIUS, n, atoms, block=64)
    finder = pt.BlockPairFinder.setup(box, LIST_RADIUS, n, atoms, block=32,
                                      lanes=128)
    plain = pt.BlockPairFinder.setup(box, LIST_RADIUS, n, atoms)
    # lanes leaves no trace: the finders are field for field the same
    for f in dataclasses.fields(finder):
        mine, want = getattr(finder, f.name), getattr(plain, f.name)
        assert (torch.equal(mine, want) if torch.is_tensor(want)
                else mine == want), f.name
    assert autotune.tune_tile_shape(box, LIST_RADIUS, n, ps.coords, atoms,
                                    ps.exclusions, ps.pairwise_inters) == \
        (32, 256)
    tuned = autotune.tuned_block_pairs(
        box, LIST_RADIUS, n, ps.coords, atoms, ps.exclusions,
        ps.pairwise_inters, n_steps=10)
    assert tuned.n_steps == 10
    assert tuned.sort_dims == finder.sort_dims


def test_env_flags_are_the_flags_the_port_reads(monkeypatch):
    root = os.path.dirname(pt.__file__)
    read = set()
    for folder, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(folder, name)) as f:
                    read |= set(re.findall(r"\"(MOLLYTPU_[A-Z_]+)\"",
                                           f.read()))
    assert read == set(pt.ENV_FLAGS)
    monkeypatch.setenv("MOLLYTPU_STRICTNESS", "error")
    table = pt.describe_env().splitlines()
    assert table[0] == mt.describe_env().splitlines()[0]
    assert [ln.split()[0] for ln in table[1:]] == sorted(pt.ENV_FLAGS)
    # a flag both registries describe alike renders as JAX renders it
    for flag in ("MOLLYTPU_STRICTNESS", "MOLLYTPU_AUTOTUNE_BUDGET"):
        assert pt.ENV_FLAGS[flag] == mt.ENV_FLAGS[flag]
        mine = next(ln for ln in table if ln.startswith(flag + " "))
        assert mine in mt.describe_env().splitlines()
    assert "error" in next(ln for ln in table
                           if ln.startswith("MOLLYTPU_STRICTNESS"))
