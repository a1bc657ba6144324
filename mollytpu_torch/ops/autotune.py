"""The launch tuner of the cluster-pair list (counterpart of
mollytpu/ops/autotune.py).

JAX's tuner has two stages. Stage 1 hill-climbs the Pallas kernel's
(block, lanes) tile shape. The pair kernel here evaluates 32 x 32 cluster
pairs, one warp each, so there is no shape to tune: ``tune_tile_shape``
returns (CLUSTER, lanes) untimed and ``tune_launch`` keeps it. Stage 2 is
ported as it is: the neighbor skin from ``skins``, each with the rebuild
cadence scaled by the random-walk rule cadence(s) = round(cadence
(s / skin)^2), scored by the amortised ms/step t_force + t_find /
cadence(s), where t_find is one list build and t_force one pair-kernel
force evaluation (``block_nonbonded``), each timed with CUDA events over
queued calls on the card. The choice is cached in-process and on disk
(``autotune_torch.json`` in ``MOLLYTPU_CACHE_DIR``), keyed by the card's
name, the atom count, the box, the list radius, the dtype, the cadence
and the interactions.

Where JAX's tuner skips a candidate on any exception, this one skips it
only when its list goes stale or overflows (StaleNeighborList,
NeighborOverflow): a kernel that fails to build or launch raises.

Reads MOLLYTPU_AUTOTUNE_BUDGET and MOLLYTPU_CACHE_DIR (config.ENV_FLAGS).
JAX's MOLLYTPU_AUTOTUNE and MOLLYTPU_AUTOTUNE_VERBOSE switch and report
its tile-shape sweep, which has no counterpart here, so they are not
read.
"""

from __future__ import annotations

import json
import os
import time

import torch

from ..sim.simulate import (NeighborOverflow, StaleNeighborList,
                            raise_if_overflow)
from .blockpairs import CLUSTER, BlockPairFinder
from .pair_kernel import block_nonbonded, build_fused_spec

#: the JAX package's default lanes (its Pallas j-chunk width), reported in
#: tune_launch's result; it has no meaning for the pair kernel
LANES = 256

#: in-process cache: key -> tune_launch's result
_MEM_CACHE = {}


def _cache_path():
    return os.path.join(
        os.environ.get("MOLLYTPU_CACHE_DIR",
                       os.path.expanduser("~/.cache/mollytpu")),
        "autotune_torch.json")


def _spec_signature(inters):
    """Class names and cutoff classes of the interactions, as JAX's."""
    parts = []
    for inter in sorted(inters, key=lambda i: type(i).__name__):
        cut = getattr(inter, "cutoff", None)
        cname = type(cut).__name__ if cut is not None else "-"
        parts.append(f"{type(inter).__name__}/{cname}")
    return ",".join(parts)


def cache_key(n_atoms, boundary, dist_cutoff, inters, dtype, n_steps,
              device=None):
    """JAX's key fields (mollytpu/ops/autotune.py:78-91) with the CUDA
    device's name (``device``, the box's by default) as the device kind:
    the name, the atom count, the box matrix's lower triangle, the box
    class, the list radius, the dtype, the cadence and the interactions."""
    device = torch.device(device) if device is not None else \
        boundary.box_matrix().device
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    mat = boundary.box_matrix().detach().to("cpu", torch.float64)
    rows, cols = torch.tril_indices(3, 3)
    box = "x".join(f"{float(s):.2f}" for s in mat[rows, cols])
    return "|".join([kind, str(int(n_atoms)), box, type(boundary).__name__,
                     f"{float(dist_cutoff):.3f}",
                     str(dtype).replace("torch.", ""), str(int(n_steps)),
                     _spec_signature(inters)])


def _load_disk_cache():
    try:
        with open(_cache_path()) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _store_disk_cache(key, result):
    data = _load_disk_cache()
    data[key] = result
    path = _cache_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass  # a read-only cache dir: the in-process cache holds the result


def _queued_ms(fn, reps, q=10):
    """Best over ``reps`` rounds of q queued calls of fn, CUDA events
    around each round: ms per call."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(max(2, reps)):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(q):
            fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / q)
    return best


def _time_candidate(finder, coords, boundary, atoms, exclusions, spec,
                    n_steps, reps=3):
    """Amortised ms/step of one list build per ``n_steps`` steps plus one
    pair-kernel force evaluation per step, on the card."""
    if coords.device.type != "cuda":
        raise RuntimeError("the launch tuner times the pair kernel on a "
                           "CUDA card; the coordinates are on "
                           f"{coords.device}")
    nbs = finder.find(coords, boundary, exclusions)
    if getattr(nbs, "overflow", None) is not None:
        raise_if_overflow(nbs.overflow, 0)
    t_find = _queued_ms(lambda: finder.find(coords, boundary, exclusions),
                        reps)
    t_force = _queued_ms(lambda: block_nonbonded(
        spec, coords, boundary, atoms, exclusions, nbs), reps)
    return t_force + t_find / max(1, n_steps)


def tune_tile_shape(boundary, dist_cutoff, n_atoms, coords, atoms,
                    exclusions, inters, n_steps=1, candidates=None, reps=3,
                    verbose=False):
    """(block, lanes): (CLUSTER, LANES), untimed, whatever the arguments
    (JAX's signature, so that its calls replay). The pair kernel's block
    is its warp's 32 atoms, and lanes are a TPU j-chunk width."""
    return CLUSTER, LANES


def tune_launch(boundary, rc_pair, n_atoms, coords, atoms=None,
                exclusions=None, inters=(), cadence=20, skin=0.15,
                skins=(0.10, 0.20, 0.30), budget_s=None, verbose=False,
                score=None):
    """The neighbor skin and the rebuild cadence that score best
    (mollytpu/ops/autotune.py:216-322, stage 2): the anchor (skin,
    cadence), then each other skin of ``skins`` at cadence(s) = round(
    cadence (s / skin)^2) while the budget (MOLLYTPU_AUTOTUNE_BUDGET
    seconds, default 600) lasts. Returns dict(block, lanes, skin,
    cadence, ms_per_step), cached in-process and on disk. ``score`` is an
    optional (skin, cadence) -> ms/step or None that replaces the card's
    timing (tests). The anchor failing, or interactions the pair kernel
    does not take, give the anchor untimed."""
    if budget_s is None:
        budget_s = float(os.environ.get("MOLLYTPU_AUTOTUNE_BUDGET", "600"))
    key = "joint|" + cache_key(n_atoms, boundary, rc_pair, inters,
                               coords.dtype, cadence, coords.device)
    if key in _MEM_CACHE:
        return _MEM_CACHE[key]
    disk = _load_disk_cache().get(key)
    if disk is not None:
        _MEM_CACHE[key] = disk
        return disk

    fallback = {"block": CLUSTER, "lanes": LANES, "skin": float(skin),
                "cadence": int(cadence)}
    nl = tuple(i for i in inters if getattr(i, "use_neighbors", False))
    try:
        spec = build_fused_spec(nl or inters)
    except NotImplementedError:
        return fallback

    t0 = time.time()

    def cadence_of(s):
        return max(1, int(round(cadence * (s / skin) ** 2)))

    def measure(s):
        try:
            if score is not None:
                ms = score(s, cadence_of(s))
            else:
                finder = BlockPairFinder.setup(
                    boundary, rc_pair + s, n_atoms, atoms,
                    n_steps=cadence_of(s))
                ms = _time_candidate(finder, coords, boundary, atoms,
                                     exclusions, spec, cadence_of(s))
        except (StaleNeighborList, NeighborOverflow):
            ms = None
        if verbose:
            print(f"autotune: skin={s:.2f} cadence={cadence_of(s)} -> "
                  f"{'fail' if ms is None else f'{ms:.3f} ms/step'}",
                  flush=True)
        return ms

    best_skin, best_ms = float(skin), measure(skin)
    if best_ms is None:
        return fallback
    for s in skins:
        if abs(s - skin) < 1e-9 or time.time() - t0 >= budget_s:
            continue
        ms = measure(s)
        if ms is not None and ms < best_ms:
            best_skin, best_ms = float(s), ms

    result = {"block": CLUSTER, "lanes": LANES, "skin": best_skin,
              "cadence": cadence_of(best_skin), "ms_per_step": float(best_ms)}
    _MEM_CACHE[key] = result
    _store_disk_cache(key, result)
    return result


def tuned_block_pairs(boundary, dist_cutoff, n_atoms, coords, atoms=None,
                      exclusions=None, inters=(), n_steps=1):
    """A BlockPairFinder (mollytpu/ops/autotune.py:325-342, JAX's
    signature): the tile shape JAX sweeps is fixed here, so this is
    BlockPairFinder.setup."""
    return BlockPairFinder.setup(boundary, dist_cutoff, n_atoms, atoms,
                                 n_steps=n_steps)
