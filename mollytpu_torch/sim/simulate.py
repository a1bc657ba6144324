"""The simulation loop (counterpart of mollytpu/sim/simulate.py:27-266).

A chunk of n steps runs as the JAX package schedules its scan: steps up to
the next rebuild boundary, then periods of r = finder.n_steps steps each
followed by one unconditional rebuild, then the tail. Here it is a Python
loop of eager steps.

Stale lists fail loudly. A rebuild happens at the coordinates of the last
force evaluation made with the old list, so at every rebuild (and at the
end of the chunk) that evaluation is checked exactly. On a cluster-pair
list, ops.blockpairs.unlisted_min_distance gives the closest atom pair the
old list left out, which must lie beyond the cutoff. On a neighbor table
(ops.neighbors.Neighbors), every pair the table built at the same
coordinates holds inside the cutoff must be in the old one
(``missing_min_distance``); at the end of a chunk a table is built for
the check alone. On CUDA tensors that check is the hand-written kernel
csrc/table_check.cu, one launch counted in ``native.LAUNCHES``; on CPU
tensors its plain PyTorch twin, ``missing_min_distance_plain``. There is
no fallback between the two. On cell tiles (ops.celltiles.CellTiles) the
same holds for every pair that tiles built at those coordinates place
inside the cutoff: it must be covered by the old table and its stencil
(``uncovered_min_distance``). A table that overflowed its capacity raises
the JAX package's RuntimeError at the end of the chunk. A box scaled between
rebuilds moves atoms by up to (mu - 1) L / 2, which the skin must absorb;
the same check proves it did.

The virial is computed on the steps whose pressure a coupler reads
(coupling.virial_due), and on those whose end a logger with a
``needs_virial_interval`` records. Under a barostat, ``npt_resetup`` sets
the neighbor finder up again between chunks once the box has drifted
beyond its band.

``simulate`` runs in chunks that end on every logger's interval
(``_chunk_sizes``) and records the loggers between them, one host read
per record.
"""

from __future__ import annotations

import ctypes
import math
import sys as _sys
import time

import torch
from torch.utils.checkpoint import checkpoint

from ..boundary import Orthorhombic, Triclinic, pair_geometry
from ..forces import forces_virial
from ..ops import native
from ..ops.blockpairs import unlisted_min_distance
from ..ops.celltiles import CellTiles, uncovered_min_distance
from ..ops.neighbors import (Neighbors, find_engine, find_neighbors,
                             maybe_rebuild)
from ..ops.pairwise import interaction_cutoff
from ..spatial import remove_cm_motion
from ..tracing import span
from .coupling import virial_due


class StaleNeighborList(RuntimeError):
    """A pair inside the cutoff was missing from the neighbor list."""


class NeighborOverflow(RuntimeError):
    """A neighbor table or cell table could not hold every atom or pair
    (the JAX package's RuntimeError)."""


def list_cutoff(sys):
    """The radius inside which the list must hold every pair: the largest
    interaction cutoff of the pairwise interactions (0 without one)."""
    cuts = [interaction_cutoff(i) for i in sys.pairwise_inters]
    return max([c for c in cuts if c is not None], default=0.0)


def missing_min_distance(old, new, coords, boundary, cutoff):
    """The closest atom pair that the table ``new``, built at ``coords``,
    holds inside ``cutoff`` and the table ``old`` does not, as a device
    scalar (inf when there is none). On CUDA tensors csrc/table_check.cu
    computes it; on CPU tensors ``missing_min_distance_plain``."""
    if coords.is_cuda:
        return _missing_min_distance_cuda(old, new, coords, boundary, cutoff)
    return missing_min_distance_plain(old, new, coords, boundary, cutoff)


def missing_min_distance_plain(old, new, coords, boundary, cutoff):
    """The plain PyTorch twin of the kernel, on any device. Both tables
    place a pair in the same row (the balanced ownership), so a pair is
    looked up by its key row * (N + 1) + column among the old table's
    sorted keys."""
    n = coords.shape[0]
    rows = torch.arange(n, device=coords.device, dtype=torch.int64)[:, None]
    old_keys = torch.sort((rows * (n + 1) + old.idx).reshape(-1))[0]
    new_keys = (rows * (n + 1) + new.idx).reshape(-1)
    pos = torch.clamp(torch.searchsorted(old_keys, new_keys),
                      max=old_keys.numel() - 1)
    listed = (old_keys[pos] == new_keys).view(new.idx.shape)
    safe_j = torch.clamp(new.idx, max=n - 1).to(torch.int64)
    r = torch.sqrt(pair_geometry(coords, boundary, safe_j)[1])
    missing = (new.idx < n) & ~listed & (r < cutoff)
    return torch.where(missing, r, float("inf")).amin()


class _CheckSpec(ctypes.Structure):
    """The launcher's spec, field for field csrc/table_check.cu's
    CheckSpec."""

    _fields_ = [("cutoff", ctypes.c_double)] + [
        (name, ctypes.c_int) for name in ("n_atoms", "k_old", "k_new", "f64",
                                          "triclinic")]


_CHECK_SIG = {"table_check_launch": [ctypes.c_void_p] * 8}

#: the widest old table the kernel takes: a row's hash set of twice its
#: width, rounded up to a power of 2, in one block's shared memory
_CHECK_MAX_OLD = 16384


def _missing_min_distance_cuda(old, new, coords, boundary, cutoff):
    """missing_min_distance on a CUDA card: a scalar filled with inf and
    lowered by one launch of csrc/table_check.cu on the current stream,
    with no host read. The coordinates are taken detached. Raises on what
    the kernel does not take."""
    n = coords.shape[0]
    dev, dtype = coords.device, coords.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the table check takes float32 or float64 "
                        f"coordinates, got {dtype}")
    if coords.dim() != 2 or coords.shape[1] != 3 or not 0 < n < 2 ** 31 - 1:
        raise ValueError(f"the table check takes (N, 3) coordinates with "
                         f"0 < N < 2^31 - 1, got {tuple(coords.shape)}")
    if type(boundary) not in (Orthorhombic, Triclinic):
        raise TypeError(f"the table check takes an Orthorhombic or Triclinic "
                        f"box, got {type(boundary).__name__}")
    box_a, box_b = boundary.mic_tensors(dtype)
    for name, t in (("old", old.idx), ("new", new.idx), ("box", box_a),
                    ("box", box_b)):
        if t.device != dev:
            raise ValueError(f"the table check's {name} tensor is on "
                             f"{t.device}, the coordinates on {dev}")
    for name, t in (("old", old.idx), ("new", new.idx)):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != n:
            raise ValueError(f"the table check takes (N, K) int32 tables of "
                             f"N = {n} rows; the {name} table is "
                             f"{t.dtype} {tuple(t.shape)}")
    if old.idx.shape[1] > _CHECK_MAX_OLD:
        raise ValueError(f"the table check takes old tables up to "
                         f"{_CHECK_MAX_OLD} wide (its hash set of a row "
                         f"fills a block's shared memory), got "
                         f"{old.idx.shape[1]}")
    out = torch.full((), float("inf"), dtype=dtype, device=dev)
    spec = _CheckSpec(cutoff=float(cutoff), n_atoms=n,
                      k_old=int(old.idx.shape[1]),
                      k_new=int(new.idx.shape[1]),
                      f64=int(dtype == torch.float64),
                      triclinic=int(type(boundary) is Triclinic))
    native.launch("table_check", "table_check_launch", _CHECK_SIG, spec,
                  coords.detach().contiguous(), box_a, box_b,
                  old.idx.contiguous(), new.idx.contiguous(), out, device=dev)
    return out


def list_check(sys, neighbors, cutoff, new=None):
    """The stale-list check of a force evaluation on ``neighbors`` at sys's
    coordinates: (a device scalar, the overflow of the table built for the
    check or None). On a cluster-pair list the scalar is the closest
    unlisted atom pair (exact below the cutoff); on a neighbor table it is
    the closest pair inside the cutoff that a table built at these
    coordinates (``new``, or one built here) holds and ``neighbors`` does
    not, on cell tiles the closest such pair the old tiles do not cover
    (inf: none)."""
    if not isinstance(neighbors, (Neighbors, CellTiles)):
        return unlisted_min_distance(neighbors, sys.coords, sys.boundary,
                                     cutoff), None
    if new is None:
        new = sys.neighbor_finder.find(sys.coords, sys.boundary,
                                       sys.exclusions)
    if isinstance(neighbors, CellTiles):
        return uncovered_min_distance(neighbors, new, sys.neighbor_finder,
                                      sys.coords, sys.boundary,
                                      cutoff), new.overflow
    return missing_min_distance(neighbors, new, sys.coords, sys.boundary,
                                cutoff), new.overflow


def raise_if_overflow(overflow, step_n):
    """Raises NeighborOverflow, the JAX package's RuntimeError, if a
    neighbor table overflowed (``overflow`` a device scalar, read here)."""
    over = int(overflow)
    if over > 0:
        raise NeighborOverflow(
            f"neighbor finder overflow at step {step_n}: neighbor list "
            f"overflow by {over}; increase max_neighbors / cell_capacity on "
            "the finder")


def raise_if_stale(closest, cutoff):
    """The closest unlisted atom pair (a device scalar) as a float; raises
    StaleNeighborList if it lies inside the cutoff."""
    closest = float(closest)
    if closest < cutoff:
        raise StaleNeighborList(
            f"an atom pair {closest:.4f} nm apart was missing from the "
            f"neighbor list (cutoff {cutoff} nm): rebuild more often or "
            "widen the skin")
    return closest


def chunk_steps(simulator, sys, neighbors, aux, step0, n, generator=None,
                noise=None, draws=None, virial_at=None):
    """run_chunk's loop as a generator that yields after each step, so
    that a caller can interleave the chunks of several replicas (parallel.
    replicas.run_segments). It reads nothing on the host: its value
    (StopIteration.value) is (sys, neighbors, aux, the closest distance of
    the checked evaluations as a device scalar, the largest table overflow
    as a device scalar or None without a table)."""
    finder = sys.neighbor_finder
    r = finder.n_steps if finder is not None and neighbors is not None else 1
    cutoff = list_cutoff(sys)
    closest = torch.full((), float("inf"), dtype=sys.coords.dtype,
                         device=sys.device)

    couplers = getattr(simulator, "coupling", ())
    if virial_at is None:
        def virial_at(step_n):
            return virial_due(couplers, step_n)
    table = isinstance(neighbors, (Neighbors, CellTiles))
    overflow = neighbors.overflow if table else None

    def steps(sys, aux, first, k):
        for step_n in range(first, first + k):
            injected = {}
            if noise is not None:
                injected["noise"] = noise(step_n)
            if draws is not None:
                injected["draws"] = draws(step_n)
            with span("md.step"):
                sys, aux = simulator.step(
                    sys, neighbors, aux, step_n, generator=generator,
                    needs_virial=virial_at(step_n), **injected)
            yield
        return sys, aux

    def check(sys, new=None):
        """The check of the last evaluation on ``neighbors``; ``new`` the
        table built at its coordinates, if there is one."""
        nonlocal closest, overflow
        with span("neighbors.check"):
            near, over = list_check(sys, neighbors, cutoff, new)
            closest = torch.minimum(closest, near)
            if over is not None:
                overflow = torch.maximum(overflow, over)

    def rebuild(sys, step_n):
        with span("neighbors.find", find_engine(finder, sys.coords)):
            new = find_neighbors(finder, sys.coords, sys.boundary,
                                 sys.exclusions, step_n)
        check(sys, new)
        return new

    if r <= 1:
        for step_n in range(step0, step0 + n):
            sys, aux = yield from steps(sys, aux, step_n, 1)
            if neighbors is not None:
                neighbors = rebuild(sys, step_n + 1)
    else:
        pre = min((-step0) % r, n)
        n_periods = (n - pre) // r
        tail = n - pre - n_periods * r
        if pre:
            sys, aux = yield from steps(sys, aux, step0, pre)
            neighbors = rebuild(sys, step0 + pre)
        for k in range(n_periods):
            first = step0 + pre + k * r
            sys, aux = yield from steps(sys, aux, first, r)
            neighbors = rebuild(sys, first + r)
        if tail:
            sys, aux = yield from steps(sys, aux, step0 + pre + n_periods * r,
                                        tail)
            check(sys)
    return sys, neighbors, aux, closest, overflow


def finish_chunk(sys, out, step_n):
    """Reads a chunk's checks on the host (chunk_steps' value ``out``, its
    last step ``step_n``): raises on an overflowed table and on a stale
    list; returns (sys, neighbors, aux, the closest distance as a
    float)."""
    sys_out, neighbors, aux, closest, overflow = out
    with span("md.finish"):
        if overflow is not None:
            raise_if_overflow(overflow, step_n)
        closest = raise_if_stale(closest, list_cutoff(sys))
    return sys_out, neighbors, aux, closest


def run_chunk(simulator, sys, neighbors, aux, step0, n, generator=None,
              noise=None, draws=None, virial_at=None):
    """Advance n steps from step number step0 (outer steps of an MTS
    integrator, which the rebuild cadence counts). ``noise`` is an optional
    callable step_n -> the step's standard-normal draws that replace the
    generator's: an (N, 3) tensor for Langevin and OverdampedLangevin, a
    sequence of one per O for LangevinSplitting, one per innermost
    substep for MTSLangevinIntegrator; ``draws`` one step_n ->
    per-coupler draws (coupling.py) for the couplers'. ``virial_at`` is an
    optional callable step_n -> whether the step computes the virial
    (coupling.virial_due by default). Returns (sys,
    neighbors, aux, closest distance in nm at the checked evaluations: of
    an unlisted atom pair on a cluster-pair list, of a pair missing
    inside the cutoff (inf: none) on a neighbor table or cell tiles).
    Raises StaleNeighborList, or RuntimeError on a table's overflow."""
    steps = chunk_steps(simulator, sys, neighbors, aux, step0, n,
                        generator=generator, noise=noise, draws=draws,
                        virial_at=virial_at)
    with span("md.chunk", f"step0={step0},n={n}"):
        while True:
            try:
                next(steps)
            except StopIteration as done:
                return finish_chunk(sys, done.value, step0 + n)


def npt_resetup(simulator, sys, neighbors, step_n):
    """Between chunks under a barostat: once the box has drifted beyond the
    neighbor finder's band (box_drift_exceeded of BlockPairFinder and
    CellTileFinder), set the
    finder up for the current box and rebuild the list at step_n
    (mollytpu/sim/simulate.py:243-256). Reads the box on the host, once.
    Returns (sys, neighbors)."""
    finder = sys.neighbor_finder
    if (finder is None or neighbors is None
            or not any(getattr(c, "is_barostat", False)
                       for c in getattr(simulator, "coupling", ()))
            or not hasattr(finder, "box_drift_exceeded")
            or not finder.box_drift_exceeded(sys.boundary)):
        return sys, neighbors
    finder = finder.resetup(sys.boundary, sys.n_atoms, sys.atoms)
    sys = sys.update(neighbor_finder=finder)
    return sys, find_neighbors(finder, sys.coords, sys.boundary,
                               sys.exclusions, step_n)


def _chunk_sizes(n_steps, intervals):
    """Chunk lengths of the gcd of the logger intervals, so that every
    interval's boundary ends a chunk (mollytpu/sim/simulate.py:27-41)."""
    if not intervals:
        return [n_steps] if n_steps else []
    g = 0
    for iv in intervals:
        g = math.gcd(g, iv)
    return [min(g, n_steps - done) for done in range(0, n_steps, g)]


def _host(value):
    """A logged value on the host: tensors moved to the CPU, tuples and
    lists element by element."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, (tuple, list)):
        return type(value)(_host(v) for v in value)
    return value


def _stack(values):
    """One logger's records stacked along a new first axis (a tuple of
    stacks for tuple records); left a list where they do not stack."""
    if not values:
        return values
    if isinstance(values[0], tuple):
        return tuple(_stack(list(v)) for v in zip(*values))
    try:
        return torch.stack([torch.as_tensor(v) for v in values])
    except (TypeError, RuntimeError, ValueError):
        return values


def simulate(sys, simulator, n_steps, generator=None, neighbors=None,
             aux=None, init_step=0, noise=None, draws=None, loggers=None,
             run_loggers=True, check_nans=False, shortcut=None,
             show_progress=False):
    """Run n_steps of MD from step init_step (mollytpu/sim/simulate.py:
    134-266). A fresh run (init_step 0) first removes the centre-of-mass
    motion when the simulator's ``remove_cm`` is set. Without loggers the
    steps run as one chunk, with loggers in chunks of the gcd of their
    intervals, each followed by the barostat's re-setup (npt_resetup).

    loggers: name -> logger (utils.loggers, utils.trajectory); each
    records at init_step and at the end of every chunk whose step is a
    multiple of its interval. run_loggers: True, False (record nothing)
    or "skipstart" (no record at step 0). check_nans raises
    FloatingPointError on NaN coordinates after a chunk; shortcut, a
    callable (sys, neighbors, step_n) -> bool, ends the run at a chunk's
    end when it returns True; show_progress prints the step and ns/day to
    stderr after each chunk.

    Returns (sys, neighbors, aux), so that a later call with init_step
    advanced continues the same trajectory; with ``loggers`` given,
    (sys, neighbors, aux, logs), logs mapping each name to its records
    stacked along a new first axis (on the CPU)."""
    if init_step == 0 and getattr(simulator, "remove_cm", False):
        sys = sys.update(velocities=remove_cm_motion(sys.masses,
                                                     sys.velocities))
    named = dict(loggers or {})
    couplers = getattr(simulator, "coupling", ())
    virial_every = [int(lg.needs_virial_interval) for lg in named.values()
                    if getattr(lg, "needs_virial_interval", 0)]

    def virial_at(step_n):
        # a logger records the state at the end of step step_n
        return virial_due(couplers, step_n) or any(
            (step_n + 1) % iv == 0 for iv in virial_every)

    if neighbors is None:
        neighbors = find_neighbors(sys.neighbor_finder, sys.coords,
                                   sys.boundary, sys.exclusions, init_step)
    if aux is None:
        aux = simulator.init_aux(sys, neighbors,
                                 needs_virial=bool(virial_every))
    elif run_loggers and any(init_step % iv == 0 for iv in virial_every):
        # a continued run's aux holds the virial only where it was due
        aux = {**aux, "virial": forces_virial(sys, neighbors, init_step,
                                              needs_virial=True)[1]}
    logs = {name: [] for name in named}

    def record(step_n):
        if not run_loggers or (step_n == 0 and run_loggers == "skipstart"):
            return
        for name, lg in named.items():
            if step_n % max(int(lg.interval), 1) == 0:
                logs[name].append(_host(lg.observe(sys, neighbors, aux,
                                                   step_n)))

    record(init_step)
    step_n = init_step
    t_prog = time.perf_counter()
    for n in _chunk_sizes(n_steps, [max(int(lg.interval), 1)
                                    for lg in named.values()]):
        sys, neighbors, aux, _ = run_chunk(
            simulator, sys, neighbors, aux, step_n, n, generator=generator,
            noise=noise, draws=draws, virial_at=virial_at)
        step_n += n
        if check_nans and bool(torch.isnan(sys.coords).any()):
            raise FloatingPointError(f"NaN coordinates at step {step_n}")
        sys, neighbors = npt_resetup(simulator, sys, neighbors, step_n)
        if show_progress:
            now = time.perf_counter()
            dt_ps = getattr(simulator, "dt", 0.0)
            rate = n * dt_ps * 1e-3 * 86400.0 / max(now - t_prog, 1e-9)
            t_prog = now
            print(f"\rstep {step_n - init_step}/{n_steps}"
                  + (f"  {rate:.1f} ns/day" if dt_ps else ""), end="",
                  file=_sys.stderr, flush=True)
        record(step_n)
        if shortcut is not None and shortcut(sys, neighbors, step_n):
            break
    if show_progress:
        print(file=_sys.stderr, flush=True)
    if loggers is None:
        return sys, neighbors, aux
    return sys, neighbors, aux, {k: _stack(v) for k, v in logs.items()}


def simulate_differentiable(sys, simulator, n_steps, generator=None,
                            neighbors=None, remat=True, noise=None):
    """n_steps of MD that autograd differentiates (counterpart of
    mollytpu/sim/simulate.py:278-311): one loop with no host reads and no
    stale-list check, each step wrapped in ``torch.utils.checkpoint`` when
    ``remat`` (activations recomputed in the backward pass, so memory
    grows with one step, not the trajectory). Returns the final System.

    The state is functional: no step writes in place into a tensor that
    carries the graph. The autograd force engines keep their graph when
    their inputs track grad (config.tracks_grad); the hand-written bonded
    and PME forces are differentiated through. The pair kernel has no
    backward and raises (ops.pair_kernel.refuse_grad): use the dense or
    neighbor-table engine. The list is rebuilt on the finder's cadence
    from detached coordinates (its indices carry no gradient). A
    stochastic step draws from a generator cloned from ``generator`` (one
    seeded 0 when None) at the step's start, so the recomputation draws
    the same numbers; ``generator`` ends advanced past the run's draws.
    ``noise`` is an optional step_n -> that step's normals.

    Differentiate e.g. with
        torch.autograd.grad(observable(simulate_differentiable(s, sim, n)),
                            parameter)
    """
    if neighbors is None:
        neighbors = find_neighbors(sys.neighbor_finder, sys.coords.detach(),
                                   sys.boundary, sys.exclusions, 0)
    aux = simulator.init_aux(sys, neighbors, needs_virial=False)

    def step(sys, aux, neighbors, step_n, state):
        gen = torch.Generator(device=sys.device)
        gen.set_state(state)
        injected = {} if noise is None else {"noise": noise(step_n)}
        sys, aux = simulator.step(sys, neighbors, aux, step_n, generator=gen,
                                  needs_virial=False, **injected)
        return sys, aux, gen.get_state()

    if generator is None:
        generator = torch.Generator(device=sys.device).manual_seed(0)
    state = generator.get_state()
    for i in range(n_steps):
        if remat:
            sys, aux, state = checkpoint(step, sys, aux, neighbors, i, state,
                                         use_reentrant=False)
        else:
            sys, aux, state = step(sys, aux, neighbors, i, state)
        neighbors = maybe_rebuild(sys.neighbor_finder, neighbors,
                                  sys.coords.detach(), sys.boundary,
                                  sys.exclusions, i + 1)
    generator.set_state(state)
    return sys
