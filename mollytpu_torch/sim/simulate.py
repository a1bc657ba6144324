"""The simulation loop (counterpart of mollytpu/sim/simulate.py:43-256).

A chunk of n steps runs as the JAX package schedules its scan: steps up to
the next rebuild boundary, then periods of r = finder.n_steps steps each
followed by one unconditional rebuild, then the tail. Here it is a Python
loop of eager steps.

Stale lists fail loudly. A rebuild happens at the coordinates of the last
force evaluation made with the old list, so at every rebuild (and at the
end of the chunk) ops.blockpairs.unlisted_min_distance checks that
evaluation exactly: the closest atom pair the old list left out must lie
beyond the cutoff. The run raises at the end of the chunk otherwise. A
box scaled between rebuilds moves atoms by up to (mu - 1) L / 2, which the
skin must absorb; the same check proves it did.

The virial is computed on the steps whose pressure a coupler reads
(coupling.virial_due). Under a barostat, ``npt_resetup`` sets the neighbor
finder up again between chunks once the box has drifted beyond its band.
"""

from __future__ import annotations

import torch

from ..ops.blockpairs import unlisted_min_distance
from ..ops.neighbors import find_neighbors
from ..ops.pair_kernel import build_fused_spec
from .coupling import virial_due


class StaleNeighborList(RuntimeError):
    """A pair inside the cutoff was missing from the neighbor list."""


def list_cutoff(sys):
    """The radius inside which the list must hold every pair (0 without
    pairwise interactions)."""
    return (build_fused_spec(sys.pairwise_inters).cut_max
            if sys.pairwise_inters else 0.0)


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


def run_chunk(simulator, sys, neighbors, aux, step0, n, generator=None,
              noise=None, draws=None):
    """Advance n steps from step number step0 (outer steps of an MTS
    integrator, which the rebuild cadence counts). ``noise`` is an optional
    callable step_n -> the step's standard-normal draws that replace the
    generator's: an (N, 3) tensor for Langevin, a sequence of one per
    innermost substep for MTSLangevinIntegrator; ``draws`` one step_n ->
    per-coupler draws (coupling.py) for the couplers'. Returns (sys, neighbors, aux, closest
    distance of an unlisted atom pair at the checked evaluations, in
    nm)."""
    finder = sys.neighbor_finder
    r = finder.n_steps if finder is not None and neighbors is not None else 1
    cutoff = list_cutoff(sys)
    closest = torch.full((), float("inf"), dtype=sys.coords.dtype,
                         device=sys.device)

    couplers = getattr(simulator, "coupling", ())

    def steps(sys, aux, first, k):
        for step_n in range(first, first + k):
            injected = {}
            if noise is not None:
                injected["noise"] = noise(step_n)
            if draws is not None:
                injected["draws"] = draws(step_n)
            sys, aux = simulator.step(
                sys, neighbors, aux, step_n, generator=generator,
                needs_virial=virial_due(couplers, step_n), **injected)
        return sys, aux

    def check(sys):
        nonlocal closest
        closest = torch.minimum(closest, unlisted_min_distance(
            neighbors, sys.coords, sys.boundary, cutoff))

    def rebuild(sys, step_n):
        check(sys)
        return find_neighbors(finder, sys.coords, sys.boundary,
                              sys.exclusions, step_n)

    if r <= 1:
        for step_n in range(step0, step0 + n):
            sys, aux = steps(sys, aux, step_n, 1)
            if neighbors is not None:
                neighbors = rebuild(sys, step_n + 1)
    else:
        pre = min((-step0) % r, n)
        n_periods = (n - pre) // r
        tail = n - pre - n_periods * r
        if pre:
            sys, aux = steps(sys, aux, step0, pre)
            neighbors = rebuild(sys, step0 + pre)
        for k in range(n_periods):
            first = step0 + pre + k * r
            sys, aux = steps(sys, aux, first, r)
            neighbors = rebuild(sys, first + r)
        if tail:
            sys, aux = steps(sys, aux, step0 + pre + n_periods * r, tail)
            check(sys)
    return sys, neighbors, aux, raise_if_stale(closest, cutoff)


def npt_resetup(simulator, sys, neighbors, step_n):
    """Between chunks under a barostat: once the box has drifted beyond the
    neighbor finder's band (BlockPairFinder.box_drift_exceeded), set the
    finder up for the current box and rebuild the list at step_n
    (mollytpu/sim/simulate.py:243-256). Reads the box on the host, once.
    Returns (sys, neighbors)."""
    finder = sys.neighbor_finder
    if (finder is None or neighbors is None
            or not any(getattr(c, "is_barostat", False)
                       for c in getattr(simulator, "coupling", ()))
            or not finder.box_drift_exceeded(sys.boundary)):
        return sys, neighbors
    finder = finder.resetup(sys.boundary, sys.n_atoms, sys.atoms)
    sys = sys.update(neighbor_finder=finder)
    return sys, find_neighbors(finder, sys.coords, sys.boundary,
                               sys.exclusions, step_n)


def simulate(sys, simulator, n_steps, generator=None, neighbors=None,
             aux=None, init_step=0, noise=None, draws=None):
    """Run n_steps of MD as one chunk, then the barostat's re-setup
    (npt_resetup). Returns (sys, neighbors, aux) so that a later call with
    init_step advanced continues the same trajectory."""
    if neighbors is None:
        neighbors = find_neighbors(sys.neighbor_finder, sys.coords,
                                   sys.boundary, sys.exclusions, init_step)
    if aux is None:
        aux = simulator.init_aux(sys, neighbors)
    sys, neighbors, aux, _ = run_chunk(simulator, sys, neighbors, aux,
                                       init_step, n_steps,
                                       generator=generator, noise=noise,
                                       draws=draws)
    sys, neighbors = npt_resetup(simulator, sys, neighbors,
                                 init_step + n_steps)
    return sys, neighbors, aux
