"""Spans at the layer boundaries of the MD loop and the force dispatch, for
torch.profiler to record.

Spans are off by default: ``span`` then returns one shared no-op context,
so a span costs a global read (``record_function`` costs ~13 us a span on
a CPU even with no profiler running). ``recording()`` turns them on:

    with tracing.recording(), torch.profiler.profile(...) as prof:
        run_chunk(...)

No span stays open across a ``yield`` of ``sim.simulate.chunk_steps``,
whose chunks ``parallel.replicas.run_segments`` interleaves.
"""

from __future__ import annotations

import contextlib

from torch.profiler import record_function

#: every span name, root first
SPANS = ("md.chunk", "md.step", "neighbors.find", "neighbors.check",
         "md.finish", "forces", "forces.pairs", "forces.bonded",
         "forces.general", "md.constraints", "forces.pme", "pme.spread",
         "pme.solve", "pme.gather", "forces.excl", "md.couple",
         "fep.cross")

_OFF = contextlib.nullcontext()
_on = False


def span(name, args=None):
    """``record_function(name, args)`` while recording, else a no-op
    context. ``args`` is a string (the engine, the interaction's class)."""
    if not _on:
        return _OFF
    return record_function(name, args)


@contextlib.contextmanager
def recording():
    """Spans on inside the block, in every thread; the previous state back
    on exit."""
    global _on
    before, _on = _on, True
    try:
        yield
    finally:
        _on = before
