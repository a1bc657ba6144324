"""Tiny versions of the benchmark's cells for CPU tests: the same
configurations, traffic and limits, at a size the CPU runs in seconds."""

import io
import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import harness  # noqa: E402

CELLS = ("lj-bench-2048000.nve",)
SEED = 2 ** 31 + 11


def tiny_spec(cell, root=harness.BENCH, bench=None):
    """The cell's spec with 6^3 fcc cells (864 atoms) and a 20-step
    warm-up."""
    spec = harness.cell_spec(bench or harness.load_benchmark(), cell, root)
    cfg = spec["config"]
    cfg["lj"]["n_cells"] = 6
    cfg["n_atoms"] = 864
    spec["traffic"]["warmup_steps"] = 20
    return spec


def run_tiny(cell, trace=False, control=False, seed=SEED, seconds=0.5):
    return harness.run_cell(tiny_spec(cell), seed, seconds, trace, "cpu",
                            time.perf_counter(), control=control,
                            log=io.StringIO())
