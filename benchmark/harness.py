"""The benchmark's harness: finds a cell's files by name, runs the cell's
protocol, reads its metrics and checks, and assembles the result line.

Everything that belongs to one configuration, traffic mix or metric lives
in a file of its own, found by the name BENCHMARK.json gives it:

    configs/<config>.json     the system as it is run (BENCHMARK.json's
                              ``file``), with ``builder`` naming
    systems/<builder>.py      how the program builds it and which plain
                              reference (reference/) stands beside it
    traffic/<traffic>.json    the protocol's parameters, with ``protocol``
                              naming
    protocols/<protocol>.py   the generator that drives the program
    workloads/<cell>.json     the limits of the cell's checks
    metrics/<metric>.py       one reader per metric: read(run) -> a number,
                              or None where it finds nothing to read

so that a later cell, configuration, traffic mix or metric is new files
and new BENCHMARK.json entries, with no file here edited.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import tempfile

BENCH = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH)

#: top-level modules that no process of the benchmark may hold: JAX, its
#: libraries, the JAX package and the scripts that drive it
FORBIDDEN = ("jax", "jaxlib", "flax", "mollytpu", "chip_smoke", "k1_bench")


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole: mollytpu_torch is not mollytpu."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def load_json(kind, name, root=BENCH):
    with open(os.path.join(root, kind, name + ".json")) as fh:
        return json.load(fh)


def load_module(kind, name, root=BENCH):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(root, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    if root not in sys.path:
        sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_benchmark(path=None):
    with open(path or os.path.join(REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _applies(metric, cell, per_layer):
    """An end-to-end metric without ``workloads`` is every cell's; a
    per-layer metric has to list its cells."""
    listed = metric.get("workloads")
    if listed is None and per_layer:
        raise ValueError(f"per-layer metric {metric['name']!r} lists no "
                         "workloads")
    return listed is None or cell in listed


def cell_spec(bench, cell, root=BENCH):
    """What a run of ``cell`` needs: its BENCHMARK.json entry, its
    configuration, traffic and limits, and the end-to-end and per-layer
    metrics it reports."""
    found = [w for w in bench["workloads"] if w["name"] == cell]
    if not found:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    work = found[0]
    conf = [c for c in bench["configs"] if c["name"] == work["config"]][0]
    with open(os.path.join(os.path.dirname(root), conf["file"])) as fh:
        cfg = json.load(fh)
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell, False)]
    layer = [m for m in bench["per_layer"] if _applies(m, cell, True)]
    return {"cell": work, "config": cfg,
            "traffic": load_json("traffic", work["traffic"], root),
            "limits": load_json("workloads", cell, root)["limits"],
            "end_to_end": e2e, "per_layer": layer, "root": root}


class Run:
    """One run of a cell: its inputs, what the protocol leaves behind for
    the metrics (``window``, ``end``) and for the checks, and the device
    measurements, each taken once on first use."""

    def __init__(self, spec, seed, seconds, device, t_start, work,
                 control=False):
        self.spec, self.seed, self.seconds = spec, seed, seconds
        self.device, self.t_start, self.work = device, t_start, work
        self.control = control
        self.cfg, self.traffic = spec["config"], spec["traffic"]
        self.builder = load_module("systems", self.cfg["builder"],
                                   spec["root"])
        self.protocol = load_module("protocols", self.traffic["protocol"],
                                    spec["root"])
        self.window, self.end, self.check_inputs = {}, {}, {}
        self._cache = {}

    def on_card(self):
        if str(self.device).split(":")[0] != "cuda":
            raise RuntimeError("a device metric needs the CUDA card; this "
                               f"run is on {self.device}")

    def once(self, key, fn):
        if key not in self._cache:
            self._cache[key] = fn()
        return self._cache[key]

    def trace(self):
        """The profiler's reading of ``trace_chunks`` more chunks of the
        window's own loop from its end state."""
        import timing
        self.on_card()
        return self.once("trace", lambda: timing.profile(
            lambda: self.protocol.more_chunks(self), self.work,
            steps=self.protocol.steps_of_more_chunks(self)))

    def host_ms(self, key, fn):
        import timing
        self.on_card()
        return self.once(("host_ms", key), lambda: timing.host_ms(fn))

    def device_s_per_call(self, key, fn, reps=20):
        import timing
        self.on_card()
        return self.once(("device_s", key), lambda: timing.profile(
            lambda: [fn() for _ in range(reps)], self.work, steps=reps
        ).busy_s / reps)


def read_metrics(run, entries):
    """name -> {"value", "unit"} of each metric whose reader finds
    something to read."""
    out = {}
    for m in entries:
        value = load_module("metrics", m["name"], run.spec["root"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(spec, seed, seconds, trace, device, t_start, control=False,
             log=sys.stderr):
    """Run the cell; returns the result line's object (checks last). The
    program is the package at the root of the checkout."""
    if REPO not in sys.path:
        sys.path.append(REPO)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = str(device).split(":")[0] == "cuda"
    with tempfile.TemporaryDirectory(prefix="bench-") as work:
        run = Run(spec, seed, seconds, device, t_start, work, control)
        run.protocol.run(run)
        if on_card:
            torch.cuda.synchronize()
        metrics = read_metrics(run, spec["per_layer"] if trace
                               else spec["end_to_end"])
        dev = {"platform": "gpu" if on_card else "cpu",
               "kind": (torch.cuda.get_device_name(0) if on_card
                        else "cpu"),
               "count": int(spec["cell"]["chips"]),
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated()
                                        if on_card else 0)}
        result = {"correct": None, "attempted": run.window["chunks"],
                  "failed": 0, "metrics": metrics, "device": dev}
        if trace:
            tr = run.trace()
            dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
            result["breakdown"] = {"device_ops": tr.device_ops,
                                   "idle_gaps": tr.idle_gaps}
        checks = run.protocol.check(run)
    limits = spec["limits"]
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in checks.items()}
    result["correct"] = all(v <= limits[k] for k, v in checks.items()) \
        and set(checks) == set(limits)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']:.6e} (limit {c['limit']:.6e})",
              file=log, flush=True)
    return result
