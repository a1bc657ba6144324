"""The program's spans (mollytpu_torch.tracing) in a device trace: the
per-layer metrics read inside the MD loop.

``span_trace(run)`` runs the protocol's ``more_chunks`` once more under
torch.profiler (CPU and CUDA activity) with the spans recording, and
reduces the exported trace on the profiler's one clock:

- each device event (timing.DEVICE_CATS) belongs to the innermost span
  open on the launching thread when it was launched: the runtime or
  driver call with the same ``args["correlation"]``;
- a span's device time is the union of the intervals of its own and its
  descendants' events, its self time that of its own events alone;
- each blocking call (SYNCS) is counted by the innermost span open on its
  thread;
- each idle gap between merged device intervals goes to the innermost span
  and host operation open at the gap's midpoint.

It prints a table of the spans to stderr. A program without spans (no
``mollytpu_torch.tracing``) gives None, and each reader then None.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import sys
import time

from timing import DEVICE_CATS, LAUNCHES, _host_at, _merge

#: the runtime calls that block the host until the device catches up
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10


def _union_us(intervals):
    return sum(e - s for s, e in _merge(intervals))


class _Spans:
    """The spans of one thread, each with its parent, sorted by start
    (an enclosing span before the spans it holds)."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]
        self.parent, stack = [], []
        for k, (s, e, _) in enumerate(self.spans):
            while stack and not (self.spans[stack[-1]][0] <= s
                                 and e <= self.spans[stack[-1]][1]):
                stack.pop()
            self.parent.append(stack[-1] if stack else None)
            stack.append(k)

    def at(self, t):
        """The innermost span open at t (an index), or None: spans nest, so
        it is the last one started by t or one of its ancestors."""
        k = bisect.bisect_right(self.starts, t) - 1
        while k is not None and k >= 0:
            s, e, _ = self.spans[k]
            if s <= t <= e:
                return k
            k = self.parent[k]
        return None

    def chain(self, k):
        """The names of span k and of every span enclosing it."""
        names = set()
        while k is not None:
            names.add(self.spans[k][2])
            k = self.parent[k]
        return frozenset(names)


@dataclasses.dataclass
class SpanReduction:
    count: dict        # span name -> spans in the trace
    host_us: dict      # span name -> summed host duration
    device: list       # (start, end, names of the enclosing spans)
    launches: list     # names of the spans enclosing each launch call
    syncs: list        # names of the spans enclosing each blocking call
    self_us: dict      # span name -> union of its own events alone
    idle: dict         # "span / host op" -> idle us at the gaps
    busy_us: float

    def device_us(self, under, outside=None):
        """Union of the device intervals launched inside a span named
        ``under`` and inside none named ``outside``."""
        return _union_us([(s, e) for s, e, names in self.device
                          if under in names
                          and (outside is None or outside not in names)])

    def calls_in(self, calls, name):
        return sum(1 for names in calls if name in names)


def reduce_spans(events, names):
    """A SpanReduction of a Kineto trace's events over the spans ``names``
    (user annotations)."""
    threads = {}
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name") in names):
            threads.setdefault(e.get("tid"), []).append(
                (e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]))
    threads = {k: _Spans(v) for k, v in threads.items()}
    # where the runtime's thread ids are not the annotations', the one
    # thread that holds spans launched everything
    only = next(iter(threads.values())) if len(threads) == 1 else None
    count, host_us = {}, {}
    for sp in threads.values():
        for s, e, name in sp.spans:
            count[name] = count.get(name, 0) + 1
            host_us[name] = host_us.get(name, 0.0) + (e - s)

    def enclosing(e):
        """(names of the spans enclosing event e, its innermost span's)."""
        sp = threads.get(e.get("tid"), only)
        k = sp.at(e["ts"]) if sp is not None else None
        if k is None:
            return frozenset(), None
        return sp.chain(k), sp.spans[k][2]

    launch_of, launches, syncs = {}, [], []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in RUNTIME_CATS:
            continue
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            launch_of[corr] = e
        if e.get("name") in LAUNCHES:
            launches.append(enclosing(e)[0])
        if e.get("name") in SYNCS:
            syncs.append(enclosing(e)[0])
    device, own = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        iv = (e["ts"], e["ts"] + e.get("dur", 0.0))
        launch = launch_of.get((e.get("args") or {}).get("correlation"))
        chain, inner = (frozenset(), None) if launch is None \
            else enclosing(launch)
        device.append((*iv, chain))
        own.setdefault(inner, []).append(iv)
    self_us = {k: _union_us(v) for k, v in own.items() if k is not None}
    merged = _merge([(s, e) for s, e, _ in device])

    ops = sorted((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"])
                 for e in events if e.get("ph") == "X"
                 and e.get("cat") == "cpu_op")
    starts = [o[0] for o in ops]
    idle = {}
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        inner = [(sp.spans[k][0], sp.spans[k][2]) for sp in threads.values()
                 for k in [sp.at(mid)] if k is not None]
        where = max(inner)[1] if inner else "outside any span"
        key = f"{where} / {_host_at(ops, starts, mid)}"
        idle[key] = idle.get(key, 0.0) + (s1 - e0)
    return SpanReduction(count=count, host_us=host_us, device=device,
                         launches=launches, syncs=syncs, self_us=self_us,
                         idle=idle,
                         busy_us=sum(e - s for s, e in merged))


def table(red, names, log=None):
    """The per-span table, the top idle gaps and the root's coverage (to
    stderr)."""
    log = log or sys.stderr
    steps = red.count.get("md.step", 0)
    busy = red.busy_us * 1e-3
    print(f"spans: {steps} steps, device busy {busy:.3f} ms"
          + (f" ({busy / steps:.4f} ms/step)" if steps else ""), file=log)
    print(f"{'span':<16}{'count':>7}{'device ms':>12}{'self ms':>10}"
          f"{'launches':>10}{'syncs':>8}{'host ms':>10}   (per call)",
          file=log)
    for name in names:
        n = red.count.get(name, 0)
        if not n:
            continue
        print(f"{name:<16}{n:>7}{red.device_us(name) * 1e-3 / n:>12.4f}"
              f"{red.self_us.get(name, 0.0) * 1e-3 / n:>10.4f}"
              f"{red.calls_in(red.launches, name) / n:>10.2f}"
              f"{red.calls_in(red.syncs, name) / n:>8.2f}"
              f"{red.host_us[name] * 1e-3 / n:>10.4f}", file=log)
    print("idle gaps by span / host op (ms): " + "; ".join(
        f"{k} {v * 1e-3:.3f}" for k, v in sorted(
            red.idle.items(), key=lambda kv: -kv[1])[:TOP]), file=log)
    root = red.self_us.get("md.chunk", 0.0)
    share = 100.0 * root / red.busy_us if red.busy_us else 0.0
    print(f"launched in md.chunk outside its child spans: {root * 1e-3:.4f} "
          f"ms, {share:.4f}% of the device busy time", file=log, flush=True)


def _profile_events(fn, work_dir):
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = os.path.join(work_dir, "spans.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as fh:
            return json.load(fh)["traceEvents"]
    finally:
        os.remove(path)


def _trace(run):
    try:
        from mollytpu_torch import tracing
    except ImportError:   # a program that has no spans
        return None
    t0 = time.perf_counter()
    with tracing.recording():
        events = _profile_events(lambda: run.protocol.more_chunks(run),
                                 run.work)
    red = reduce_spans(events, tracing.SPANS)
    print(f"span pass: {time.perf_counter() - t0:.2f} s", file=sys.stderr)
    table(red, tracing.SPANS)
    return red


def span_trace(run):
    run.on_card()
    return run.once("spans", lambda: _trace(run))


def per_call_ms(run, name):
    red = span_trace(run)
    if red is None or not red.count.get(name):
        return None
    return red.device_us(name) * 1e-3 / red.count[name]


def per_step(run, fn):
    """fn(reduction) / the steps traced, None without spans or steps."""
    red = span_trace(run)
    if red is None or not red.count.get("md.step"):
        return None
    value = fn(red)
    return None if value is None else value / red.count["md.step"]


def find_ms(run):
    return per_call_ms(run, "neighbors.find")


def stale_check_ms(run):
    return per_call_ms(run, "neighbors.check")


def pairs_ms(run):
    return per_step(run, lambda r: r.device_us("forces.pairs") * 1e-3
                    if r.count.get("forces.pairs") else None)


def integrate_self_ms(run):
    return per_step(run, lambda r: r.device_us("md.step", "forces") * 1e-3)


def host_syncs_per_step(run):
    return per_step(run, lambda r: float(r.calls_in(r.syncs, "md.chunk")))
