"""Timing: the host's clock around many calls of one layer, and
torch.profiler's trace of a stretch of work reduced to busy time,
launches, the heaviest device operations and the host's share of the idle
gaps.

``profile`` extends ``chip_smoke.components``' profiler summary (device
rows, kernel-launch calls) from ``key_averages`` to the exported trace,
so that the device's busy time is the union of its intervals."""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import time

#: the runtime calls that launch a kernel (chip_smoke.components)
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
            "cuLaunchKernelEx")
#: trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def host_ms(fn, warmup=2, min_reps=20, min_s=0.5):
    """Mean ms of fn() by the host's clock, synchronised at both ends of
    at least ``min_reps`` calls that together last ``min_s`` or more, after
    ``warmup`` calls: the whole cost of the call to the loop that makes
    it, its host work and waits included."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, n = time.perf_counter(), 0
    while True:
        fn()
        n += 1
        if n >= min_reps:
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            if elapsed >= min_s:
                return 1e3 * elapsed / n


@dataclasses.dataclass
class Trace:
    busy_s: float
    window_s: float
    launches: int
    steps: int
    device_ops: list
    idle_gaps: list


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_at(ops, starts, t):
    """The innermost host operation running at time t (latest start)."""
    k = bisect.bisect_right(starts, t)
    for j in range(k - 1, max(-1, k - 400), -1):
        s, e, name = ops[j]
        if e >= t:
            return name
    return "host, outside any traced operation"


def reduce_trace(events, window_s, steps):
    """A Trace from the exported trace's events."""
    dev = [(e["ts"], e["ts"] + e.get("dur", 0.0), e["name"])
           for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    if not dev:
        raise RuntimeError("the profiler's trace holds no device activity")
    merged = _merge([(s, e) for s, e, _ in dev])
    busy_us = sum(e - s for s, e in merged)
    per_op = {}
    for s, e, name in dev:
        per_op[name] = per_op.get(name, 0.0) + (e - s)
    launches = sum(1 for e in events if e.get("ph") == "X"
                   and e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and e.get("name") in LAUNCHES)
    ops = sorted((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"])
                 for e in events if e.get("ph") == "X"
                 and e.get("cat") == "cpu_op")
    starts = [o[0] for o in ops]
    idle = {}
    for (s0, e0), (s1, _) in zip(merged, merged[1:]):
        name = _host_at(ops, starts, 0.5 * (e0 + s1))
        idle[name] = idle.get(name, 0.0) + (s1 - e0)
    top = lambda d: [[k[:120], v * 1e-6] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:TOP]]
    return Trace(busy_s=busy_us * 1e-6, window_s=window_s, launches=launches,
                 steps=steps, device_ops=top(per_op), idle_gaps=top(idle))


def profile(fn, work_dir, steps):
    """Trace of fn() under torch.profiler (CPU and CUDA activity);
    ``window_s`` is the host clock around fn() and the final
    synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    path = os.path.join(work_dir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    return reduce_trace(events, window, steps)
