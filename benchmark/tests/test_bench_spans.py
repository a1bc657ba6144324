"""The span reducer (spans.py) on a Kineto-shaped trace made by hand, on a
real CPU trace of the tiny LJ cell's loop, and the readers of the span
metrics on runs without spans."""

import io
import json

import pytest

import harness
import spans

METRICS = ("find_ms.lj", "stale_check_ms.lj", "pairs_ms.lj",
           "integrate_self_ms.lj", "host_syncs_per_step.lj",
           "host_step_ms.lj256k")
#: the span readers of the LJ cell, each with a twin for the 256,000-atom
#: cell (``.lj256k``)
TWINS = ("find_ms", "stale_check_ms", "pairs_ms", "integrate_self_ms",
         "host_syncs_per_step")
HOST, OTHER = 7, 99


def _x(cat, name, ts, dur, tid=HOST, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _span(name, ts, end):
    return _x("user_annotation", name, ts, end - ts)


def _launch(corr, ts, tid=HOST, name="cudaLaunchKernel"):
    return _x("cuda_runtime", name, ts, 1, tid=tid, correlation=corr)


def _dev(corr, ts, end, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"k{corr}", "pid": 0, "tid": 3,
            "ts": ts, "dur": end - ts, "args": {"correlation": corr}}


def _trace():
    """One chunk (us): a step with forces and pairs, a rebuild with two
    overlapping kernels and a sync, the check's copy, a second empty
    step, a kernel launched in the chunk outside its children, the
    finish's copy and two syncs, a kernel with no launch event and one
    launched outside every span."""
    return [
        _span("md.chunk", 0, 200), _span("md.step", 0, 60),
        _span("forces", 10, 50), _span("forces.pairs", 20, 40),
        _span("neighbors.find", 60, 100), _span("neighbors.check", 100, 140),
        _span("md.step", 144, 150), _span("md.finish", 150, 200),
        _x("cpu_op", "aten::copy_", 80, 15),
        _x("cpu_op", "aten::_local_scalar_dense", 160, 39),
        _launch(1, 5), _dev(1, 5, 20),
        # launched from a thread id other than the annotations'
        _launch(2, 21, tid=OTHER), _dev(2, 20, 40),
        _launch(3, 45), _dev(3, 40, 45),
        _launch(4, 61), _dev(4, 45, 70),
        _launch(5, 62), _dev(5, 50, 75),
        _x("cuda_runtime", "cudaStreamSynchronize", 90, 5),
        _launch(6, 105, name="cudaMemcpyAsync"),
        _dev(6, 100, 110, cat="gpu_memcpy"),
        _launch(7, 142), _dev(7, 110, 112),
        _launch(8, 165, name="cudaMemcpyAsync"),
        _dev(8, 170, 171, cat="gpu_memcpy"),
        _x("cuda_runtime", "cudaStreamSynchronize", 166, 2),
        _x("cuda_runtime", "cudaStreamSynchronize", 185, 2),
        _dev(50, 171, 172),
        _launch(9, 210), _dev(9, 220, 230),
        _x("cuda_runtime", "cudaDeviceSynchronize", 205, 20),
    ]


def _reduce(events=None):
    names = ("md.chunk", "md.step", "neighbors.find", "neighbors.check",
             "md.finish", "forces", "forces.pairs")
    return spans.reduce_spans(_trace() if events is None else events, names)


def test_device_events_go_to_the_innermost_span_of_their_launch():
    red = _reduce()
    assert red.count == {"md.chunk": 1, "md.step": 2, "forces": 1,
                         "forces.pairs": 1, "neighbors.find": 1,
                         "neighbors.check": 1, "md.finish": 1}
    assert red.self_us == {"md.step": 15, "forces.pairs": 20, "forces": 5,
                           "neighbors.find": 30, "neighbors.check": 10,
                           "md.chunk": 2, "md.finish": 1}
    assert red.calls_in(red.launches, "md.chunk") == 6
    assert len(red.launches) == 7


def test_a_span_holds_the_union_of_its_subtree():
    red = _reduce()
    assert red.busy_us == 70 + 12 + 2 + 10
    assert red.device_us("md.chunk") == 70 + 12 + 1
    assert red.device_us("md.step") == 40
    assert red.device_us("forces") == 25
    assert red.device_us("md.step", "forces") == 15
    # two overlapping kernels: 30 us of union, not 50 of sum
    assert red.device_us("neighbors.find") == 30


def test_syncs_are_counted_by_span():
    red = _reduce()
    assert red.calls_in(red.syncs, "neighbors.find") == 1
    assert red.calls_in(red.syncs, "md.finish") == 2
    assert red.calls_in(red.syncs, "md.chunk") == 3
    assert len(red.syncs) == 4


def test_idle_gaps_go_to_the_span_and_op_at_their_midpoint():
    assert _reduce().idle == {
        "neighbors.find / aten::copy_": 25,
        "md.chunk / host, outside any traced operation": 58,
        "md.finish / aten::_local_scalar_dense": 48}


def test_the_table_reports_the_root_coverage():
    log = io.StringIO()
    red = _reduce()
    spans.table(red, ("md.chunk", "md.step", "forces.bonded"), log=log)
    out = log.getvalue()
    assert "md.step" in out and "forces.bonded" not in out
    share = 100.0 * 2 / 94
    assert f"0.0020 ms, {share:.4f}% of the device busy time" in out


class FakeRun:
    """A run whose span pass is given."""

    def __init__(self, reduction):
        self.reduction = reduction

    def on_card(self):
        pass

    def once(self, key, fn):
        assert key == "spans"
        return self.reduction


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def test_the_readers_read_the_reduction():
    run = FakeRun(_reduce())
    assert _read("find_ms.lj", run) == pytest.approx(0.030)
    assert _read("stale_check_ms.lj", run) == pytest.approx(0.010)
    assert _read("pairs_ms.lj", run) == pytest.approx(0.020 / 2)
    assert _read("integrate_self_ms.lj", run) == pytest.approx(0.015 / 2)
    assert _read("host_syncs_per_step.lj", run) == pytest.approx(3 / 2)


@pytest.mark.parametrize("name", TWINS)
def test_a_256000_atom_cell_reader_reads_as_the_lj_cells(name):
    run = FakeRun(_reduce())
    assert _read(name + ".lj256k", run) == _read(name + ".lj", run)
    assert _read(name + ".lj256k", FakeRun(None)) is None


def test_host_step_ms_is_the_host_time_of_a_step():
    # the two md.step spans last 60 and 6 us on the host
    run = FakeRun(_reduce())
    assert _read("host_step_ms.lj256k", run) == pytest.approx(0.066 / 2)


@pytest.mark.parametrize("name", METRICS)
@pytest.mark.parametrize("reduction", ["no program spans", "no span"])
def test_a_reader_gives_none_without_spans(name, reduction):
    red = None if reduction == "no program spans" else _reduce(
        [e for e in _trace() if e["cat"] != "user_annotation"])
    assert _read(name, FakeRun(red)) is None


def test_a_real_cpu_trace_of_the_loop_reduces(tmp_path):
    """The CPU profiler's export of the tiny cell's chunk: the spans are
    found by name and thread (no device events on the CPU)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import mollytpu_torch as pt
    from mollytpu_torch import tracing
    from mollytpu_torch.models import ljbench
    sys = ljbench.lj_bench_system(6, torch.float32, torch.device("cpu"),
                                  seed=3, n_steps=5)
    sim = pt.VelocityVerlet(dt=ljbench.DT, remove_cm=False)
    nb = pt.find_neighbors(sys.neighbor_finder, sys.coords, sys.boundary,
                           sys.exclusions, 0)
    aux = sim.init_aux(sys, nb)
    with tracing.recording(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        pt.run_chunk(sim, sys, nb, aux, 0, 10)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    red = spans.reduce_spans(json.load(open(path))["traceEvents"],
                             tracing.SPANS)
    assert red.count == {"md.chunk": 1, "md.step": 10, "forces": 10,
                         "forces.pairs": 10, "neighbors.find": 2,
                         "neighbors.check": 2, "md.finish": 1}
    assert red.busy_us == 0 and red.syncs == []
