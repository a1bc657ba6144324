"""The port's spans (mollytpu_torch.tracing): which spans a chunk of MD
emits under torch.profiler and how they nest, none with recording off,
the same trajectory either way, and every span name the package passes
listed in SPANS. No JAX reference is needed."""

import os
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import mollytpu_torch as pt
from mollytpu_torch import tracing
from mollytpu_torch.models import ljbench

CPU = torch.device("cpu")
PACKAGE = os.path.dirname(os.path.abspath(tracing.__file__))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread per test, as the parity tests run under xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lj_system():
    """in.lj at 6^3 fcc cells (864 atoms), float32, a rebuild every 5
    steps (the benchmark's tiny LJ cell)."""
    return ljbench.lj_bench_system(6, torch.float32, CPU, seed=7, n_steps=5)


def lj_chunk(sys, n=10):
    sim = pt.VelocityVerlet(dt=ljbench.DT, remove_cm=False)
    nb = pt.find_neighbors(sys.neighbor_finder, sys.coords, sys.boundary,
                           sys.exclusions, 0)
    aux = sim.init_aux(sys, nb)
    return pt.run_chunk(sim, sys, nb, aux, 0, n)


def spans_of(fn, record=True):
    """fn()'s value and the (name, start, end) of every span it emitted
    under a CPU profiler, in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if record:
            with tracing.recording():
                out = fn()
        else:
            out = fn()
    found = sorted((e.time_range.start, -e.time_range.end, e.name)
                   for e in prof.events() if e.name in tracing.SPANS)
    return out, [(name, s, -neg) for s, neg, name in found]


def parent_of(spans):
    """Each span's innermost enclosing span's name (None at the root)."""
    out = []
    for k, (name, s, e) in enumerate(spans):
        outer = [o for o in spans[:k] if o[1] <= s and e <= o[2]]
        out.append((name, outer[-1][0] if outer else None))
    return out


def test_a_chunk_emits_each_span_nested_as_the_loop_runs():
    sys = lj_system()
    _, spans = spans_of(lambda: lj_chunk(sys))
    # init_aux's forces run before the chunk, outside md.chunk
    spans = [s for s in spans if s[1] >= min(
        s2[1] for s2 in spans if s2[0] == "md.chunk")]
    names = [n for n, _, _ in spans]
    assert {n: names.count(n) for n in set(names)} == {
        "md.chunk": 1, "md.step": 10, "forces": 10, "forces.pairs": 10,
        "neighbors.find": 2, "neighbors.check": 2, "md.finish": 1}
    assert set(parent_of(spans)) == {
        ("md.chunk", None), ("md.step", "md.chunk"),
        ("forces", "md.step"), ("forces.pairs", "forces"),
        ("neighbors.find", "md.chunk"), ("neighbors.check", "md.chunk"),
        ("md.finish", "md.chunk")}


def test_recording_off_emits_no_span():
    sys = lj_system()
    _, spans = spans_of(lambda: lj_chunk(sys), record=False)
    assert spans == []
    assert tracing.span("forces") is tracing.span("md.step")


def test_recording_leaves_the_trajectory_bitwise_equal():
    sys = lj_system()
    off, _ = spans_of(lambda: lj_chunk(sys), record=False)
    on, spans = spans_of(lambda: lj_chunk(sys))
    assert spans
    for a, b in ((off[0].coords, on[0].coords),
                 (off[0].velocities, on[0].velocities),
                 (off[2]["forces"], on[2]["forces"])):
        assert torch.equal(a, b)
    assert off[3] == on[3]


def test_recording_restores_the_previous_state_after_an_exception():
    assert not tracing._on
    with pytest.raises(KeyError):
        with tracing.recording():
            assert tracing._on
            with tracing.recording():
                raise KeyError("inner")
    assert not tracing._on
    with tracing.recording():
        with pytest.raises(ValueError):
            with tracing.recording():
                raise ValueError("nested")
        assert tracing._on
    assert not tracing._on


def test_every_span_name_in_the_package_is_listed():
    call = re.compile(r"\bspan\(\s*\"([^\"]+)\"")
    used = set()
    for dirpath, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    used |= set(call.findall(fh.read()))
    assert used == set(tracing.SPANS)
    assert len(set(tracing.SPANS)) == len(tracing.SPANS)


def test_shake_and_pme_emit_constraints_and_a_general_span(tmp_path,
                                                           monkeypatch):
    path = str(tmp_path / "water.pdb")
    pt.water_box_pdb(path, n_waters=64, spacing=6.5)
    sys = pt.system_from_pdb(path, pt.ForceField(pt.TIP3P_XML),
                             nonbonded_method="pme", device=CPU,
                             constraints="hbonds", rigid_water=True,
                             neighbor_finder="cell", dist_neighbors=1.15)
    assert sys.constraints
    sim = pt.VelocityVerlet(dt=0.002, remove_cm=False)
    nb = pt.find_neighbors(sys.neighbor_finder, sys.coords, sys.boundary,
                           sys.exclusions, 0)
    aux = sim.init_aux(sys, nb)
    entered = []
    real = tracing.record_function

    def noted(name, args=None):
        entered.append((name, args))
        return real(name, args)

    monkeypatch.setattr(tracing, "record_function", noted)
    _, spans = spans_of(lambda: pt.run_chunk(sim, sys, nb, aux, 0, 2))
    names = {n for n, _, _ in spans}
    assert {"md.constraints", "forces.general", "forces.pairs",
            "forces.pme", "pme.spread", "pme.solve", "pme.gather",
            "forces.excl"} <= names
    assert ("forces.pme", "PME") in entered
    assert ("forces.excl", "EwaldExclusionCorrection") in entered
    assert ("forces.general", "LJDispersionCorrection") in entered
    assert ("forces.pairs", "neighbor") in entered
    assert ("md.chunk", "step0=0,n=2") in entered
    assert {n for n, _ in entered} == names
