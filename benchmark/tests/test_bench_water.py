"""The water cell (gmx-water-1536000.nvt) at a tiny size on the CPU: the
committed tile once (3,000 atoms), a 10-step warm-up.
It loads; the program passes its checks; the control (the reference in
TF32 in the program's place) fails them; and each planted fault of the
timed path fails a check: the pair kernel's Ewald splitting parameter off
PME's, the exclusion correction left out, PME of order 5 in place of 4,
and the rigid waters on 10 global Jacobi sweeps in place of the cluster
solve."""

import dataclasses
import io
import os
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import harness  # noqa: E402

CELL = "gmx-water-1536000.nvt"
SEED = 2 ** 31 + 23
#: readers of the water cell's spans, and the LJ cell's reader of each
SPAN_READERS = {name: name.replace(".water", ".lj") for name in (
    "find_ms.water", "stale_check_ms.water", "pairs_ms.water",
    "integrate_self_ms.water", "host_syncs_per_step.water")}


@pytest.fixture(autouse=True)
def this_benchmark_first(monkeypatch):
    """The cell's modules come from this benchmark/, also where another
    test has put a copy of it on sys.path."""
    monkeypatch.setattr(sys, "path", [BENCH] + [p for p in sys.path
                                                if p != BENCH])
    for name in [n for n in sys.modules
                 if n == "reference" or n.startswith("reference.")]:
        monkeypatch.delitem(sys.modules, name)


def tiny_spec():
    spec = harness.cell_spec(harness.load_benchmark(), CELL)
    cfg = spec["config"]
    cfg["water"]["tiles_per_side"] = 1
    cfg["n_atoms"] = 3000
    spec["traffic"]["warmup_steps"] = 10
    return spec


def run_tiny(control=False):
    return harness.run_cell(tiny_spec(), SEED, 0.5, False, "cpu",
                            time.perf_counter(), control=control,
                            log=io.StringIO())


def _gaps(res):
    return {k: c["value"] for k, c in res["checks"].items()}


def test_the_cell_loads_with_its_metrics():
    spec = harness.cell_spec(harness.load_benchmark(), CELL)
    assert spec["config"]["n_atoms"] == 1536000
    assert set(spec["limits"]) == {"e_start", "f_end", "x_chunk", "c_end"}
    assert [m["name"] for m in spec["end_to_end"]] == ["timesteps_per_s",
                                                       "setup_s"]
    assert {m["name"] for m in spec["per_layer"]} == {
        "device_idle_pct.water", "launches_per_step.water",
        "host_syncs_per_step.water", "pairs_ms.water",
        "pair_kernel_roofline_pct.water", "pme_ms.water",
        "constraints_ms.water", "find_ms.water", "stale_check_ms.water",
        "rebuild_ms.water", "integrate_self_ms.water"}
    for m in spec["per_layer"]:
        assert m["moves"] == "timesteps_per_s"
        assert callable(harness.load_module("metrics", m["name"]).read)


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_a_span_reader_reads_as_the_lj_cells(name):
    """Each reader of the water cell's spans is the LJ cell's reader of the
    same span: both give None without spans, and the same number from a
    reduction that has them."""
    import spans

    class Run:
        def __init__(self, reduction):
            self.reduction = reduction

        def on_card(self):
            pass

        def once(self, key, fn):
            return self.reduction

    def read(metric, run):
        return harness.load_module("metrics", metric).read(run)

    assert read(name, Run(None)) is None
    red = spans.SpanReduction(
        count={"md.chunk": 1, "md.step": 2, "forces": 2, "forces.pairs": 2,
               "neighbors.find": 1, "neighbors.check": 1},
        host_us={}, device=[
            (0.0, 10.0, ("md.chunk", "md.step", "forces", "forces.pairs")),
            (10.0, 13.0, ("md.chunk", "md.step")),
            (20.0, 30.0, ("md.chunk", "neighbors.find")),
            (40.0, 45.0, ("md.chunk", "neighbors.check"))],
        launches=[], syncs=[("md.chunk",), ("md.chunk", "neighbors.find")],
        self_us={}, idle={}, busy_us=28.0)
    got = read(name, Run(red))
    assert got is not None and got == read(SPAN_READERS[name], Run(red))


def test_program_passes_its_checks():
    res = run_tiny()
    assert res["correct"] is True, _gaps(res)
    assert res["attempted"] >= 1 and res["failed"] == 0


def test_control_fails_its_checks():
    res = run_tiny(control=True)
    assert res["correct"] is False
    assert all(c["value"] > c["limit"] for c in res["checks"].values()), \
        _gaps(res)


def _built_with(monkeypatch, change=None, **kw):
    from mollytpu_torch.models import gromacs
    real = gromacs.system_from_gromacs

    def planted(*args, **kwargs):
        system = real(*args, **{**kwargs, **kw})
        return system if change is None else change(system)
    monkeypatch.setattr(gromacs, "system_from_gromacs", planted)


def _beta_off(monkeypatch):
    def change(s):
        lj, coul = s.pairwise_inters
        return s.update(pairwise_inters=(lj, dataclasses.replace(
            coul, alpha=1.05 * coul.alpha)))
    _built_with(monkeypatch, change)


def _no_exclusion_correction(monkeypatch):
    from mollytpu_torch.ops.ewald import EwaldExclusionCorrection
    _built_with(monkeypatch, lambda s: s.update(general_inters=tuple(
        g for g in s.general_inters
        if not isinstance(g, EwaldExclusionCorrection))))


def _pme_order_5(monkeypatch):
    _built_with(monkeypatch, pme_order=5)


def _ten_sweeps(monkeypatch):
    def change(s):
        (c,) = s.constraints
        return s.update(constraints=(dataclasses.replace(
            c, clusters=(), n_iters=10, vel_iters=10),))
    _built_with(monkeypatch, change)


FAULTS = {"beta_off": _beta_off,
          "no_exclusion_correction": _no_exclusion_correction,
          "pme_order_5": _pme_order_5, "ten_sweeps": _ten_sweeps}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = run_tiny()
    assert res["correct"] is False, _gaps(res)


def test_a_water_run_loads_neither_jax_nor_the_jax_package():
    """A fresh interpreter runs the tiny water cell and lists what it
    loaded: the reference and the program, and no JAX."""
    import subprocess
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import test_bench_water as t, harness\n"
        "assert t.run_tiny()['correct']\n"
        "print(harness.forbidden_modules())\n"
        % os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
