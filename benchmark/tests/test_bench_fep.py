"""The alchemical window (gmx-water-fep-1536000.fep) at a tiny size on the
CPU: the committed tile once (3,000 atoms), a 10-step warm-up and a sample
every 10 steps. It loads with its metrics; every check is reported; the
program passes; the control (the reference in TF32 in the program's place)
fails; and each planted fault fails a check: the exclusion correction on
the unscaled charges beside the scheduled PME, the soft-core Coulomb
turned off, and PME's change left out of the cross energies."""

import io
import os
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import harness  # noqa: E402

CELL = "gmx-water-fep-1536000.fep"
SEED = 2 ** 31 + 29
CHECKS = {"e_start", "f_end", "x_chunk", "c_end", "du_cross"}
#: readers of the fep cell's spans, and the water cell's reader of each
SPAN_READERS = {name: name.replace(".fep", ".water") for name in (
    "pairs_ms.fep", "pme_ms.fep", "host_syncs_per_step.fep",
    "constraints_ms.fep", "find_ms.fep", "stale_check_ms.fep",
    "integrate_self_ms.fep")}


@pytest.fixture(autouse=True)
def this_benchmark_first(monkeypatch):
    """The cell's modules come from this benchmark/, also where another
    test has put a copy of it on sys.path."""
    monkeypatch.setattr(sys, "path", [BENCH] + [p for p in sys.path
                                                if p != BENCH])
    for name in [n for n in sys.modules
                 if n.split(".")[0] in ("reference", "systems",
                                        "protocols")]:
        monkeypatch.delitem(sys.modules, name)


def tiny_spec():
    spec = harness.cell_spec(harness.load_benchmark(), CELL)
    cfg = spec["config"]
    cfg["water"]["tiles_per_side"] = 1
    cfg["n_atoms"] = 3000
    spec["traffic"]["warmup_steps"] = 10
    spec["traffic"]["sample_every_steps"] = 10
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
    assert spec["config"]["builder"] == "gmx_water_fep"
    assert set(spec["limits"]) == CHECKS
    assert spec["limits"]["du_cross"] <= 0.1
    assert [m["name"] for m in spec["end_to_end"]] == ["timesteps_per_s",
                                                       "setup_s"]
    assert {m["name"] for m in spec["per_layer"]} == {
        "pairs_ms.fep", "pair_kernel_roofline_pct.fep", "pme_ms.fep",
        "cross_energy_ms.fep", "device_idle_pct.fep",
        "launches_per_step.fep", "host_syncs_per_step.fep",
        "constraints_ms.fep", "find_ms.fep", "stale_check_ms.fep",
        "rebuild_ms.fep", "integrate_self_ms.fep"}
    for m in spec["per_layer"]:
        assert m["moves"] == "timesteps_per_s"
        assert m["workloads"] == [CELL]
        assert callable(harness.load_module("metrics", m["name"]).read)


class _Run:
    def __init__(self, reduction):
        self.reduction = reduction

    def on_card(self):
        pass

    def once(self, key, fn):
        return self.reduction


def _read(metric, run):
    return harness.load_module("metrics", metric).read(run)


def _reduction():
    import spans
    return spans.SpanReduction(
        count={"md.chunk": 1, "md.step": 2, "forces": 2, "forces.pairs": 2,
               "forces.pme": 2, "fep.cross": 1, "md.constraints": 2,
               "neighbors.find": 1, "neighbors.check": 1},
        host_us={}, device=[
            (0.0, 10.0, ("md.chunk", "md.step", "forces", "forces.pairs")),
            (10.0, 16.0, ("md.chunk", "md.step", "forces", "forces.pme")),
            (16.0, 17.0, ("md.chunk", "md.step", "md.constraints")),
            (17.0, 19.0, ("md.chunk", "neighbors.find")),
            (19.0, 20.0, ("md.chunk", "neighbors.check")),
            (20.0, 27.0, ("fep.cross",))],
        launches=[], syncs=[("md.chunk",), ("fep.cross",)],
        self_us={}, idle={}, busy_us=27.0)


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_a_span_reader_reads_as_the_water_cells(name):
    assert _read(name, _Run(None)) is None
    got = _read(name, _Run(_reduction()))
    assert got is not None and got == _read(SPAN_READERS[name],
                                            _Run(_reduction()))


def test_the_cross_energy_reader_reads_per_sample():
    """Device ms under ``fep.cross`` per span; None without spans or
    without that span (a program that has no such span)."""
    assert _read("cross_energy_ms.fep", _Run(None)) is None
    assert _read("cross_energy_ms.fep", _Run(_reduction())) == \
        pytest.approx(7e-3)
    red = _reduction()
    red.count.pop("fep.cross")
    assert _read("cross_energy_ms.fep", _Run(red)) is None


def test_program_passes_its_checks():
    res = run_tiny()
    assert set(res["checks"]) == CHECKS
    assert res["correct"] is True, _gaps(res)
    assert res["attempted"] >= 1 and res["failed"] == 0


def test_control_fails_its_checks():
    res = run_tiny(control=True)
    assert set(res["checks"]) == CHECKS
    assert res["correct"] is False
    assert all(c["value"] > c["limit"] for c in res["checks"].values()), \
        _gaps(res)


def _coupled_with(monkeypatch, change):
    import mollytpu_torch as pt
    real = pt.couple_molecule

    def planted(system, mask, **kw):
        return change(real(system, mask, **kw), system)
    monkeypatch.setattr(pt, "couple_molecule", planted)


def _unscaled_exclusions(monkeypatch):
    import dataclasses
    from mollytpu_torch.ops.ewald import PME, EwaldExclusionCorrection

    def change(c, plain):
        pme = [g for g in c.general_inters if isinstance(g, PME)][0]
        excl = [g for g in plain.general_inters
                if isinstance(g, EwaldExclusionCorrection)]
        return c.update(general_inters=(dataclasses.replace(
            pme, excl_i=pme.excl_i[:0], excl_j=pme.excl_j[:0]), *excl))
    _coupled_with(monkeypatch, change)


def _no_softcore_coulomb(monkeypatch):
    import dataclasses

    def change(c, plain):
        lj, coul = c.pairwise_inters
        return c.update(pairwise_inters=(lj, dataclasses.replace(
            coul, alpha_sc=0.0)))
    _coupled_with(monkeypatch, change)


def _cross_without_pme(monkeypatch):
    import torch
    from mollytpu_torch.ops.ewald import PME
    monkeypatch.setattr(PME, "charge_change_energy",
                        lambda self, x, box, q, index, dq: torch.zeros(
                            dq.shape[0], dtype=torch.float64))


FAULTS = {"unscaled_exclusions": _unscaled_exclusions,
          "no_softcore_coulomb": _no_softcore_coulomb,
          "cross_without_pme": _cross_without_pme}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = run_tiny()
    assert res["correct"] is False, _gaps(res)


def test_a_fep_run_loads_neither_jax_nor_the_jax_package():
    """A fresh interpreter runs the tiny cell and lists what it loaded:
    the reference and the program, and no JAX."""
    import subprocess
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import test_bench_fep as t, harness\n"
        "assert t.run_tiny()['correct']\n"
        "print(harness.forbidden_modules())\n"
        % os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
