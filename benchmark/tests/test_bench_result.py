"""The result line, the refusals, and the modules a run loads."""

import json
import os
import re
import subprocess
import sys

import pytest

import bench_tiny
import harness

RUN = os.path.join(harness.BENCH, "run.py")


def test_result_line_has_the_contract_keys():
    res = bench_tiny.run_tiny(bench_tiny.CELLS[0])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"timesteps_per_s", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


@pytest.mark.parametrize("cell", bench_tiny.CELLS)
def test_device_metrics_without_a_card_fail(cell):
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench_tiny.run_tiny(cell, trace=True)


def test_run_without_a_card_exits_nonzero_and_prints_nothing():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, RUN, "--workload",
                          bench_tiny.CELLS[0], "--seed", "1", "--seconds",
                          "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=harness.REPO,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(
        ["mollytpu_torch", "mollytpu_torch.ops", "jaxtyping", "torch"]) == []
    assert harness.forbidden_modules(
        ["jax.numpy", "mollytpu.ops", "flax", "chip_smoke"]) == [
            "chip_smoke", "flax", "jax.numpy", "mollytpu.ops"]


def test_no_harness_source_imports_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(?:from|import)\s+([A-Za-z_][\w.]*)", re.M)
    for dirpath, _, files in os.walk(harness.BENCH):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(dirpath, f)).read()
                tops = {m.split(".")[0] for m in pat.findall(src)}
                assert not tops & set(harness.FORBIDDEN), f


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A fresh interpreter runs each tiny cell and lists what it loaded."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import bench_tiny, harness\n"
        "for c in bench_tiny.CELLS:\n"
        "    assert bench_tiny.run_tiny(c)['correct']\n"
        "print(harness.forbidden_modules())\n"
        % os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
