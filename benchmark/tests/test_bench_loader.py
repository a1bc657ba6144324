"""The loader finds every piece by name, and a new cell, configuration,
traffic mix, protocol and metric are new files and entries only."""

import json
import os
import re
import shutil

import pytest

import bench_tiny
import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_resolves_to_its_files():
    bench = harness.load_benchmark()
    for w in bench["workloads"]:
        spec = harness.cell_spec(bench, w["name"])
        assert spec["config"]["name"] == w["config"]
        harness.load_module("systems", spec["config"]["builder"])
        harness.load_module("protocols", spec["traffic"]["protocol"])
        assert spec["limits"]
        for m in spec["end_to_end"] + spec["per_layer"]:
            assert callable(harness.load_module("metrics", m["name"]).read)


def test_benchmark_json_keeps_the_contract():
    bench = harness.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        cfg = json.load(open(os.path.join(harness.REPO, c["file"])))
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert cfg["assumed"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        spec = harness.cell_spec(bench, w["name"])
        reported = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec["per_layer"]
        for m in spec["per_layer"]:
            assert m["moves"] in reported
    assert len(json.dumps(bench)) < 64 * 1024


def test_the_lj_cell_is_in_lj_at_its_own_scale():
    """The LJ configurations are in.lj's fcc lattice whole (4 atoms a
    cell), every configuration keeps a cell, and the metrics list only
    cells that exist: the host-bound 256,000-atom cell reports its rate
    and its layers under metrics of its own (``.lj256k``), not under
    timesteps_per_s's bound, which the card-bound cells set."""
    bench = harness.load_benchmark()
    cfgs = [json.load(open(os.path.join(harness.REPO, c["file"])))
            for c in bench["configs"]]
    lj = [cfg for cfg in cfgs if cfg["builder"] == "lj_fcc"]
    assert len(lj) == 2
    for cfg in lj:
        assert cfg["n_atoms"] == 4 * cfg["lj"]["n_cells"] ** 3
    cells = {w["name"] for w in bench["workloads"]}
    assert {c["name"] for c in bench["configs"]} == {
        w["config"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        listed = set(m.get("workloads", ()))
        assert listed <= cells, m
        if m["name"] == "timesteps_per_s" or m["name"].endswith(".lj"):
            assert listed and "lj-bench-256000.nve" not in listed, m
        if m["name"].endswith(".lj256k"):
            assert listed == {"lj-bench-256000.nve"}, m
    spec = harness.cell_spec(bench, "lj-bench-256000.nve")
    assert {m["name"] for m in spec["end_to_end"]} == {
        "timesteps_per_s.lj256k", "setup_s"}
    assert {m["moves"] for m in spec["per_layer"]} == {
        "timesteps_per_s.lj256k"}


def test_a_new_cell_is_new_files_only(tmp_path):
    """Copy the benchmark, add a cell with its own traffic, protocol,
    limits and per-layer metric, touch no copied file, and find it all."""
    root = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    bench = harness.load_benchmark()
    (root / "traffic" / "nve-long.json").write_text(json.dumps(
        {**json.load(open(root / "traffic" / "nve.json")),
         "protocol": "md-copy", "chunk_steps": 50}))
    shutil.copy(root / "protocols" / "md.py", root / "protocols" /
                "md-copy.py")
    (root / "metrics" / "chunk_count.py").write_text(
        "def read(run):\n    return run.window['chunks']\n")
    (root / "workloads" / "lj-bench-2048000.nve-long.json").write_text(
        json.dumps({"limits": {"e_start": 1, "f_end": 1, "x_chunk": 1}}))
    bench["workloads"].append({"name": "lj-bench-2048000.nve-long",
                               "config": "lj-bench-2048000",
                               "traffic": "nve-long", "chips": 1,
                               "why": "a test"})
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    e2e["timesteps_per_s"]["workloads"].append("lj-bench-2048000.nve-long")
    bench["per_layer"].append({"name": "chunk_count", "unit": "chunks",
                               "better": "higher", "source": "host_clock",
                               "layer": "loop", "moves": "timesteps_per_s",
                               "workloads": ["lj-bench-2048000.nve-long"]})
    spec = harness.cell_spec(bench, "lj-bench-2048000.nve-long",
                             root=str(root))
    assert spec["traffic"]["chunk_steps"] == 50
    assert [m["name"] for m in spec["end_to_end"]] == ["timesteps_per_s",
                                                       "setup_s"]
    assert [m["name"] for m in spec["per_layer"]] == ["chunk_count"]
    assert harness.load_module("protocols", "md-copy", str(root)).run
    assert harness.load_module("metrics", "chunk_count", str(root)).read
    for p, data in before.items():
        assert p.read_bytes() == data


def test_a_per_layer_metric_must_list_its_cells():
    bench = harness.load_benchmark()
    bench["per_layer"].append({"name": "chunk_count", "unit": "chunks",
                               "better": "higher", "source": "host_clock",
                               "layer": "loop", "moves": "timesteps_per_s"})
    with pytest.raises(ValueError, match="lists no workloads"):
        harness.cell_spec(bench, bench_tiny.CELLS[0])


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.cell_spec(harness.load_benchmark(), "no-such.cell")


def test_tiny_cells_resolve():
    for cell in bench_tiny.CELLS:
        assert bench_tiny.tiny_spec(cell)["traffic"]["warmup_steps"] == 20
