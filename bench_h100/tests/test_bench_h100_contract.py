"""BENCHMARK.json parses, keeps to the benchmark's rules of form, and
every name it gives is found as a file."""

import json
import os
import re

import pytest

from bench_h100 import harness

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_h100"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert os.path.getsize(os.path.join(harness.ROOT,
                                        "BENCHMARK.json")) < 64 * 1024


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]


def test_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        mine_e2e, mine_layer = harness.metrics_of(BENCH, cell)
        assert "setup_s" in {m["name"] for m in mine_e2e}
        assert len(mine_e2e) >= 2 and mine_layer
        reported = {m["name"] for m in mine_e2e}
        for m in mine_layer:
            assert m["moves"] in reported, (cell, m["name"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    bench, wl, config, traffic, limits = harness.resolve_cell(cell)
    assert traffic["operation"] in ("solve", "apply")
    assert config["name"] == wl["config"]
    assert os.path.exists(os.path.join(harness.ROOT, config["reference"]))
    e2e, per_layer = harness.metrics_of(bench, cell)
    for m in e2e:
        assert callable(harness.load_reader("e2e", m["name"]))
    for m in per_layer:
        assert callable(harness.load_reader("layers", m["name"]))
    for name, lim in limits.items():
        if name != "rehearsal":
            assert "limit" in lim


def test_every_config_is_used_and_lies_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("bench_h100/")
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
        files.add(c["file"])
    assert len(files) == len(BENCH["configs"])
