"""BENCHMARK.json against the rules it follows (keys, names, units,
bounds), and every cell's configuration, traffic, limits and metric files
found by name."""

import json
import os
import re

import pytest

from h100bench import run
from h100bench.tests.conftest import ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source", "layer", "moves",
               "workloads"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "h100bench/run.py"]
    assert BENCH["paths"] == ["h100bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config",
                                                         "traffic")]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    texts = [c["why"] for c in BENCH["configs"] + BENCH["workloads"]]
    texts += [c["source"] for c in BENCH["configs"]]
    texts += [m["layer"] for m in BENCH["per_layer"]]
    assert all(LINE.match(t) for t in texts)


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {"peak_mem_gib", "setup_s"} <= set(e2e)
    # the scene's wall swings too far for a bound (PERF.md): per layer
    assert "scene_s" not in e2e
    assert "scene_wall_s" in {m["name"] for m in BENCH["per_layer"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= METRIC_KEYS
        assert m["moves"] in e2e
        assert set(m.get("workloads", [])) <= cells


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_its_files(workload):
    cell = run.load_cell(workload, BENCH)
    assert cell["chips"] in (1, 4)
    conf = cell["config"]
    assert {"scene", "guarantees", "assumed",
            "reduced"} <= set(conf)
    from h100bench import reference
    assert set(cell["limits"]) - {"readings"} <= set(reference.SENSE)
    assert {"gap_px", "edge_points"} <= set(cell["limits"])
    assert set(cell["traffic"]) >= {"stages"}
    for m in cell["per_layer"]:
        reader = run.load_reader(m["name"])
        assert (reader.UNIT, reader.LAYER, reader.MOVES, reader.SOURCE) == (
            m["unit"], m["layer"], m["moves"], m["source"])
        assert callable(reader.read)
    assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s"}
    assert cell["per_layer"]


def test_configs_are_their_own_files():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("h100bench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_every_reader_has_an_entry():
    listed = {m["name"] for m in BENCH["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(ROOT, "h100bench",
                                                     "metrics"))
             if f.endswith(".py")}
    assert files == listed
