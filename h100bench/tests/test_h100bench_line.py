"""The result line: its keys, the checks beside their limits, and the
refusals (no card, JAX loaded)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from h100bench import run
from h100bench.tests.conftest import ROOT, tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def main_on_cpu(monkeypatch, capsys, cell, trace):
    import torch
    monkeypatch.setattr(run, "load_cell", lambda name: cell)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    real = run.run
    monkeypatch.setattr(run, "run", lambda *a, **k: real(*a, device="cpu"))
    rc = run.main(["--workload", "tiny", "--seed", "7", "--seconds", "0.5",
                   "--trace", str(trace)])
    out, err = capsys.readouterr()
    return rc, out.strip().splitlines(), err.strip().splitlines()


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_keys(monkeypatch, capsys, trace):
    cell = tiny_cell(per_layer=[
        dict(name="scene_wall_s", unit="s"),
        dict(name="plg_extraction_s", unit="s"),
        dict(name="device_idle_share", unit="share")])
    rc, out, err = main_on_cpu(monkeypatch, capsys, cell, trace)
    assert rc == 0
    line = json.loads(out[-1])
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == want
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert list(line["metrics"]) == ["scene_wall_s", "plg_extraction_s"]
        assert line["metrics"]["scene_wall_s"]["value"] > 0
    else:
        assert list(line["metrics"]) == ["peak_mem_gib", "setup_s"]
        assert all(m["value"] is not None for m in line["metrics"].values())
    # the checks close stderr, each beside its limit
    checks = line["checks"]
    assert {"gap_px", "mse_px2", "min_views", "unclaimed",
            "edge_points"} <= set(checks)
    assert len(err) >= len(checks)
    for row, name in zip(err[-len(checks):], checks):
        assert row.startswith(f"check {name} ") and " limit " in row
    assert out[-3].startswith("scenes: ") and out[-2].startswith("host: ")


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        name = json.load(f)["workloads"][0]["name"]
    rc = run.main(["--workload", name, "--seed", "1", "--seconds", "1"])
    out, _ = capsys.readouterr()
    assert rc != 0 and out == ""


def test_jax_loaded_no_result(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", sys)
    cell = tiny_cell()
    rc, out, err = main_on_cpu(monkeypatch, capsys, cell, 0)
    assert rc != 0 and out == []
    assert any("jax" in e for e in err)


def test_without_the_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and h100bench/ the
    run fails before any result (here with the card check stubbed)."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "h100bench"), tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(tmp_path / "BENCHMARK.json") as f:
        name = json.load(f)["workloads"][0]["name"]
    code = ("import sys, torch; torch.cuda.is_available = lambda: True; "
            "torch.cuda.device_count = lambda: 1; "
            "sys.argv[1:] = ['--workload', %r, '--seed', '1', "
            "'--seconds', '1']; import runpy; "
            "runpy.run_path('h100bench/run.py', run_name='__main__')" % name)
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "edgegraph3d_tpu_torch" in p.stderr
