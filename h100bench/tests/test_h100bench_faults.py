"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell of this benchmark can have (one chip: no
exchange between chips); the sound run comes out correct.  The CPU runs
the program's plain paths at the tiny cell's size; the control (the
reference in TF32 in the program's place) runs on the CPU and, marked
`cuda`, on the card."""

import numpy as np
import pytest

from h100bench import faults, reference, run, scenes
from h100bench.tests.conftest import tiny_cell


def run_with(monkeypatch, fault=None):
    from edgegraph3d_tpu_torch import pipeline
    cell = tiny_cell()
    if fault is not None:
        real = pipeline.run_pipeline
        timed = scenes.make(cell["config"]["scene"], 7)
        calls = []

        def broken(sfmd, *a, **k):
            """The window's scenes break; the warm-up pass does not."""
            out = real(sfmd, *a, **k)
            calls.append(1)
            assert np.array_equal(sfmd.points, timed.points)
            return fault(timed, out) if len(calls) > 1 else out
        monkeypatch.setattr(pipeline, "run_pipeline", broken)
    return run.run(cell, 7, 0.5, False, device="cpu")


def test_sound_run_is_correct(monkeypatch):
    res = run_with(monkeypatch)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("name", sorted(faults.FAULTS))
def test_fault_is_caught(monkeypatch, name):
    res = run_with(monkeypatch, faults.FAULTS[name])
    assert not res["correct"]
    failed = [n for n, c in res["checks"].items() if not c["ok"]]
    assert failed, res["checks"]


def test_a_scene_that_raises_is_not_correct(monkeypatch):
    def boom(scene, out):
        raise RuntimeError("planted")
    res = run_with(monkeypatch, boom)
    assert not res["correct"] and res["failed"] == res["attempted"] >= 1


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_control_is_not_correct(device):
    """The reference in TF32 put in the program's place fails `gap_px`
    (the program's own output passes), at the tiny size."""
    import torch
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = tiny_cell()
    conf = cell["config"]
    runner = run.Runner(cell, device)
    for seed in (3, 4, 5):
        scene = scenes.make(conf["scene"], seed)
        out = reference.output_of(runner(scene)[0])
        g = conf["guarantees"]
        prog = reference.judge_numbers(scene, out, g)
        ctrl = reference.judge_numbers(
            scene, out, g, points=reference.control_points(scene, out,
                                                           device))
        limit = cell["limits"]["gap_px"]
        assert prog["gap_px"] <= limit < ctrl["gap_px"], (prog, ctrl)


def test_a_number_without_reading_fails():
    """An output without edge-points has no `med_dist3d`: held, it fails,
    and it is the worst reading of a run."""
    rows = reference.verdict(dict(med_dist3d=None, coverage=0.0),
                             dict(med_dist3d=0.004, coverage=0.95))
    assert [ok for _, _, _, ok in rows] == [False, False]
    assert reference.worse("med_dist3d", None, 0.002)
    assert not reference.worse("med_dist3d", 0.002, None)
    assert reference.worse("coverage", 0.5, 0.9)


def test_traffic_keys_go_to_run_pipeline():
    """Every key of a traffic file is an argument of `run_pipeline`: one
    it does not take raises instead of being dropped."""
    cell = tiny_cell()
    cell["traffic"] = dict(stages=[3], max_starting_views=2,
                           no_such_argument=1)
    runner = run.Runner(cell, "cpu")
    assert runner.kw["max_starting_views"] == 2
    scene = scenes.make(cell["config"]["scene"], 3)
    with pytest.raises(TypeError, match="no_such_argument"):
        runner(scene)
