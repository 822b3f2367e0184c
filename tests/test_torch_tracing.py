"""The port's spans (`pipeline.PipelineStats.span`): the tree one
`run_pipeline` call leaves, its `eg3d.<name>` ranges on torch.profiler's
CPU timeline and the idle-gap labels the benchmark's trace reducer
(h100bench/devtrace.py) takes from them, and the benchmark's readers of
the spans (h100bench/metrics/) on hand-made run records.  CPU only; the
scene is small_scene's (8 views at 320x240) from the port's generator.
"""

import importlib.util
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from edgegraph3d_tpu_torch import pipeline as tp
from edgegraph3d_tpu_torch.config import EdgeGraphConfig
from edgegraph3d_tpu_torch.core.synthetic import make_scene
from edgegraph3d_tpu_torch.matching import polyline_stages as tps
from edgegraph3d_tpu_torch.matching import refpoints as rp
from edgegraph3d_tpu_torch.plgs.extraction import extract_plgs
from h100bench import devtrace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(max_polylines_per_view=256, max_polyline_len=128)
#: the spans that h100bench/metrics/*.py read
READ = ("plg_extraction", "context(F+grids)", "f_table",
        "stage3_refpoints", "expand_all_views", "chain_extension",
        "density_filter", "outlier_filter", "group_chains",
        "expansion_copies", "run_pipeline", "louvain")
MS = 1_000_000


def reader(name):
    """h100bench/metrics/<name>.py, loaded as the benchmark loads it."""
    spec = importlib.util.spec_from_file_location(
        f"metric_{name}", os.path.join(ROOT, "h100bench", "metrics",
                                       f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scene():
    return make_scene(n_cams=8, n_refpoints_per_curve=16, width=320,
                      height_px=240, focal=400.0, seed=3)


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):
    """The default stages in memory, and with a working folder, joint BA
    and the debug images: between them every child of run_pipeline."""
    sfmd, imgs, _ = scene
    memory, folder = tp.PipelineStats(), tp.PipelineStats()
    density_in, real_density_filter = [], tp.density_filter

    def density_filter(obs_xy, *a, **k):
        density_in.append(len(obs_xy))
        return real_density_filter(obs_xy, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tp, "density_filter", density_filter)
        tp.run_pipeline(sfmd, imgs, EdgeGraphConfig().replace(**KW),
                        stats=memory, device="cpu")
        work = tmp_path_factory.mktemp("work")
        tp.run_pipeline(sfmd, imgs,
                        EdgeGraphConfig().replace(ba_steps=1, **KW),
                        working_folder=str(work), stats=folder,
                        debug_images=True, device="cpu")
    return dict(memory=memory, folder=folder, work=work,
                density_in=dict(zip(RUNS, density_in)))


RUNS = ("memory", "folder")


@pytest.mark.parametrize("run", RUNS)
def test_benchmark_spans_are_logged(runs, run):
    stats = runs[run]
    assert set(READ) <= set(stats.timings)
    assert not stats.open_spans


@pytest.mark.parametrize("run", RUNS)
def test_density_points_in_counts_what_entered_the_filter(runs, run):
    """`density_points_in` is the number of points handed to the density
    filter; the span's count, the number it kept, is no larger."""
    stats = runs[run]
    n_in = stats.counters["density_points_in"]
    assert n_in == runs["density_in"][run] > 0
    assert 0 < stats.counts["density_filter"] <= n_in


@pytest.mark.parametrize("run", RUNS)
def test_louvain_spans_and_counters(runs, run):
    """The default method (union3) runs host Louvain twice inside
    stage1_communities, each a span louvain, and the native passes'
    work is in the counters."""
    stats = runs[run]
    louvain = [sp for sp in stats.spans if sp[0] == "louvain"]
    assert len(louvain) == 2
    assert {sp[1] for sp in louvain} == {"stage1_communities"}
    c = stats.counters
    assert 1 <= c["louvain_sweeps"] <= 2 * 64 * 10
    assert 0 < c["louvain_moves"] <= c["louvain_visits"]


@pytest.mark.parametrize("run", RUNS)
def test_run_pipeline_is_the_one_root(runs, run):
    roots = [sp for sp in runs[run].spans if sp[1] is None]
    assert [r[0] for r in roots] == ["run_pipeline"]
    assert runs[run].spans[-1] == roots[0]


@pytest.mark.parametrize("run", RUNS)
def test_spans_lie_inside_their_parents(runs, run):
    spans = runs[run].spans
    for name, parent, s, e in spans:
        assert s <= e, name
        if parent is not None:
            assert any(p == parent and ps <= s and e <= pe
                       for p, _, ps, pe in spans), (name, parent)


@pytest.mark.parametrize("run", RUNS)
def test_timings_sum_the_spans(runs, run):
    stats = runs[run]
    for name, seconds in stats.timings.items():
        total = 0.0
        for n, _, s, e in stats.spans:
            if n == name:
                total += (e - s) / 1e9
        assert seconds == pytest.approx(total, rel=1e-12, abs=1e-12), name
    # spans that repeat in a run sum
    assert sum(sp[0] == "expansion_copies" for sp in stats.spans) > 1


def test_root_children_are_the_reader_list(runs):
    """unspanned_s subtracts the children it names: a span that
    run_pipeline opens and the reader misses fails here."""
    children = reader("unspanned_s").CHILDREN
    seen = set()
    for run in RUNS:
        kids = {sp[0] for sp in runs[run].spans if sp[1] == "run_pipeline"}
        assert kids <= set(children), kids - set(children)
        seen |= kids
    assert seen == set(children)


def test_expansion_spans_nest_in_expansion(runs):
    stats = runs["memory"]
    parents = {p for n, p, _, _ in stats.spans
               if n in ("group_chains", "expansion_copies")}
    assert parents == {"expand_all_views", "ext_expand"}
    assert (stats.timings["group_chains"] + stats.timings["expansion_copies"]
            < stats.timings["expand_all_views"]
            + stats.timings["chain_extension"])


def test_manifest_carries_the_span_tree(runs):
    man = json.loads((runs["work"] / "stats.json").read_text())
    spans = [tuple(sp) for sp in man["spans"]]
    assert spans == runs["folder"].spans
    assert man["timings"]["run_pipeline"] > 0
    assert man["counts"]["joint_ba"] == 1


def test_span_sums_counts_and_closes_on_error():
    stats = tp.PipelineStats()
    with stats.span("outer"):
        for k in range(3):
            with stats.span("inner", k) as sp:
                if k == 2:
                    sp.count = 10
        with stats.span("quiet"):
            pass
    assert stats.counts == {"inner": 0 + 1 + 10}
    assert [sp[:2] for sp in stats.spans] == [
        ("inner", "outer")] * 3 + [("quiet", "outer"), ("outer", None)]
    assert stats.timings["inner"] == pytest.approx(
        sum((e - s) / 1e9 for n, _, s, e in stats.spans if n == "inner"))
    with pytest.raises(ValueError):
        with stats.span("fails"):
            raise ValueError
    assert not stats.open_spans and stats.spans[-1][0] == "fails"
    assert stats.to_dict()["spans"][-1][0] == "fails"


def test_stage1_graph_is_logged_without_edges(scene, monkeypatch):
    """A similarity graph without edges still logs its time, and no
    count (as the JAX package logs none)."""
    sfmd, imgs, _ = scene
    cfg = EdgeGraphConfig().replace(**KW)
    ctx = rp.build_context(sfmd, extract_plgs(imgs, cfg), cfg,
                           device="cpu")
    monkeypatch.setattr(tps, "_similarity_edges_host",
                        lambda *a, **k: None)
    stats = tp.PipelineStats()
    assert tps.similarity_graph(sfmd, ctx, stats, host=True) is None
    assert {"stage1_close", "stage1_graph"} <= set(stats.timings)
    assert "stage1_graph" not in stats.counts


@pytest.fixture(scope="module")
def traced(scene):
    """One run_pipeline under torch.profiler inside the benchmark's MARK
    range, as h100bench/run.py traces a scene: (stats, events)."""
    sfmd, imgs, _ = scene
    stats = tp.PipelineStats()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(devtrace.MARK):
            tp.run_pipeline(sfmd, imgs, EdgeGraphConfig().replace(**KW),
                            stats=stats, device="cpu")
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
               e.is_user_annotation())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CPU]
    return stats, events


def test_every_span_is_a_profiler_operation(traced):
    stats, events = traced
    for name in {sp[0] for sp in stats.spans}:
        spans = sorted(sp for sp in stats.spans if sp[0] == name)
        evs = sorted((s, e, user) for n, s, e, user in events
                     if n == "eg3d." + name)
        assert len(evs) == len(spans), name
        for (_, _, s, e), (es, ee, user) in zip(
                sorted(spans, key=lambda sp: sp[2]), evs):
            assert not user, name
            assert abs(es - s) <= MS, name
            assert e <= ee + MS, name


def test_gap_in_density_filter_is_named(traced):
    """devtrace.reduce_events labels an idle gap inside the
    density_filter span with its range, where it said `host`."""
    stats, events = traced
    window = next((s, e) for n, s, e, _ in events if n == devtrace.MARK)
    cpu = [(n, s, e) for n, s, e, user in events if not user]
    (_, _, s, e), = [sp for sp in stats.spans if sp[0] == "density_filter"]
    assert e - s > 10_000
    dev = [("k", s + 1_000, s + 2_000), ("k", e - 2_000, e - 1_000)]
    trace = devtrace.reduce_events(dev, cpu, window)
    gap = (e - 2_000 - (s + 2_000)) / 1e9
    labels = [label for label, g in trace.gaps if g == pytest.approx(gap)]
    assert labels == ["eg3d.density_filter"]
    # without the program's ranges the reducer had nothing to name it by
    bare = [c for c in cpu if not c[0].startswith("eg3d.")]
    assert "eg3d.density_filter" not in [
        label for label, _ in devtrace.reduce_events(dev, bare,
                                                     window).gaps]


def run_record(*timings, traces=()):
    return dict(scenes=[dict(timings=t) for t in timings],
                traces=list(traces), root=ROOT, window_s=1.0,
                done=len(timings))


@pytest.mark.parametrize("name,span", [("group_chains_s", "group_chains"),
                                       ("expansion_copies_s",
                                        "expansion_copies"),
                                       ("f_table_s", "f_table"),
                                       ("louvain_s", "louvain")])
def test_span_readers(name, span):
    read = reader(name).read
    assert read(run_record({span: 1.0, "expand_all_views": 3.0},
                           {span: 2.0, "expand_all_views": 3.0})) == 1.5
    # the parent's program has no such span
    assert read(run_record({"expand_all_views": 3.0})) is None


def test_unspanned_reader(runs):
    read = reader("unspanned_s").read
    assert read(run_record(
        {"run_pipeline": 10.0, "plg_extraction": 2.0,
         "density_filter": 7.0, "group_chains": 0.5, "ext_expand": 0.25},
        {"run_pipeline": 4.0, "outlier_filter": 4.0})) == pytest.approx(0.5)
    assert read(run_record({"plg_extraction": 2.0})) is None
    for run in RUNS:
        t = runs[run].timings
        assert -1e-9 <= read(run_record(t)) < t["run_pipeline"]


def test_idle_gaps_named_share_reader():
    read = reader("idle_gaps_named_share").read
    trace = devtrace.SceneTrace(gaps=[("eg3d.density_filter", 3.0),
                                      ("aten::copy_", 0.5)])
    other = devtrace.SceneTrace(gaps=[("eg3d.stage1_communities", 0.5)])
    assert read(run_record(traces=[trace, other])) == pytest.approx(0.875)
    # the parent's gaps all read `host`; a run without traces reads none
    host = devtrace.SceneTrace(gaps=[("host", 2.0), ("host", 1.0)])
    assert read(run_record(traces=[host])) == 0.0
    assert read(run_record()) is None
