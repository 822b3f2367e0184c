"""Run one cell of BENCHMARK.json once on one H100.

    python3 h100bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up builds the seeded scene of the cell's configuration
(h100bench/configs/<config>.json), loads the kernels and warms up with
one pass of that scene.  The measured window then runs the
cell's traffic (h100bench/traffic/<traffic>.json: `run_pipeline`'s stages
and arguments) on fresh copies of the scene, one whole scene after
another, and ends with the first scene that finishes at or after
`--seconds`.  Afterwards the plain reference (reference.py) judges every
scene the window returned.  With `--trace 0` the last line of standard
output carries the cell's end-to-end metrics; with `--trace 1` every
scene runs under torch.profiler and the line carries the per-layer
metrics (h100bench/metrics/<metric>.py) and a breakdown.  Without a
CUDA device, or with fewer than the cell asks for, it exits 3 and prints
no result.
"""

from __future__ import annotations

import os
import sys
import time

#: the run's start on the wall clock: set-up counts from here
T0 = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".bench_cache")
# every build and kernel cache of the run stays inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: module names that may not be loaded in the process that prints the
#: result (compared by the whole top-level name)
FORBIDDEN = ("jax", "jaxlib", "flax", "edgegraph3d_tpu")
#: the most scenes one window runs (scenes that fail at once could
#: otherwise spin)
MAX_SCENES = 1000
#: traced scenes run after the window when no trace of it holds a
#: CUDA-side entry
EXTRA_TRACED = 2


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_reader(name):
    spec = importlib.util.spec_from_file_location(
        f"h100bench_metric_{name}", os.path.join(HERE, "metrics",
                                                 f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str, bench: dict | None = None) -> dict:
    """The cell `workload` of BENCHMARK.json with its configuration,
    traffic and the metrics it reports, each found by name."""
    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads",
                                                        [workload])]
    return dict(
        name=workload, chips=cell["chips"],
        config=load_json(os.path.join(ROOT, conf["file"])),
        traffic=load_json(os.path.join(HERE, "traffic",
                                       f"{cell['traffic']}.json")),
        limits=load_json(os.path.join(HERE, "limits", f"{workload}.json")),
        end_to_end=mine(bench["end_to_end"]),
        per_layer=mine(bench["per_layer"]))


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def program_scene(scene):
    """The program's input type for a scenes.Scene (fresh copies)."""
    from edgegraph3d_tpu_torch.core.sfm import SfMData
    return SfMData(
        K=scene.K.copy(), R=scene.R.copy(), t=scene.t.copy(),
        center=scene.center.copy(), widths=scene.widths.copy(),
        heights=scene.heights.copy(),
        image_paths=[f"synthetic_{i:04d}.png"
                     for i in range(scene.n_cameras)],
        points=scene.points.copy(),
        obs_cam=[c.copy() for c in scene.obs_cam],
        obs_xy=[x.copy() for x in scene.obs_xy], raw_doc=None)


def edge_graph_config(config: dict):
    """The program's EdgeGraphConfig for a configuration file, checked
    against the guarantees the file states (the reference holds the
    output to those)."""
    from edgegraph3d_tpu_torch.config import DEFAULT_CONFIG
    egc = DEFAULT_CONFIG.replace(**config.get("edge_graph_config", {}))
    for k, v in config["guarantees"].items():
        if getattr(egc, k) != v:
            raise ValueError(f"configuration runs {k}={getattr(egc, k)!r}"
                             f" but states {v!r}")
    return egc


class Runner:
    """One scene through `run_pipeline` on `device`, ending in a
    synchronisation."""

    def __init__(self, cell: dict, device: str):
        import torch

        from edgegraph3d_tpu_torch import pipeline
        self.torch, self.pipeline = torch, pipeline
        self.device = device
        self.egc = edge_graph_config(cell["config"])
        # every key of the traffic file is an argument of run_pipeline:
        # one it does not take raises
        self.kw = dict(cell["traffic"])
        self.kw["stages"] = tuple(self.kw["stages"])

    def sync(self):
        if self.device != "cpu":
            self.torch.cuda.synchronize()

    def __call__(self, scene):
        stats = self.pipeline.PipelineStats()
        out = self.pipeline.run_pipeline(
            program_scene(scene), scene.edge_images.copy(), self.egc,
            stats=stats, device=self.device, **self.kw)
        self.sync()
        return out, stats


def window(runner, scene, seconds: float, trace: bool):
    """Whole scenes back to back until one finishes at or after `seconds`
    of scene time.  Returns (scenes, failed, wall_s, traces); each scene is
    (output or None, stats dict, wall_s)."""
    traces, scenes, failed = [], [], 0
    if trace:
        from torch.profiler import ProfilerActivity, profile, \
            record_function

        from h100bench import devtrace
        acts = [ProfilerActivity.CPU]
        if runner.device != "cpu":
            acts.append(ProfilerActivity.CUDA)
    t_start = time.perf_counter()
    busy = 0.0

    def more():
        """Until `seconds`; traced, also until a trace holds a CUDA-side
        entry (the profiler now and then returns a trace without any),
        for at most EXTRA_TRACED more scenes."""
        if len(scenes) >= MAX_SCENES:
            return False
        if busy < seconds:
            return True
        return (trace and not any(t.n_device for t in traces)
                and len(scenes) < n_timed + EXTRA_TRACED)
    n_timed = 0
    while more():
        if busy < seconds:
            n_timed += 1
        t0, c0 = time.perf_counter(), time.process_time()
        prof = None
        try:
            if trace:
                with profile(activities=acts) as prof:
                    with record_function(devtrace.MARK):
                        out, stats = runner(scene)
                    wall = time.perf_counter() - t0
            else:
                out, stats = runner(scene)
                wall = time.perf_counter() - t0
            scenes.append((out, dict(timings=dict(stats.timings),
                                     cpu_s=time.process_time() - c0), wall))
        except Exception as exc:  # a scene that raises counts as failed
            import traceback
            traceback.print_exc()
            log(f"scene {len(scenes)} failed: {exc!r}")
            failed += 1
            wall = time.perf_counter() - t0
            scenes.append((None, None, wall))
        if trace and scenes[-1][0] is not None:
            traces.append(devtrace.reduce_profile(prof))
        del prof
        busy += wall
    return scenes, failed, time.perf_counter() - t_start, traces


def judge(cell, scene, scenes, failed):
    """(correct, rows): every scene of the window against the reference,
    each number beside its limit (the worst over the scenes)."""
    from h100bench import reference
    limits = {k: v for k, v in cell["limits"].items() if k != "readings"}
    g = cell["config"]["guarantees"]
    limits["mse_px2"] = g["filter_gn_max_mse"] * (
        1 + reference.F32_GATE_SLACK)
    limits["min_views"] = g["filter_min_views"] + 1
    limits["unclaimed"] = 0
    worst, diag = {}, []
    for out, stats, wall in scenes:
        if out is None:
            continue
        nums = reference.judge_numbers(scene, reference.output_of(out), g)
        big = sorted(stats["timings"].items(), key=lambda kv: -kv[1])[:6]
        diag.append(dict(wall_s=wall, cpu_s=stats["cpu_s"],
                         spans_s=dict(big),
                         edge_points=nums["edge_points"],
                         coverage=nums["coverage"],
                         med_dist3d=nums["med_dist3d"],
                         ref_last_move=nums["ref_last_move"]))
        for name, v, lim, ok in reference.verdict(nums, limits):
            if name not in worst or reference.worse(name, v,
                                                    worst[name][0]):
                worst[name] = (v, lim, ok)
    rows = [(n, v, lim, ok) for n, (v, lim, ok) in worst.items()]
    done = sum(out is not None for out, _, _ in scenes)
    rows.append(("scenes_failed", failed, 0, failed == 0))
    rows.append(("scenes_judged", done, 1, done >= 1))
    return all(r[3] for r in rows), rows, diag


def run(cell: dict, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float = T0) -> dict:
    """One run of `cell`; returns the result line's object."""
    import torch

    from h100bench import scenes as scenes_mod
    marks = [("imports", time.time())]
    if device != "cpu":
        from edgegraph3d_tpu_torch import kernels
        kernels.build(verbose=False)
    runner = Runner(cell, device)
    marks.append(("kernels", time.time()))
    conf = cell["config"]
    scene = scenes_mod.make(conf["scene"], seed)
    marks.append(("scene", time.time()))
    # the warm-up is one pass of the cell's own scene: after a smaller
    # scene the first full one ran 40% slow (PERF.md)
    runner(scene)
    if trace and device != "cpu":
        # the profiler's first session on the card starts CUPTI, which
        # took about 10 s inside the first traced scene
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize()
    marks.append(("warm-up", time.time()))
    log("set-up s: " + ", ".join(
        f"{n} {b - a:.3f}" for (_, a), (n, b) in zip(
            [("start", t_start)] + marks, marks)))
    setup_peak = 0
    if device != "cpu":
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - t_start

    scenes, failed, wall, traces = window(runner, scene, seconds, trace)
    done = sum(out is not None for out, _, _ in scenes)
    peak = 0
    if device != "cpu":
        peak = torch.cuda.max_memory_allocated()
    t_judge = time.perf_counter()
    correct, rows, diag = judge(cell, scene, scenes, failed)
    log(f"reference s: {time.perf_counter() - t_judge:.3f} for "
        f"{len(diag)} scenes; window s: {wall:.3f}")

    record = dict(scenes=[s for _, s, _ in scenes if s is not None],
                  traces=[t for t in traces if t.n_device > 0], root=ROOT,
                  window_s=wall, done=done)
    metrics = {}
    if trace:
        for m in cell["per_layer"]:
            v = load_reader(m["name"]).read(record)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    else:
        e2e = dict(scene_s=wall / done if done else None,
                   peak_mem_gib=peak / 2 ** 30, setup_s=setup_s)
        for m in cell["end_to_end"]:
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = dict(value=e2e[m["name"]],
                                          unit=m["unit"])
    dev = dict(platform="gpu" if device != "cpu" else "cpu",
               kind=(torch.cuda.get_device_name(0) if device != "cpu"
                     else "cpu"),
               count=cell["chips"], memory_peak_bytes=max(peak, setup_peak))
    result = dict(correct=correct, attempted=len(scenes), failed=failed,
                  metrics=metrics, device=dev)
    if trace:
        from h100bench import devtrace
        used = record["traces"]
        dev["busy_s"] = sum(t.busy_s for t in used)
        dev["window_s"] = sum(t.window_s for t in used)
        result["breakdown"] = devtrace.breakdown(used)
    result["checks"] = {n: dict(value=v, limit=lim, ok=ok)
                        for n, v, lim, ok in rows}
    result["_diag"] = diag
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs only on the card")
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        log(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
            f"{cell['chips']}")
        return 3
    result = run(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package loaded: {found}")
        return 4
    diag = result.pop("_diag")
    print("scenes: " + json.dumps(diag))
    print("host: " + json.dumps(dict(cpu_count=os.cpu_count(),
                                     torch_threads=torch.get_num_threads())))
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['ok'] else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
