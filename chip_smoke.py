"""GPU smoke test of the PyTorch / CUDA port (edgegraph3d_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU (an H100: the kernels are built for sm_90a) and nvcc.
Phases, each of which must pass or the script exits non-zero without
its final `ok` line:

  1. card and build: the card's name and power limit, then the four
     hand-written kernels built from edgegraph3d_tpu_torch/csrc;
  2. kernel vs plain torch on the card, at the main path's full-scale
     shapes (49 views at 1600x1200): decisions (ids / valid / alive)
     may differ on at most 1e-4 of the rows (0 expected: the kernels are
     built with --fmad=false and follow the twins' operation order),
     coordinates must agree within 1e-3 px (3D points 1e-4 relative);
  3. the stage-3 main path (`run_pipeline(stages=(3,), device="cuda")`)
     on the benchmark's 8-view cube trend workload;
  4. the same main path on the 49-view 1600x1200 full-scale workload
     (6,268 refpoints, every viewing camera starts), with each kernel's
     launch count, which must be > 0;
  5. quality gates for phases 3 and 4: edge_points > 0, coverage >= 0.9
     and med_dist3d <= 0.01.

Prints one JSON line of per-kernel results and, as its last line,
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# full-scale workload (the benchmark's build_full_workload)
FULL_VIEWS, FULL_REFPOINTS, WIDTH, HEIGHT = 49, 6268, 1600, 1200
DECISION_TOL = 1e-4          # fraction of rows whose decisions may differ
COORD_TOL_PX = 1e-3
KERNEL_META = {
    "grid_topm_query": ("edgegraph3d_tpu_torch/csrc/grid_topm.cu",
                        "edgegraph3d_tpu/matching/detection.py:96"),
    "epipolar_topm_query": ("edgegraph3d_tpu_torch/csrc/epipolar_topm.cu",
                            "edgegraph3d_tpu/matching/detection.py:116"),
    "triangulate_gn": ("edgegraph3d_tpu_torch/csrc/triangulate_gn.cu",
                       "edgegraph3d_tpu/ops/triangulation.py:174"),
    "follow_walk": ("edgegraph3d_tpu_torch/csrc/follow_walk.cu",
                    "edgegraph3d_tpu/matching/following.py:296"),
}


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    log(f"FAIL: {msg}")
    sys.exit(1)


def cuda_time(fn, reps: int):
    """Mean ms per call of fn() on the current stream (after one warmup
    call whose result is returned)."""
    import torch
    out = fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1) / reps


def full_scene(n_refpoints=FULL_REFPOINTS):
    from edgegraph3d_tpu_torch.core import synthetic
    return synthetic.make_dtu_scale_scene(
        n_cams=FULL_VIEWS, n_refpoints=n_refpoints, width=WIDTH,
        height_px=HEIGHT, focal=2.2 * WIDTH / 1.6)


def cube8_scene():
    from edgegraph3d_tpu_torch.core import synthetic
    return synthetic.make_cube_scene(
        n_cams=8, n_refpoints_per_edge=48, width=WIDTH, height_px=HEIGHT,
        focal=2.2 * WIDTH / 1.6, seed=0)


def bench_config():
    """The benchmark's configuration: audited budgets, 32-step walks
    with continuation rounds."""
    from edgegraph3d_tpu_torch.config import EdgeGraphConfig
    return EdgeGraphConfig().replace(max_follow_steps=32)


# ----------------------------------------------------------------------
# phase 2: kernels against their plain twins
# ----------------------------------------------------------------------

def _cand_diff(a, b):
    """(decision-mismatch rows, max coordinate error on agreeing valid
    entries) of two Candidates."""
    import torch
    bad = ((a.pl_id != b.pl_id) | (a.seg != b.seg)
           | (a.valid != b.valid)).any(1)
    good = (~bad)[:, None] & a.valid
    err = 0.0
    if good.any():
        err = max(float((a.xy - b.xy).abs()[good].max()),
                  float((a.dist - b.dist).abs()[good].max()))
    return int(bad.sum()), err, int(a.valid.shape[0])


def compare_kernels(ctx, sfmd):
    import torch

    from edgegraph3d_tpu_torch.matching import detection, following
    from edgegraph3d_tpu_torch.matching import refpoints as rp
    from edgegraph3d_tpu_torch.ops import triangulation
    from edgegraph3d_tpu_torch.ops.geometry import epipolar_line

    cfg = ctx.config
    dev = ctx.device
    M = cfg.max_candidates_per_view
    obs_xy, obs_mask = rp.dense_observations(sfmd)
    N, V = obs_mask.shape
    results = {}

    def record(name, mism, rows, err, ms, plain_ms, err_tol, gated=None):
        """`gated` is the error held against err_tol (default: err)."""
        gated = err if gated is None else gated
        log(f"  {name}: rows={rows} decision_mismatches={mism} "
            f"max_abs_err={err:.3g} gated_err={gated:.3g} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f}")
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        if mism > DECISION_TOL * rows:
            fail(f"{name}: {mism} of {rows} rows differ in a decision")
        if gated > err_tol:
            fail(f"{name}: coordinate error {gated} > {err_tol}")

    # K1 at the _start_sweep shape: every (refpoint, view), M=4, 10 px
    ox = torch.as_tensor(obs_xy, device=dev)
    view = torch.arange(V, dtype=torch.int32, device=dev).repeat(N)
    pts = ox.reshape(N * V, 2)
    args = (ctx.grids, view, pts, ctx.cell, cfg.detection_starting_dist_px,
            M)
    got, ms = cuda_time(lambda: detection.grid_topm_query(*args), 10)
    ref, pms = cuda_time(lambda: detection._grid_topm_plain(*args), 1)
    mism, err, rows = _cand_diff(got, ref)
    record("grid_topm_query", mism, rows, err, ms, pms, COORD_TOL_PX)

    # K2 at the _seed_from_starts shape: the starts of one refpoint
    # chunk (1,024 refpoints, every viewing camera) x all views
    lo, hi = 0, min(1024, N)
    om = torch.as_tensor(obs_mask[lo:hi], device=dev)
    oxc = ox[lo:hi]
    starts = rp._start_sweep(ctx, oxc, om, cfg.detection_starting_dist_px, M)
    K = len(starts["ridx"])
    vs = starts["vs"]
    lines = epipolar_line(ctx.F_table[vs], starts["xy"][:, None, :])
    radius = torch.clamp_min(torch.clamp_max(starts["dist"] * 3.0, 30.0),
                             3.0).repeat_interleave(V)
    view2 = torch.arange(V, dtype=torch.int32, device=dev).repeat(K)
    args2 = (ctx.grids, view2, oxc[starts["ridx"]].reshape(K * V, 2),
             lines.reshape(K * V, 3), radius, ctx.cell, M)
    got, ms = cuda_time(lambda: detection.epipolar_topm_query(*args2), 5)
    ref, pms = cuda_time(lambda: detection._epipolar_topm_plain(*args2), 1)
    mism, err, rows = _cand_diff(got, ref)
    record("epipolar_topm_query", mism, rows, err, ms, pms, COORD_TOL_PX)

    # K3, O=3 cold start (seed pairs / post-walk GN) and O=V warm start
    # (the expansion GN), on triangulatable rows built from the scene
    gen = torch.Generator(device=dev).manual_seed(0)
    pts3 = torch.as_tensor(sfmd.points, dtype=torch.float32, device=dev)
    k3_err, k3_rel, k3_mism, k3_rows, k3_ms, k3_pms = 0.0, 0.0, 0, 0, 0.0, 0.0
    for O, warm, iters, accept in ((3, False, cfg.gn_max_iters, 9.0),
                                   (V, True, cfg.follow_gn_iters, 9.0)):
        n = 1 << 20 if O == 3 else 1 << 18
        rnd = lambda *s: torch.rand(*s, generator=gen, device=dev)
        nrm = lambda *s: torch.randn(*s, generator=gen, device=dev)
        Xg = pts3[(rnd(n) * len(pts3)).long().clamp_max(len(pts3) - 1)]
        cams = torch.argsort(rnd(n, V), dim=1)[:, :O].to(torch.int32)
        Pg = ctx.P_mats[cams.long()]                       # [n,O,3,4]
        pr = (Pg[..., :3] * Xg[:, None, None, :]).sum(-1) + Pg[..., 3]
        xy = pr[..., :2] / pr[..., 2:3] + nrm(n, O, 2)
        xy[:, 0] += 25.0 * (rnd(n) < 0.2)[:, None]     # gross outliers
        mask = rnd(n, O) < (1.0 if O == 3 else 0.3)
        mask[:, :3] = True
        a = (ctx.P_mats, cams, xy.contiguous(), mask)
        X0 = (Xg + 0.01 * nrm(n, 3)) if warm else None
        del Pg, pr
        (Xk, _, okk), ms = cuda_time(lambda: triangulation.triangulate_gn(
            *a, X0=X0, max_iters=iters, accept_mse=accept), 5)
        (Xp, _, okp), pms = cuda_time(
            lambda: triangulation._triangulate_gn_plain(
                *a, X0, iters, cfg.gn_epsilon, accept, 1e-5), 1)
        both = okk & okp
        diff = (Xk - Xp).abs()[both]
        rel = diff / Xp.abs().clamp_min(1e-3)[both]
        log(f"  triangulate_gn O={O} warm={warm}: rows={n} "
            f"valid={int(okp.sum())} kernel_ms={ms:.4f} plain_ms={pms:.4f}")
        if len(diff):
            k3_err = max(k3_err, float(diff.max()))
            k3_rel = max(k3_rel, float(rel.max()))
        k3_mism += int((okk != okp).sum())
        k3_rows += n
        k3_ms += ms
        k3_pms += pms
    record("triangulate_gn", k3_mism, k3_rows, k3_err, k3_ms, k3_pms, 1e-4,
           gated=k3_rel)

    # K4 at the follow shape: the chunk's seeds, both driving
    # directions, after direction resolution, max_follow_steps steps
    seeds = rp._seed_from_starts(ctx, starts, oxc, om, M)
    st = rp._seed_tuple(seeds)
    S = len(st.cams)
    both = following.SeedTuple(*[torch.cat([a, a]) for a in st])
    drive = torch.cat([torch.ones(S, dtype=torch.int32, device=dev),
                       -torch.ones(S, dtype=torch.int32, device=dev)])
    perm, dirs, dok = following.resolve_configuration(
        both, ctx.plg_coords, ctx.plg_length, ctx.P_mats, ctx.F_table,
        drive, cfg)
    P_ = following._permute
    wargs = (ctx.plg_coords, ctx.plg_length, ctx.F_table,
             P_(both.cams, perm), P_(both.pl_id, perm), P_(both.seg, perm),
             P_(both.t, perm), P_(both.xy, perm), dirs, dok,
             cfg.max_follow_steps, cfg.follow_first_image_dist_px,
             cfg.follow_min_dist_px, cfg.follow_max_dist_px,
             cfg.quasiparallel_cos, cfg.quasiparallel_dist_px)
    got, ms = cuda_time(lambda: following.follow_walk(*wargs), 10)
    ref, pms = cuda_time(lambda: following._walk_plain(*wargs), 1)
    live = ref.alive & got.alive
    bad = ((got.alive != ref.alive).any(1)
           | ((got.seg != ref.seg).any(-1) & live).any(1))
    err = float((got.obs - ref.obs).abs()[live].max()) if live.any() else 0.0
    log(f"  follow_walk: lanes={2 * S} live_steps={int(ref.alive.sum())}")
    record("follow_walk", int(bad.sum()), 2 * S, err, ms, pms, COORD_TOL_PX)
    return results


# ----------------------------------------------------------------------
# phases 3-4: the main path
# ----------------------------------------------------------------------

def run_main_path(name, scene, max_starting_views):
    import torch

    from edgegraph3d_tpu_torch import kernels
    from edgegraph3d_tpu_torch.pipeline import PipelineStats, run_pipeline
    from edgegraph3d_tpu_torch.quality import quality_metrics

    sfmd, edges, curves = scene
    stats = PipelineStats()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.time()
    out = run_pipeline(sfmd, edges, bench_config(),
                       max_starting_views=max_starting_views, stats=stats,
                       stages=(3,), device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    qual = quality_metrics(out, sfmd, curves)
    log(stats.report())
    log(f"{name}: views={sfmd.n_cameras} refpoints={sfmd.n_points} "
        f"max_starting_views={max_starting_views or 'all'} wall_s={wall:.3f} "
        f"views_per_s={sfmd.n_cameras / wall:.4f} "
        f"max_memory_allocated_bytes={peak}")
    log(f"{name} quality: {json.dumps(qual)}")
    log(f"{name} launches: {json.dumps(launches)}")
    if qual["edge_points"] == 0 or not qual["coverage"] >= 0.9 \
            or not qual["med_dist3d"] <= 0.01:
        fail(f"{name}: quality gate (edge_points > 0, coverage >= 0.9, "
             f"med_dist3d <= 0.01) not met: {qual}")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA GPU: the port's smoke test runs only on the card")
    if not os.path.isdir(os.path.join(HERE, "edgegraph3d_tpu_torch")):
        fail("edgegraph3d_tpu_torch/ not found beside chip_smoke.py")
    sys.path.insert(0, HERE)
    from edgegraph3d_tpu_torch import kernels
    from edgegraph3d_tpu_torch.matching import refpoints as rp
    from edgegraph3d_tpu_torch.plgs.extraction import extract_plgs

    t_start = time.time()
    log("== phase 1: card and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    t0 = time.time()
    kernels.build(verbose=False)
    kernels.lib()
    log(f"kernels built in {time.time() - t0:.1f}s: {kernels.LIB_PATH}")

    log("== phase 2: kernels vs plain torch at full-scale shapes")
    t0 = time.time()
    full = full_scene()
    log(f"full-scale scene: {full[0].n_cameras} views, "
        f"{full[0].n_points} refpoints ({time.time() - t0:.1f}s)")
    cfg = bench_config()
    stack = extract_plgs(full[1], cfg)
    ctx = rp.build_context(full[0], stack, cfg, device="cuda")
    log(f"grids {tuple(ctx.grids.shape)}, polylines "
        f"{tuple(ctx.plg_coords.shape)}")
    results = compare_kernels(ctx, full[0])
    del ctx
    torch.cuda.empty_cache()

    log("== phase 3: main path, cube8 trend workload")
    run_main_path("cube8", cube8_scene(), 2)

    log("== phase 4: main path, full-scale workload")
    launches = run_main_path("full", full, None)
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        fail(f"kernels not launched on the main path: {missing}")

    kern = [dict(name=k, route="cuda", source=KERNEL_META[k][0],
                 replaces=KERNEL_META[k][1], launches=launches[k],
                 max_abs_err=results[k]["max_abs_err"],
                 ms=results[k]["ms"], plain_ms=results[k]["plain_ms"])
            for k in kernels.KERNEL_NAMES]
    log(f"total smoke wall {time.time() - t_start:.1f}s")
    log(json.dumps({"kernels": kern}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
