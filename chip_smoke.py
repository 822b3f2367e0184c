"""GPU smoke test of the PyTorch / CUDA port (edgegraph3d_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU (an H100: the kernels are built for sm_90a) and nvcc.
Phases, each of which must pass or the script exits non-zero without
its final `ok` line:

  1. card and build: the card's name and power limit, then the eight
     hand-written kernels built from edgegraph3d_tpu_torch/csrc (one nvcc
     per source, all started together);
  2. kernel vs plain torch on the card, at the main path's full-scale
     shapes (49 views at 1600x1200): decisions (ids / valid / alive)
     may differ on at most 1e-4 of the rows (0 expected: the kernels are
     built with --fmad=false and follow the twins' operation order),
     coordinates must agree within 1e-3 px (3D points 1e-4 relative).
     K1 is also timed as its launch alone into preallocated outputs and
     by its device time (a torch.profiler trace), in the view-by-view
     order the main path's callers ask for and in the caller's order.
     K2's launch alone runs in its 8-lane body and its one-thread body
     (the one K7's "epipolar" mode runs, and K2's design before that) on
     the queries in the caller's, the view and the (view, cell) order,
     each identical to the wrapper's result.  K3 runs its O = 3 register
     body and its general body (O = 49, 30% of the observations present
     at random), with the mean GN iterations and the mean of each warp's
     slowest row logged; K4 runs both launches of one follow_seeds call
     on the first refpoint chunk's seeds (the direction trials, GN warm
     from the seed, T = 1; the walk, DLT + GN, max_follow_steps), each
     against its plain twin (the walk, the GN over the live steps, the
     cut at the first GN failure) with 0 decision mismatches allowed and
     X within 1e-4 relative.  K5 gather_rows must be bit-equal to
     `table[rows]` at the Pallas probe's shape (int32 indices) and at
     the chain-extension shape (int64), both timed over 200 calls per
     event pair, with K5's launch alone and both device times; K6
     group_seed_sample runs on the full scene's stage-1 match sets, with
     0 decision mismatches allowed.
     K7 expand_chains runs the whole expansion of the full scene's
     stage-3 chains and of the first chain-extension round's chains, in
     the chunks refpoints.chain_chunks makes, in one launch per chunk
     (the wrapper's way) and, for comparison, in one launch per tile
     bucket (each chunk cut at its bucket edges), each bit-equal to its
     plain version (the old per-view loop around K1 and K3, so its time
     is the old path's), and alone on the chunk the one-warp-per-chain
     design was timed on (the first 4,096 stage-3 chains).  The
     full-scale similarity graph built on the card (f64 products) must
     have the host build's edges, with weights within 1e-5 relative (the
     count of unequal weights is printed), and its stage-1 match sets
     must equal those of
     the host build with label propagation on the CPU; label
     propagation's bucket sums must be bit-equal on the card and the CPU
     (the ordered sums that keep its tie rule).  Last, the large-table
     check: K3's general body at 1,100 and 5,000 cameras, K6 with 128 and
     460 members, K7 in "epipolar" mode at 400 and in "closest" mode at
     5,000 cameras (tiled cameras), each against its plain version with
     0 decision mismatches (K7 bit-equal), each launch's table placement
     logged and required to be the one kernels.table_placement gives on
     an H100;
  3. the main path on the benchmark's 8-view cube trend workload:
     stage 3 alone (`run_pipeline(stages=(3,))`), the default stages
     (1, 2, 3) through the file entry `edge_matching` on files written
     to a temporary directory, and the default stages with
     closeness_max_dist_ratio=1e6, which must make stage-2 match sets;
  4. the default stages (1, 2, 3) on the 49-view 1600x1200 full-scale
     workload (6,268 refpoints, every viewing camera starts), with a
     working folder: stage-1 match sets and stage-1 points > 0, and the
     launch count of each of the seven main-path kernels K1-K7, which
     must be > 0 (K7's calls are logged with their chains by tile
     bucket; K8 runs only with joint BA);
  5. quality gates for phases 3, 4 and 6: edge_points > 0,
     coverage >= 0.9 and med_dist3d <= 0.01;
  6. the optional paths, after phase 4.  Joint BA on the full scene's
     augmented scene (phase 4's before_filtering.json, written in phase
     4's working folder; phase 4's views_per_s leaves that writing out),
     from a seeded perturbation of it (BA_PERTURB): K8 ba_blocks's
     step-1 outputs and the Schur system S and rhs against the plain
     version (within BA_BLOCK_TOL of each array's largest magnitude),
     then 3 LM steps with K8 and 3 plain steps, each lowering the MSE,
     with K8 launched 3 times, and the final cameras and points held
     together (BA_CAM_TOL; BA_X_TOL of how far the points moved); both
     checks must also reject K8's outputs with gx zeroed and with gx
     negated; K8 runs with the observation index built once, as ba_run
     builds it; logged: N, the index's build time, each step's wall,
     K8's wrapper (with the index and building its own), its launch
     alone, each of its kernels' device time and its bound, the margins
     of its two decisions, the S matmul's and the solve's times,
     max_memory_allocated, and the --time-k8 line below for this
     checkout, run in a fresh process.  Device claiming: stage 3 of the full
     scene (with expansion and chain extension) with claiming_backend
     "device" and "host", bit-equal points, equal counts and counters
     (but the device backend's own), and no fallback to the host pass;
     the chunks, their fixpoint rounds and both stage3_refpoints times
     are logged.  The LMedS F
     table of the full scene: its time, and the median epipolar
     distance of the refpoint observations under it (< 0.5 px) and
     under the exact table.  Last, cube8 through run_pipeline with
     fmat_source="lmeds" and ba_steps=2 (K8 launched twice), under the
     quality gates.

Each kernel's bound is the larger of the bytes it must move (each input
read once, each output written once) over 3.35 TB/s and its f32
operations over 67 TFLOP/s (an H100 SXM's published peaks), both counted
from this run's inputs with the per-item costs in FLOPS below.

Prints one JSON line of per-kernel results and, as its last line,
{"ok": true, "device": {...}}.  Imports nothing of JAX.

    python3 chip_smoke.py --time-k7-chunk ROOT

times K7 alone on that 4,096-chain chunk with this script's `cuda_time`
for the port checkout at ROOT (e.g. an unpacked `git archive` of an
earlier commit), so that two versions of K7 are timed with one yardstick
in one call; it prints one JSON line and skips every check.

    python3 chip_smoke.py --time-follow ROOT

does the same for K3 (phase 2's two shapes) and the follow (one
follow_seeds call on phase 2's seeds, and each of its K4 launches).

    python3 chip_smoke.py --time-k1-k6 ROOT

does the same for K1 (its wrapper, its launch alone into preallocated
outputs and its device time, at phase 2's M = 4 shape) and K6 (its
wrapper and device time on the first 64 stage-1 match sets).

    python3 chip_smoke.py --time-k8 ROOT

does the same for K8 on a seeded problem of phase 6's shape (K8_SHAPE:
61,008 points, 49 views, dense, ~34.5 views a point): the observation
index's build, the wrapper, its launch alone into preallocated outputs,
each CUDA entry's device time and one LM step's wall; it needs no phase
4, so an earlier checkout and this one compare in one call.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# full-scale workload (the benchmark's build_full_workload)
FULL_VIEWS, FULL_REFPOINTS, WIDTH, HEIGHT = 49, 6268, 1600, 1200
DECISION_TOL = 1e-4          # fraction of rows whose decisions may differ
COORD_TOL_PX = 1e-3
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12       # H100 SXM f32, outside the tensor cores
#: f32 operations per item of work, counted from the kernels' arithmetic:
#: a grid entry tested by K1 / K2, a GN iteration (per observation and per
#: solve), a DLT (per observation and the 4x4 solve), a walk step of K4,
#: a sampling step and a segment-line test of K6, a present observation
#: of K8 (residual and Jacobians ~87, Hxx 36, gx 12, Hxc 72, Hcc 144,
#: gc 24, A of its view 90, its rhs term 36) and a point of K8 (the
#: damped 3x3 inverse)
FLOPS = dict(grid_entry=21, epipolar_entry=35, gn_obs=85, gn_iter=70,
             dlt_obs=80, dlt_solve=200, walk_step=350, sample_step=30,
             crossing_seg=25, line=20, ba_obs=500, ba_point=50)
KERNEL_META = {
    "grid_topm_query": ("edgegraph3d_tpu_torch/csrc/grid_topm.cu",
                        "edgegraph3d_tpu/matching/detection.py:96"),
    "epipolar_topm_query": ("edgegraph3d_tpu_torch/csrc/epipolar_topm.cu",
                            "edgegraph3d_tpu/matching/detection.py:116"),
    "triangulate_gn": ("edgegraph3d_tpu_torch/csrc/triangulate_gn.cu",
                       "edgegraph3d_tpu/ops/triangulation.py:174"),
    "follow_walk": ("edgegraph3d_tpu_torch/csrc/follow_walk.cu",
                    "edgegraph3d_tpu/matching/following.py:296"),
    "gather_rows": ("edgegraph3d_tpu_torch/csrc/gather_rows.cu",
                    "tools/pallas_probe.py:145"),
    "group_seed_sample": ("edgegraph3d_tpu_torch/csrc/group_seed_sample.cu",
                          "edgegraph3d_tpu/matching/polyline_stages.py:434"),
    "expand_chains": ("edgegraph3d_tpu_torch/csrc/expand_chains.cu",
                      "edgegraph3d_tpu/matching/expansion.py:361"),
    "ba_blocks": ("edgegraph3d_tpu_torch/csrc/ba_blocks.cu",
                  "edgegraph3d_tpu/ops/ba.py:82"),
}


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    log(f"FAIL: {msg}")
    sys.exit(1)


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""


def cuda_time(fn, reps: int, warmup: bool = True, warm_s: float = 0.25):
    """Mean ms per call of fn() on the current stream.  Unless warmup is
    False, fn() first runs for at least warm_s seconds of wall (the
    first call's result is returned): the card idles through the host
    phases, and its clocks need that long of work to rise."""
    import torch
    out = None
    if warmup:
        out = fn()
        torch.cuda.synchronize()
        t0 = time.time()
        while time.time() - t0 < warm_s:
            fn()
            torch.cuda.synchronize()
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


def bound(n_bytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    f32 operations over the f32 peak."""
    t_b = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_f = flops / PEAK_F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def grid_work(grids, view, pts, cell, radius_cells):
    """(valid entries tested, distinct cell ids) of grid queries over the
    (2r+1)^2 cells around each point, clipped as K1 / K2 clip them."""
    import torch
    V, GH, GW, Kc, _ = grids.shape
    q = torch.nan_to_num(pts / cell, nan=0.0).clamp(-1e9, 1e9).trunc().long()
    offs = torch.arange(-radius_cells, radius_cells + 1, device=pts.device)
    xx = (q[:, 0:1].clamp(0, GW - 1) + offs).clamp(0, GW - 1)
    yy = (q[:, 1:2].clamp(0, GH - 1) + offs).clamp(0, GH - 1)
    cid = ((view.long()[:, None, None] * GH + yy[:, :, None]) * GW
           + xx[:, None, :]).reshape(-1)
    per_cell = (grids[..., 0] >= 0).sum(-1).reshape(-1)
    return int(per_cell[cid].sum()), torch.unique(cid)


def gn_iterations(P_mats, cams, xy, mask, X0, max_iters, epsilon, accept,
                  warps=128):
    """(mean, mean per-warp maximum) of the GN iterations a point runs
    before it freezes or turns singular, on `warps` runs of 32
    consecutive rows (a warp's rows in a one-thread-per-row launch),
    evenly spaced: the plain solver's result after k iterations equals
    its final one from k = first on, and the point runs min(first + 1,
    max_iters) iterations.  A warp runs as long as its slowest row."""
    import torch

    from edgegraph3d_tpu_torch.ops import triangulation
    n = mask.shape[0]
    if n == 0:
        return 0.0, 0.0
    dev = mask.device
    lo = torch.arange(0, n, max(32, n // warps), device=dev)[:warps]
    idx = (lo[:, None] + torch.arange(32, device=dev)).reshape(-1)
    grp = torch.arange(len(idx), device=dev) // 32
    grp, idx = grp[idx < n], idx[idx < n]
    a = (P_mats, cams[idx], xy[idx], mask[idx])
    X0s = None if X0 is None else X0[idx]
    run = lambda k: triangulation._triangulate_gn_plain(
        *a, X0s, k, epsilon, accept, 1e-5)
    Xf, mf, _ = run(max_iters)
    first = torch.full((len(idx),), max_iters, device=dev)
    for k in range(max_iters - 1, -1, -1):
        Xk, mk, _ = run(k)
        same = (Xk == Xf).all(1) & (mk == mf)
        first = torch.where(same, k, first)
    its = (first + 1).clamp_max(max_iters).float()
    warp_max = torch.zeros(int(grp[-1]) + 1, device=dev).scatter_reduce(
        0, grp, its, "amax", include_self=False)
    return float(its.mean()), float(warp_max.mean())


def gn_flops(mask, iters, cold):
    """f32 operations of GN (and DLT when cold) over the live
    observations of every row, at `iters` mean iterations."""
    live = float(mask.sum())
    rows = mask.shape[0]
    f = iters * (FLOPS["gn_obs"] * live + FLOPS["gn_iter"] * rows)
    if cold:
        f += FLOPS["dlt_obs"] * live + FLOPS["dlt_solve"] * rows
    return f


def record_into(results, name, mism, rows, err, ms, plain_ms, err_tol,
                gated=None, exact=False, work=(0.0, 0.0), library_ms=None):
    """Log and gate one kernel's comparison.  `gated` is the error held
    against err_tol (default: err); `exact` allows no decision mismatch
    at all (else DECISION_TOL of the rows); `mism` None: the kernel's
    decisions are not among its outputs, and none is compared.  `work`
    is (bytes, f32 operations) for the bound."""
    gated = err if gated is None else gated
    bound_ms, bound_by = bound(*work)
    log(f"  {name}: rows={rows} decision_mismatches="
        f"{'not compared' if mism is None else mism} "
        f"max_abs_err={err:.3g} gated_err={gated:.3g} kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bytes={work[0]:.6g} flops={work[1]:.6g} "
        f"bound_ms={bound_ms:.6f} ({bound_by})"
        + ("" if library_ms is None else f" library_ms={library_ms:.4f}"))
    results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library_ms)
    if mism is not None and mism > (0 if exact else DECISION_TOL * rows):
        fail(f"{name}: {mism} of {rows} rows differ in a decision")
    if gated > err_tol:
        fail(f"{name}: coordinate error {gated} > {err_tol}")


def device_ms_by_kernel(fn, reps: int, pattern: str) -> dict:
    """{kernel: mean device ms per call of fn()} for every CUDA entry of
    one torch.profiler trace of `reps` calls (kernels, memsets, copies),
    each named by its match of the regular expression `pattern`, or by
    its first 48 characters."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(pattern, e.key)
            name = m.group(0) if m else e.key[:48]
            t = getattr(e, "self_device_time_total", None)
            t = float(t if t is not None else e.self_cuda_time_total)
            out[name] = out.get(name, 0.0) + t / 1e3 / reps
    if not out:
        log("  device_ms_by_kernel: the trace holds no CUDA entry")
    return out


def device_ms(fn, reps: int, name) -> float:
    """Mean device time per call of fn() of the CUDA kernels whose name
    holds `name` (or one of a tuple of names), from one trace of
    device_ms_by_kernel."""
    import re
    names = (name,) if isinstance(name, str) else tuple(name)
    times = device_ms_by_kernel(fn, reps, "|".join(map(re.escape, names)))
    ms = sum(v for k, v in times.items() if k in names)
    if ms == 0.0:
        log(f"  device_ms: no CUDA kernel named {names} in the trace; "
            f"its CUDA entries: {list(times)[:12]}")
    return ms


def k1_times(args, want):
    """K1 at one shape, its queries laid out as view = arange(V).repeat(N)
    (the main path's callers' layout), three ways: the wrapper
    (`wrapper_ms`, outputs allocated per call), its launch alone into
    preallocated outputs (`launch_ms`: the C entry through ctypes, as the
    wrapper calls it), and the kernel's device time from a profiler trace
    (`device_ms`); where the checkout's K1 takes the view-by-view order,
    the launch and device times in the caller's order too (`*_q_order`).
    Each launch's outputs must equal the wrapper's result `want`."""
    import torch

    from edgegraph3d_tpu_torch import kernels
    from edgegraph3d_tpu_torch.matching import detection
    grids, view, pts, cell, radius, M = args
    V, GH, GW, Kc, _ = grids.shape
    Q = len(view)
    out = detection._empty_outputs(Q, M, pts.device)
    ptrs = detection._out_ptrs(out)
    lib = kernels.lib()
    stream = kernels.stream_of(pts)
    ordered = len(kernels._SIGNATURES["eg3d_grid_topm"]) == 19

    def launch(n_rows):
        extra = (n_rows,) if ordered else ()
        kernels.check(lib.eg3d_grid_topm(
            grids.data_ptr(), V, GH, GW, Kc, view.data_ptr(), pts.data_ptr(),
            Q, float(cell), float(radius), M, *extra, *ptrs, stream),
            "grid_topm_query")

    wrap = (lambda: detection.grid_topm_query(*args, view_cycle=True)) \
        if ordered else (lambda: detection.grid_topm_query(*args))
    _, wrapper_ms = cuda_time(wrap, 50)
    res = dict(queries=Q, wrapper_ms=wrapper_ms)
    for key, n_rows in (("", Q // V), ("_q_order", 0)):
        if key and not ordered:
            break
        for t in out:
            t.fill_(7)                    # every slot must be rewritten
        _, res["launch_ms" + key] = cuda_time(lambda: launch(n_rows), 50)
        res["launch_identical" + key] = all(
            torch.equal(a, b) for a, b in zip(out, want))
        res["device_ms" + key] = device_ms(lambda: launch(n_rows), 20,
                                           "grid_topm")
    return res


def k2_variants(ctx, args2, want):
    """K2's launch alone in its 8-lane body and its one-thread body, on
    the queries as the caller issues them (start-major; the one-thread
    body in that order is K2's previous design), by view (the wrapper's
    order) and by (view, grid cell); each identical to the wrapper's
    result `want`.  The sorts are timed apart."""
    import torch

    from edgegraph3d_tpu_torch import kernels
    from edgegraph3d_tpu_torch.matching import detection

    grids, view, pts, lines, radius, cell, M = args2
    V, GH, GW, Kc, _ = grids.shape
    Q = len(view)
    cells = torch.nan_to_num(pts / cell).clamp(0, max(GH, GW) - 1).int()
    cell_key = (view * GH + cells[:, 1].clamp_max(GH - 1)) * GW \
        + cells[:, 0].clamp_max(GW - 1)
    sorts = {"view": lambda: detection._view_major_order(view, V),
             "view+cell": lambda: torch.argsort(cell_key, stable=True)
             .to(torch.int32)}
    orders = {"start-major": None}
    for name, sort in sorts.items():
        orders[name], ms = cuda_time(sort, 5)
        log(f"  epipolar_topm_query order by {name}: sort_ms={ms:.4f}")
    out = detection._empty_outputs(Q, M, pts.device)

    def launch(one_thread, order):
        rc = kernels.lib().eg3d_epipolar_topm(
            grids.data_ptr(), V, GH, GW, Kc, view.data_ptr(),
            pts.data_ptr(), lines.data_ptr(), radius.data_ptr(),
            None if order is None else order.data_ptr(), Q, float(cell), M,
            one_thread, 0, 0.0, *detection._out_ptrs(out),
            kernels.stream_of(pts))
        kernels.check(rc, "epipolar_topm_query")

    for lanes, one_thread in ((1, 1), (8, 0)):
        for name, order in orders.items():
            for t in out:
                t.fill_(7)                # every slot must be rewritten
            _, ms = cuda_time(lambda: launch(one_thread, order), 5)
            same = all(torch.equal(a, b) for a, b in zip(out, want))
            log(f"  epipolar_topm_query lanes_per_query={lanes} {name}: "
                f"launch_ms={ms:.4f} identical={same}")
            if not same:
                fail(f"epipolar_topm_query: {lanes} lanes per query, "
                     f"{name} order, differ from the wrapper's result")


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

    def record(*a, **kw):
        record_into(results, *a, **kw)

    # K1 at the _start_sweep shape: every (refpoint, view), M=4, 10 px
    ox = torch.as_tensor(obs_xy, device=dev)
    view = torch.arange(V, dtype=torch.int32, device=dev).repeat(N)
    pts = ox.reshape(N * V, 2)
    args = (ctx.grids, view, pts, ctx.cell, cfg.detection_starting_dist_px,
            M)
    got, ms = cuda_time(lambda: detection.grid_topm_query(
        *args, view_cycle=True), 10)
    ref, pms = cuda_time(lambda: detection._grid_topm_plain(*args), 1)
    mism, err, rows = _cand_diff(got, ref)
    k1 = k1_times(args, got)
    log(f"  grid_topm_query M={M}: {json.dumps(k1)}")
    if not all(v for k, v in k1.items() if k.startswith("launch_ident")):
        fail("grid_topm_query: the launch alone differs from the wrapper")
    Kc = ctx.grids.shape[3]
    entries, cells = grid_work(ctx.grids, view, pts, ctx.cell, 1)
    record("grid_topm_query", mism, rows, err, ms, pms, COORD_TOL_PX,
           work=(rows * (12 + 25 * M) + len(cells) * Kc * 24,
                 FLOPS["grid_entry"] * entries))

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
    k2_variants(ctx, args2, got)
    entries, cells = grid_work(ctx.grids, view2, args2[2], ctx.cell, 2)
    record("epipolar_topm_query", mism, rows, err, ms, pms, COORD_TOL_PX,
           work=(rows * (28 + 25 * M) + len(cells) * Kc * 24,
                 FLOPS["epipolar_entry"] * entries))

    # K3 at its main-path callers' shapes: O = 3 cold (seed pairs, the
    # register body) and O = V warm with 30% of the observations present
    # at random (the outlier filter's general body)
    k3 = dict(err=0.0, rel=0.0, mism=0, rows=0, ms=0.0, pms=0.0, bytes=0.0,
              flops=0.0)
    for O, warm in ((3, False), (V, True)):
        a, X0, iters, n = k3_inputs(ctx, sfmd, O, warm)
        accept = cfg.match_gn_max_mse
        (Xk, _, okk), ms = cuda_time(lambda: triangulation.triangulate_gn(
            *a, X0=X0, max_iters=iters, accept_mse=accept), 5)
        (Xp, _, okp), pms = cuda_time(
            lambda: triangulation._triangulate_gn_plain(
                *a, X0, iters, cfg.gn_epsilon, accept, 1e-5), 1)
        both = okk & okp
        diff = (Xk - Xp).abs()[both]
        rel = diff / Xp.abs().clamp_min(1e-3)[both]
        its, warp_its = gn_iterations(*a, X0, iters, cfg.gn_epsilon, accept)
        k3["bytes"] += V * 48 + n * O * 13 + (n * 12 if warm else 0) + n * 17
        k3["flops"] += gn_flops(a[3], its, cold=not warm)
        log(f"  triangulate_gn O={O} warm={warm} "
            f"({'registers' if O == 3 else 'live observations'}): rows={n} "
            f"valid={int(okp.sum())} mean_iterations={its:.4f} "
            f"mean_per_warp_max_iterations={warp_its:.4f} "
            f"decision_mismatches={int((okk != okp).sum())} "
            f"kernel_ms={ms:.4f} plain_ms={pms:.4f}")
        if len(diff):
            k3["err"] = max(k3["err"], float(diff.max()))
            k3["rel"] = max(k3["rel"], float(rel.max()))
        k3["mism"] += int((okk != okp).sum())
        k3["rows"] += n
        k3["ms"] += ms
        k3["pms"] += pms
        del a, X0, Xk, Xp, okk, okp
    record("triangulate_gn", k3["mism"], k3["rows"], k3["err"], k3["ms"],
           k3["pms"], 1e-4, gated=k3["rel"], exact=True,
           work=(k3["bytes"], k3["flops"]))

    # K4 at the follow shape: the chunk's seeds in both driving
    # directions, as one follow_seeds call launches it: the direction
    # trials (warm, T = 1) and the walk (cold, max_follow_steps)
    both, drive = follow_seed_tuples(ctx, starts, oxc, om, M)
    k4 = dict(mism=0, lanes=0, err=0.0, rel=0.0, ms=0.0, pms=0.0, bytes=0.0,
              flops=0.0)
    for mode, fargs in zip(("warm", "cold"),
                           captured_follow_walks(ctx, both, drive)):
        args, T = fargs[:12], fargs[12]
        got, ms = cuda_time(lambda: following.follow_walk(*fargs), 10)
        walk, gn = following.follow_params(cfg, mode == "warm")
        ref, pms = cuda_time(lambda: following._follow_plain(
            *args, T, *walk, *gn), 1)
        mism, err, rel = follow_diff(got, ref)
        work, counts = follow_work(ctx, args, T, walk, gn, ref)
        log(f"  follow_walk {mode}: lanes={len(args[4])} T={T} "
            f"decision_mismatches={mism} max_abs_err={err:.3g} "
            f"X_max_rel_err={rel:.3g} kernel_ms={ms:.4f} plain_ms={pms:.4f} "
            f"bytes={work[0]:.6g} flops={work[1]:.6g} "
            f"bound_ms={bound(*work)[0]:.6f} {json.dumps(counts)}")
        for key, v in (("mism", mism), ("lanes", len(args[4])), ("ms", ms),
                       ("pms", pms), ("bytes", work[0]), ("flops", work[1])):
            k4[key] += v
        k4["err"], k4["rel"] = max(k4["err"], err), max(k4["rel"], rel)
    if k4["rel"] > 1e-4:
        fail(f"follow_walk: X relative error {k4['rel']} > 1e-4")
    record("follow_walk", k4["mism"], k4["lanes"], k4["err"], k4["ms"],
           k4["pms"], COORD_TOL_PX, exact=True,
           work=(k4["bytes"], k4["flops"]))
    return results


def k3_inputs(ctx, sfmd, O, warm):
    """K3's phase-2 rows at width O, from a fixed seed: scene points seen
    by O random cameras with 1 px noise and a fifth gross outliers; O = 3
    all present (the seed pairs), else 30% present at random with the
    first three always (the outlier filter's rows).  Returns ((P_mats,
    cams, xy, mask), X0 or None, iterations, rows)."""
    import torch
    cfg = ctx.config
    dev = ctx.device
    V = ctx.P_mats.shape[0]
    gen = torch.Generator(device=dev).manual_seed(0 if O == 3 else 1)
    pts3 = torch.as_tensor(sfmd.points, dtype=torch.float32, device=dev)
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
    X0 = (Xg + 0.01 * nrm(n, 3)) if warm else None
    iters = cfg.follow_gn_iters if warm else cfg.gn_max_iters
    return (ctx.P_mats, cams, xy.contiguous(), mask), X0, iters, n


def follow_seed_tuples(ctx, starts, oxc, om, M):
    """The seeds of one refpoint chunk's starts, doubled for both driving
    directions as follow_seeds_bidirectional doubles them: (seeds,
    drive)."""
    import torch

    from edgegraph3d_tpu_torch.matching import following
    from edgegraph3d_tpu_torch.matching import refpoints as rp
    st = rp._seed_tuple(rp._seed_from_starts(ctx, starts, oxc, om, M))
    S = len(st.cams)
    both = following.SeedTuple(*[torch.cat([a, a]) for a in st])
    ones = torch.ones(S, dtype=torch.int32, device=ctx.device)
    return both, torch.cat([ones, -ones])


def captured_follow_walks(ctx, seeds, drive):
    """The arguments of the follow_walk calls of one follow_seeds call on
    `seeds`: [the direction trials', the walk's]."""
    from edgegraph3d_tpu_torch.matching import following
    calls = []
    real = following.follow_walk

    def spy(*a):
        calls.append(a)
        return real(*a)

    following.follow_walk = spy
    try:
        following.follow_seeds(seeds, ctx.plg_coords, ctx.plg_length,
                               ctx.P_mats, ctx.F_table, drive, ctx.config,
                               ctx.config.max_follow_steps)
    finally:
        following.follow_walk = real
    if len(calls) != 2:
        fail(f"follow_seeds made {len(calls)} follow_walk calls, not 2")
    return calls


def follow_diff(got, ref):
    """(lanes whose decisions differ, max coordinate error of the others,
    max relative X error of their accepted steps) of two Follows."""
    bad = ((got.valid != ref.valid).any(1) | (got.n_steps != ref.n_steps)
           | (got.final_seg != ref.final_seg).any(1)
           | (got.seg != ref.seg).flatten(1).any(1))
    ok = ~bad
    top = lambda x: float(x.max()) if x.numel() else 0.0
    err = max(top((got.obs - ref.obs).abs()[ok]),
              top((got.t - ref.t).abs()[ok]),
              top((got.final_t - ref.final_t).abs()[ok]))
    d = (got.X - ref.X).abs() / ref.X.abs().clamp_min(1e-3)
    return int(bad.sum()), err, top(d[ref.valid & ok[:, None]])


def follow_work(ctx, args, T, walk, gn, ref):
    """(bytes, f32 operations) of one K4 call from this run's counts, and
    the counts: the walk steps tried, the GN runs (one per walked step up
    to the cut) and their mean iterations."""
    import torch

    from edgegraph3d_tpu_torch.matching import following
    coords, lengths, F_table, P_mats, cams, pl = args[:6]
    active0, X0 = args[10], args[11]
    w = following._walk_plain(coords, lengths, F_table, *args[4:11], T, *walk)
    S = len(cams)
    ar = torch.arange(T, device=cams.device)
    ran_gn = w.alive & (ar[None, :] <= ref.n_steps[:, None])
    last = ref.n_steps.clamp_max(T - 1).long()
    walk_failed = (active0 & (ref.n_steps < T)
                   & ~w.alive[torch.arange(S, device=cams.device), last])
    tried = int(ran_gn.sum()) + int(walk_failed.sum())
    rows = torch.nonzero(ran_gn.reshape(-1)).flatten()
    lane = rows // T
    its, _ = gn_iterations(
        P_mats, cams[lane], w.obs.reshape(S * T, 3, 2)[rows],
        torch.ones((len(rows), 3), dtype=torch.bool, device=cams.device),
        None if X0 is None else X0[lane], *gn)
    n_gn = len(rows)
    flops = (FLOPS["walk_step"] * tried
             + n_gn * its * (3 * FLOPS["gn_obs"] + FLOPS["gn_iter"]))
    if X0 is None:
        flops += n_gn * (3 * FLOPS["dlt_obs"] + FLOPS["dlt_solve"])
    V, Pn, L, _ = coords.shape
    polys = torch.unique(cams.long() * Pn + pl.long()).numel()
    n_bytes = (polys * (8 * L + 4) + S * (85 + 28 + (12 if X0 is not None
                                                       else 0))
               + S * T * 61 + V * 48 + V * V * 36)
    return (n_bytes, flops), dict(walk_steps=tried, gn_runs=n_gn,
                                  mean_gn_iterations=round(its, 4),
                                  accepted=int(ref.valid.sum()))


def compare_stage12_kernels(ctx, sfmd, results):
    """K5 at the probe's and the extension's shapes, K6 at the group
    sweep's shape, and label propagation's ordered bucket sums, on the
    full-scale scene."""
    import numpy as np
    import torch

    from edgegraph3d_tpu_torch import kernels
    from edgegraph3d_tpu_torch.matching import communities, polyline_stages
    from edgegraph3d_tpu_torch.matching import refpoints as rp
    from edgegraph3d_tpu_torch.matching.detection import grid_topm_query
    from edgegraph3d_tpu_torch.ops import gather

    cfg = ctx.config
    dev = ctx.device
    V, P, L, _ = ctx.plg_coords.shape

    def check_gather(label, table, rows, reps):
        """K5 against table[rows] (its plain version, and the one PyTorch
        call that computes the same function), each over `reps` calls per
        event pair, and K5's launch alone into a preallocated output."""
        from edgegraph3d_tpu_torch import kernels
        got, ms = cuda_time(lambda: gather.gather_rows(table, rows), reps)
        ref, pms = cuda_time(lambda: table[rows], reps)
        bad = int((got != ref).any(1).sum())
        err = float((got - ref).abs().max())
        out = torch.empty_like(got)
        lib, stream = kernels.lib(), kernels.stream_of(table)
        launch = lambda: kernels.check(lib.eg3d_gather_rows(
            table.data_ptr(), table.shape[0], table.shape[1],
            rows.data_ptr(), int(rows.dtype == torch.int64), len(rows),
            out.data_ptr(), stream), "gather_rows")
        _, launch_ms = cuda_time(launch, reps)
        if not torch.equal(out, got):
            fail(f"gather_rows {label}: the launch alone differs")
        dev_ms = device_ms(launch, 20, "gather_rows")
        lib_dev_ms = device_ms(lambda: table[rows], 20, "")
        n_bytes = rows.numel() * (8 * table.shape[1] + rows.element_size())
        log(f"  gather_rows {label}: table={tuple(table.shape)} "
            f"rows={len(rows)} ({rows.dtype}) mismatched_rows={bad} "
            f"max_abs_err={err:.3g} calls_per_event_pair={reps} "
            f"kernel_ms={ms:.4f} launch_alone_ms={launch_ms:.4f} "
            f"device_ms={dev_ms:.4f} table[rows]_ms={pms:.4f} "
            f"table[rows]_device_ms={lib_dev_ms:.4f} bytes={n_bytes} "
            f"bound_ms={bound(n_bytes, 0)[0]:.6f}")
        if bad:
            fail(f"gather_rows {label}: {bad} rows differ from table[rows]")
        return err, ms, pms, n_bytes

    # K5 at the Pallas probe's shape (R = V*P = 8 x 8192, W = 2L = 128)
    g = torch.Generator(device=dev).manual_seed(1)
    table = torch.randn((65536, 128), generator=g, device=dev)
    rows = torch.randint(0, 65536, (16384,), generator=g, device=dev,
                         dtype=torch.int32)
    err, _, _, _ = check_gather("probe shape", table, rows, 200)
    del table
    # K5 at the chain-extension shape: E x V rows of [L, 2] located by K1
    # (M=1) at every (refpoint, view) of the scene, E = the refpoints
    obs_xy, _ = rp.dense_observations(sfmd)
    N = len(obs_xy)
    view = torch.arange(V, dtype=torch.int32, device=dev).repeat(N)
    loc = grid_topm_query(ctx.grids, view,
                          torch.as_tensor(obs_xy, device=dev)
                          .reshape(N * V, 2), ctx.cell,
                          cfg.extension_reanchor_px, 1)
    rows = view.long() * P + loc.pl_id[:, 0].clamp_min(0).long()
    err2, ms, pms, n_bytes = check_gather(
        "extension shape", ctx.plg_coords.reshape(V * P, 2 * L), rows, 200)
    record_into(results, "gather_rows", 0, len(rows), max(err, err2), ms,
                pms, 0.0, exact=True, work=(n_bytes, 0.0), library_ms=pms)

    # the full scene's stage-1 graph: the card's f64 matmul build against
    # the host build from the same close sets, then the communities of
    # each, the card's with LP on the card, the host's with LP on the CPU
    t0 = time.time()
    used, edges, weights = polyline_stages.similarity_graph(sfmd, ctx)
    t_card = time.time() - t0
    t0 = time.time()
    used_h, edges_h, weights_h = polyline_stages.similarity_graph(
        sfmd, ctx, host=True)
    t_host = time.time() - t0
    if not (np.array_equal(used, used_h) and np.array_equal(edges, edges_h)):
        fail(f"similarity edges: the card's {len(edges)} edges over "
             f"{len(used)} nodes differ from the host build's {len(edges_h)}"
             f" over {len(used_h)}")
    n_diff = int((weights != weights_h).sum())
    rel = float(np.max(np.abs(weights - weights_h) / weights_h))
    log(f"  similarity graph: {len(used)} nodes, {len(edges)} edges (card "
        f"{t_card:.2f}s, host {t_host:.2f}s), weights differing from the "
        f"host build's: {n_diff}, max rel err {rel:.3g}")
    if rel > 1e-5:
        fail(f"similarity weights: relative error {rel} > 1e-5")
    method = cfg.community_method
    t0 = time.time()
    comms = communities.communities_from_edges(
        edges, weights, len(used), min_size=3, method=method, device=dev)
    t_card = time.time() - t0
    t0 = time.time()
    comms_h = communities.communities_from_edges(
        edges_h, weights_h, len(used), min_size=3, method=method,
        device="cpu")
    t_host = time.time() - t0
    groups = polyline_stages.communities_to_match_sets(used, comms, P)
    groups_h = polyline_stages.communities_to_match_sets(used, comms_h, P)
    same = len(groups) == len(groups_h) and all(
        np.array_equal(a, b) for a, b in zip(groups, groups_h))
    log(f"  communities ({method}): card {len(comms)} -> {len(groups)} "
        f"match sets ({t_card:.2f}s); host edges + CPU LP {len(comms_h)} -> "
        f"{len(groups_h)} ({t_host:.2f}s); same match sets: {same}")
    if not groups:
        fail("the full scene made no stage-1 match sets")
    if not same:
        fail("stage-1 match sets differ between the card and the CPU path")

    # label propagation: bucket sums at the converged labels, card vs CPU
    n = len(used)
    e_d = torch.as_tensor(edges.astype(np.int64), device=dev)
    w_d = torch.as_tensor(weights, device=dev)
    labels = communities.label_propagation(e_d, w_d, n)
    sums_d = communities._bucket_sums(*communities._directed(e_d, w_d),
                                      labels, n)
    sums_c = communities._bucket_sums(
        *communities._directed(e_d.cpu(), w_d.cpu()), labels.cpu(), n)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(sums_d, sums_c))
    log(f"  label propagation: {len(torch.unique(labels))} labels, "
        f"{len(sums_c[2])} buckets, card == CPU sums: {same}")
    if not same:
        fail("label propagation bucket sums differ between card and CPU")
    del e_d, w_d, labels, sums_d, sums_c

    # K6 at the group sweep's shape: the first group chunk (64 sets)
    cam, pl, msk = (torch.as_tensor(a[:64], device=dev) for a in
                    polyline_stages._member_table(groups, 8))
    cs, ps = cam.clamp_min(0).long(), pl.clamp_min(0).long()
    coords = gather.gather_rows(ctx.plg_coords.reshape(V * P, 2 * L),
                                (cs * P + ps).reshape(-1)) \
        .reshape(*cam.shape, L, 2)
    lengths = torch.where(msk, ctx.plg_length[cs, ps], 0).to(torch.int32)
    args = (coords, lengths, cam, msk, ctx.F_table, 24,
            cfg.split_interval_distance_px)
    got, ms = cuda_time(lambda: polyline_stages.group_seed_sample(*args),
                        20)
    ref, pms = cuda_time(
        lambda: polyline_stages._group_seed_sample_plain(
            *args, polyline_stages._QUASI_COS, polyline_stages._QUASI_DIST),
        3)
    lanes = got[3].numel()
    bad = ((got[1] != ref[1]) | (got[3] != ref[3])
           | (got[5] != ref[5]).flatten(3).any(-1)
           | (got[7] != ref[7]).flatten(3).any(-1))
    hit = got[7] & ref[7]
    err = float((got[0] - ref[0]).abs().max())
    if hit.any():
        err = max(err, float((got[4] - ref[4]).abs()[hit].max()))
    dms = device_ms(lambda: polyline_stages.group_seed_sample(*args), 20,
                    "group_seed")
    log(f"  group_seed_sample: groups={cam.shape[0]} lanes={lanes} "
        f"valid_samples={int(ref[3].sum())} crossings={int(ref[7].sum())} "
        f"placement={kernels.LAST_PLACEMENT.get('group_seed_sample')} "
        f"device_ms={dms:.4f}")
    G, K = cam.shape
    S = 24
    segs = float((lengths - 1).clamp_min(0).sum(1).sum()) * K * S
    n_bytes = (G * K * (8 * L + 9) + min(V * V, G * K * K) * 36
               + G * K * S * 17 + G * K * S * K * 2 * 17)
    flops = (G * K * (S - 1) * FLOPS["sample_step"]
             + G * K * S * K * FLOPS["line"] + segs * FLOPS["crossing_seg"])
    record_into(results, "group_seed_sample", int(bad.sum()), lanes, err,
                ms, pms, COORD_TOL_PX, exact=True, work=(n_bytes, flops))
    return groups


def tile_histogram(extent):
    """Chains per K7 tile bucket (<= 8, <= 16, <= 32, <= 64 slots)."""
    import numpy as np

    from edgegraph3d_tpu_torch.matching import expansion
    return np.bincount(np.searchsorted(expansion.TILE_SLOTS, extent),
                       minlength=4).tolist()


def _first_chains(ctx, X, obs3, cams3, seed_ids, orders, C=4096, T=64):
    """expand_chains_compact's arguments and extents for the first C
    chains in group_chains order, unsorted (the chunk the one-warp-per-
    chain design of K7 was timed on)."""
    import numpy as np
    import torch

    from edgegraph3d_tpu_torch.matching import expansion
    dev = ctx.device
    gather, vld = expansion.group_chains(seed_ids, orders, max_t=T)
    gi, vl = gather[:C], vld[:C]
    kidx = np.flatnonzero(vl.reshape(-1))
    rows = gi.reshape(-1)[kidx]
    as_t = lambda a: torch.as_tensor(a, device=dev)
    return (ctx.plg_coords, ctx.grids, ctx.P_mats, ctx.F_table, ctx.cell,
            as_t(np.asarray(X, np.float32)[rows]),
            as_t(np.asarray(obs3, np.float32)[rows]),
            as_t(cams3[gi[:, 0]].astype(np.int32)),
            as_t((kidx // T).astype(np.int64)),
            as_t((kidx % T).astype(np.int64)),
            torch.ones(len(kidx), dtype=torch.bool, device=dev), as_t(vl),
            ctx.config, len(gi), T), vl.sum(1)


def bucket_pieces(args, extent):
    """One refpoints.chain_chunks chunk cut at its tile-bucket edges: a
    list of (args, extent), one per run of chains in one bucket.  The
    chunk's chains are sorted by length and its points are in chain
    order, `extent` of each (valid slots are a prefix), so a run of
    chains owns a run of points, and the pieces' outputs concatenated
    are the chunk's."""
    import numpy as np

    from edgegraph3d_tpu_torch.matching import expansion
    head, (X, obs3, cams3, ci, ti, ok, vld, cfg, _, T) = args[:5], args[5:]
    b = np.searchsorted(expansion.TILE_SLOTS, extent)
    cuts = [0, *(np.flatnonzero(np.diff(b)) + 1).tolist(), len(extent)]
    first = np.concatenate([[0], np.cumsum(extent)])
    pieces = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        p0, p1 = int(first[lo]), int(first[hi])
        pieces.append(((*head, X[p0:p1], obs3[p0:p1], cams3[lo:hi],
                        ci[p0:p1] - lo, ti[p0:p1], ok[p0:p1], vld[lo:hi],
                        cfg, hi - lo, T), extent[lo:hi]))
    return pieces


def check_expansion(ctx, label, chunks):
    """K7 against its plain version over every chunk of one expansion,
    laid out as refpoints.expand_and_assemble lays them out
    (refpoints.chain_chunks): decisions, out_xy and X bit-equal.  The
    plain run is counted (K1 grid entries, GN observations and
    iterations) for the bound, then timed once more without the
    counting; K7 is timed in one launch per chunk (the wrapper's way)
    and, for comparison, in one launch per tile bucket (bucket_pieces).
    Returns (mismatched rows, rows, max |out_xy - plain| over the
    observations both accept, kernel ms, plain ms, (bytes, flops)) over
    all chunks."""
    import numpy as np
    import torch

    from edgegraph3d_tpu_torch.matching import expansion

    cfg = ctx.config
    V, GH, GW, Kc, _ = ctx.grids.shape
    chunks = [(a, e) for _, a, e in chunks]
    count = dict(entries=0, cells=[], gn_rows=0, gn_mask=[], gn_sample=[])
    query, gn = expansion.grid_topm_query, expansion.triangulate_gn

    def counted_query(grids, view, pts, cell, radius, M):
        e, c = grid_work(grids, view, pts, cell, 1)
        count["entries"] += e
        count["cells"].append(c)
        return query(grids, view, pts, cell, radius, M)

    def counted_gn(P_mats, cams, xy, mask, X0=None, **kw):
        count["gn_mask"].append(int(mask.sum()))
        count["gn_rows"] += mask.shape[0]
        step = max(1, mask.shape[0] // 128)
        count["gn_sample"].append(tuple(
            t[::step][:128] for t in (cams, xy, mask, X0)))
        return gn(P_mats, cams, xy, mask, X0=X0, **kw)

    plain = lambda: [expansion._expand_chains_compact_plain(*a)
                     for a, _ in chunks]
    expansion.grid_topm_query, expansion.triangulate_gn = (counted_query,
                                                            counted_gn)
    try:
        ref = plain()
    finally:
        expansion.grid_topm_query, expansion.triangulate_gn = query, gn
    _, pms = cuda_time(plain, 1, warmup=False)
    got, ms = cuda_time(lambda: [expansion.expand_chains_compact(
        *a, extent=e) for a, e in chunks], 5)
    pieces = [bucket_pieces(a, e) for a, e in chunks]
    split, split_ms = cuda_time(lambda: [
        [expansion.expand_chains_compact(*a, extent=e) for a, e in ps]
        for ps in pieces], 5)
    split = [tuple(torch.cat(t) for t in zip(*runs)) for runs in split]

    exact = all(torch.equal(x, y) for run in (got, split)
                for out, r in zip(run, ref) for x, y in zip(out, r))
    bad = sum(int((g[2] != r[2]).any(1).sum()) for g, r in zip(got, ref))
    err = 0.0
    for g, r in zip(got, ref):
        both = g[2] & r[2]
        if both.any():
            err = max(err, float((g[1] - r[1]).abs()[both].max()))
    K = sum(a[5].shape[0] for a, _ in chunks)
    C = sum(a[-2] for a, _ in chunks)
    T = chunks[0][0][-1]
    added = sum(int(r[2].sum()) for r in ref) - 3 * K
    samp = [torch.cat(t) for t in zip(*count["gn_sample"])]
    its, _ = gn_iterations(ctx.P_mats, *samp, cfg.follow_gn_iters,
                           cfg.gn_epsilon, cfg.match_gn_max_mse)
    live = sum(count["gn_mask"])
    gn_f = its * (FLOPS["gn_obs"] * live + FLOPS["gn_iter"] * count["gn_rows"])
    cells = torch.unique(torch.cat(count["cells"])).numel()
    n_bytes = (K * (12 + 24) + C * (12 + 5 * T) + len(chunks) * V * 48
               + cells * Kc * 24 + K * 12 + K * V * 9)
    flops = FLOPS["grid_entry"] * count["entries"] + gn_f
    hist = np.sum([tile_histogram(e) for _, e in chunks], 0).tolist()
    log(f"  expand_chains {label}: {C} chains in {len(chunks)} chunks, {K} "
        f"points, chains by tile bucket (<=8, <=16, <=32, <=64 slots) "
        f"{hist}; views added={added} gn_tries={count['gn_rows']} "
        f"gn_live_obs={live} mean_gn_iterations={its:.4f} "
        f"grid_entries={count['entries']} bit_equal={exact} "
        f"max_abs_err={err:.3g} kernel_ms one launch per chunk={ms:.4f} "
        f"one per bucket ({sum(map(len, pieces))} launches)="
        f"{split_ms:.4f} plain_ms={pms:.4f} bytes={n_bytes:.6g} "
        f"flops={flops:.6g} bound_ms={bound(n_bytes, flops)[0]:.6f}")
    if not exact:
        fail(f"expand_chains {label}: not bit-equal to its plain version")
    return bad, K, err, ms, pms, (n_bytes, flops)


def compare_expansion(ctx, sfmd, results):
    """K7 against its plain version over the whole expansion of the full
    scene's stage-3 chains (recorded) and of the first chain-extension
    round's chains (logged; they are longer), each in the chunks
    refpoints.expand_and_assemble makes.  Also K7 alone on the chunk the
    one-warp-per-chain design was timed on (the first 4,096 stage-3
    chains, unsorted) and on the stage-3 chains in chunks of 4,096 and
    16,384."""
    from edgegraph3d_tpu_torch.matching import expansion, matches
    from edgegraph3d_tpu_torch.matching import refpoints as rp

    t0 = time.time()
    mgr = matches.MatchesManager(ctx.plg_length.cpu().numpy())
    round0, _ = rp.compute_and_follow_seeds(sfmd, ctx)
    res = rp.sweep_seeds(None, None, ctx, mgr, precomputed=round0)
    X, obs3, cams3, refs, seed_ids, orders = res
    log(f"  expand_chains: the full scene's {len(X)} stage-3 points "
        f"({time.time() - t0:.1f}s)")
    args, extent = _first_chains(ctx, X, obs3, cams3, seed_ids, orders)
    _, ms = cuda_time(lambda: expansion.expand_chains_compact(
        *args, extent=extent), 5)
    log(f"  expand_chains first 4096 chains, unsorted: "
        f"chains by tile bucket {tile_histogram(extent)} kernel_ms={ms:.4f}")
    del args
    for size in (4096, 16384):           # the main path's chunk is 8,192
        chunks = [(a, e) for _, a, e in rp.chain_chunks(
            ctx, X, obs3, cams3, seed_ids, orders, chain_chunk=size)]
        _, ms = cuda_time(lambda: [expansion.expand_chains_compact(
            *a, extent=e) for a, e in chunks], 5)
        log(f"  expand_chains stage 3 in chunks of {size} chains: "
            f"{len(chunks)} launches, kernel_ms={ms:.4f}")
    del chunks
    mism, K, err, ms, pms, work = check_expansion(
        ctx, "stage 3", rp.chain_chunks(ctx, X, obs3, cams3, seed_ids,
                                        orders))
    record_into(results, "expand_chains", mism, K, err, ms, pms,
                COORD_TOL_PX, exact=True, work=work)

    # the chain extension's chains: expand stage 3 in full, then capture
    # the points the first extension round hands to expand_and_assemble
    pts = rp.expand_and_assemble(ctx, *res)
    seen = []
    real = rp.expand_and_assemble

    def capture(ctx_, X_, obs3_, cams3_, refs_, seed_ids_, orders_, *a,
                **kw):
        seen.append((X_, obs3_, cams3_, seed_ids_, orders_))
        return real(ctx_, X_, obs3_, cams3_, refs_, seed_ids_, orders_, *a,
                    **kw)

    rp.expand_and_assemble = capture
    try:
        rp._extend_once(ctx, pts, mgr)
    finally:
        rp.expand_and_assemble = real
    if not seen:
        fail("the chain extension expanded no points")
    mism, K, _, _, _, _ = check_expansion(ctx, "extension",
                                          rp.chain_chunks(ctx, *seen[0]))
    if mism:
        fail(f"expand_chains extension: {mism} of {K} rows differ")


# ----------------------------------------------------------------------
# phase 2: tables beyond 48 KiB of shared memory
# ----------------------------------------------------------------------

def _tiled(t, V_big, dims):
    """t repeated along `dims` (each of size V) to V_big entries."""
    import torch
    idx = torch.arange(V_big, device=t.device) % t.shape[dims[0]]
    for d in dims:
        t = t.index_select(d, idx)
    return t.contiguous()


def _expect_placement(name, n_bytes, want):
    """The placement kernels.table_placement gives `n_bytes` on this card
    must be `want` (the check is built for an H100's limit), and the
    kernel's last launch must have used it."""
    import torch

    from edgegraph3d_tpu_torch import kernels
    opt = kernels.smem_optin_bytes(torch.device("cuda"))
    where = kernels.LAST_PLACEMENT.get(name)
    log(f"    {name}: table {n_bytes} B, opt-in limit {opt} B, "
        f"placement {where}")
    if kernels.table_placement(n_bytes, opt) != want or where != want:
        fail(f"{name}: a {n_bytes} B table ran as {where}, expected {want}")


def check_large_tables(ctx, sfmd):
    """K3's general body, K6 and K7 on tables beyond 48 KiB of shared
    memory, each against its plain version on the same inputs with 0
    decision mismatches; each launch's placement is logged and must be
    the one kernels.table_placement picks for an H100.  Camera tables are
    the scene's P and F tiled to V views; member tables the scene's
    polylines drawn at random."""
    import torch

    from edgegraph3d_tpu_torch.matching import polyline_stages
    from edgegraph3d_tpu_torch.ops import triangulation

    dev = ctx.device
    cfg = ctx.config
    V = ctx.P_mats.shape[0]
    pts3 = torch.as_tensor(sfmd.points, dtype=torch.float32, device=dev)
    # K3's general body: O = 8, 70% present, cold (DLT + 30 iterations)
    for V_big, want in ((1100, "optin"), (5000, "global")):
        P_big = _tiled(ctx.P_mats, V_big, [0])
        gen = torch.Generator(device=dev).manual_seed(V_big)
        n, O = 65536, 8
        rnd = lambda *sh: torch.rand(*sh, generator=gen, device=dev)
        cams = (rnd(n, O) * V_big).long().clamp_max(V_big - 1)
        Xg = pts3[(rnd(n) * len(pts3)).long().clamp_max(len(pts3) - 1)]
        Pg = P_big[cams]
        pr = (Pg[..., :3] * Xg[:, None, None, :]).sum(-1) + Pg[..., 3]
        xy = (pr[..., :2] / pr[..., 2:3]
              + torch.randn(n, O, 2, generator=gen, device=dev)).contiguous()
        mask = rnd(n, O) < 0.7
        mask[:, :2] = True
        a = (P_big, cams.to(torch.int32), xy, mask)
        Xk, _, okk = triangulation.triangulate_gn(*a)
        torch.cuda.synchronize()
        log(f"  large tables, triangulate_gn V={V_big} O={O}: rows={n}")
        _expect_placement("triangulate_gn",
                          triangulation.gn_table_bytes(V_big), want)
        Xp, _, okp = triangulation._triangulate_gn_plain(
            *a, None, 30, cfg.gn_epsilon, 9.0, 1e-5)
        both = okk & okp
        rel = float(((Xk - Xp).abs() / Xp.abs().clamp_min(1e-3))[both]
                    .max()) if both.any() else 0.0
        mism = int((okk != okp).sum())
        log(f"    valid={int(okp.sum())} decision_mismatches={mism} "
            f"X_max_rel_err={rel:.3g}")
        if mism or rel > 1e-4 or not okp.any():
            fail(f"triangulate_gn V={V_big}: {mism} decisions differ, X "
                 f"relative error {rel}")

    # K6: one group of 128 members (opt-in), one of 460 (its polylines
    # alone exceed the opt-in limit), drawn from the scene's polylines
    # (padded to 64 points)
    L = max(64, ctx.plg_coords.shape[2])
    live = torch.nonzero(ctx.plg_length >= 2)
    for K, S, want in ((128, 24, "optin"), (460, 4, "global")):
        gen = torch.Generator(device=dev).manual_seed(K)
        pick = live[torch.randint(0, len(live), (1, K), generator=gen,
                                  device=dev)]
        cam = pick[..., 0].to(torch.int32)
        pl = pick[..., 1]
        msk = torch.rand((1, K), generator=gen, device=dev) < 0.9
        coords = torch.nn.functional.pad(
            ctx.plg_coords[cam.long(), pl],
            (0, 0, 0, L - ctx.plg_coords.shape[2])).contiguous()
        lengths = torch.where(msk, ctx.plg_length[cam.long(), pl], 0) \
            .to(torch.int32)
        args = (coords, lengths, cam, msk, ctx.F_table, S,
                cfg.split_interval_distance_px)
        got = polyline_stages.group_seed_sample(*args)
        torch.cuda.synchronize()
        log(f"  large tables, group_seed_sample K={K} L={L} S={S}")
        _expect_placement("group_seed_sample",
                          polyline_stages.k6_table_bytes(K, L), want)
        ref = polyline_stages._group_seed_sample_plain(
            *args, polyline_stages._QUASI_COS, polyline_stages._QUASI_DIST)
        bad = int(((got[1] != ref[1]) | (got[3] != ref[3])
                   | (got[5] != ref[5]).flatten(3).any(-1)
                   | (got[7] != ref[7]).flatten(3).any(-1)).sum())
        hit = got[7] & ref[7]
        err = float((got[0] - ref[0]).abs().max())
        if hit.any():
            err = max(err, float((got[4] - ref[4]).abs()[hit].max()))
        log(f"    crossings={int(ref[7].sum())} decision_mismatches={bad} "
            f"max_abs_err={err:.3g}")
        if bad or err > COORD_TOL_PX or not ref[7].any():
            fail(f"group_seed_sample K={K}: {bad} lanes differ, error {err}")
        del got, ref

    # K7 on a small scene's chains with its cameras tiled: "epipolar" at
    # V = 400 and "closest" at V = 5,000, both beyond the opt-in limit
    check_large_expansion()


def check_large_expansion():
    import numpy as np
    import torch

    from edgegraph3d_tpu_torch.config import EdgeGraphConfig
    from edgegraph3d_tpu_torch.core import synthetic
    from edgegraph3d_tpu_torch.matching import expansion, matches
    from edgegraph3d_tpu_torch.matching import refpoints as rp
    from edgegraph3d_tpu_torch.plgs.extraction import extract_plgs

    cfg = EdgeGraphConfig().replace(max_polylines_per_view=256,
                                    max_polyline_len=64, max_follow_steps=32)
    sfmd, imgs, _ = synthetic.make_scene(
        n_cams=8, n_refpoints_per_curve=16, width=320, height_px=240,
        focal=400.0, seed=3)
    ctx = rp.build_context(sfmd, extract_plgs(imgs, cfg), cfg,
                           device="cuda")
    mgr = matches.MatchesManager(ctx.plg_length.cpu().numpy())
    round0, _ = rp.compute_and_follow_seeds(sfmd, ctx)
    X, obs3, cams3, _, seed_ids, orders = rp.sweep_seeds(
        None, None, ctx, mgr, precomputed=round0)
    T = 64
    gi, vld = expansion.group_chains(seed_ids, orders, max_t=T)
    gi, vld = gi[:256], vld[:256]
    kidx = np.flatnonzero(vld.reshape(-1))
    rows = gi.reshape(-1)[kidx]
    as_t = lambda a: torch.as_tensor(a, device=ctx.device)
    tensors = (as_t(np.asarray(X, np.float32)[rows]),
               as_t(np.asarray(obs3, np.float32)[rows]),
               as_t(cams3[gi[:, 0]].astype(np.int32)),
               as_t(kidx // T), as_t(kidx % T),
               torch.ones(len(kidx), dtype=torch.bool, device=ctx.device),
               as_t(vld))
    for V_big, mode in ((400, "epipolar"), (5000, "closest")):
        grids = _tiled(ctx.grids, V_big, [0])
        P_big = _tiled(ctx.P_mats, V_big, [0])
        F_big = _tiled(ctx.F_table, V_big, [0, 1])
        c = cfg.replace(expand_correspondence_mode=mode)
        args = (ctx.plg_coords, grids, P_big, F_big, ctx.cell, *tensors, c,
                len(gi), T)
        t0 = time.time()
        got = expansion.expand_chains_compact(*args, vld.sum(1))
        torch.cuda.synchronize()
        log(f"  large tables, expand_chains {mode} V={V_big}: "
            f"{len(gi)} chains, {len(kidx)} points "
            f"({time.time() - t0:.2f}s)")
        _expect_placement("expand_chains",
                          expansion.k7_table_bytes(V_big, mode == "epipolar"),
                          "global")
        t0 = time.time()
        ref = expansion._expand_chains_compact_plain(*args)
        exact = all(torch.equal(a, b) for a, b in zip(got, ref))
        added = int(ref[2].sum()) - 3 * len(kidx)
        log(f"    plain ({time.time() - t0:.2f}s): views added={added} "
            f"bit_equal={exact}")
        if not exact or added <= 0:
            fail(f"expand_chains {mode} V={V_big}: not bit-equal to its "
                 f"plain version (views added {added})")
        del grids, F_big, got, ref


# ----------------------------------------------------------------------
# phases 3-4: the main path
# ----------------------------------------------------------------------

def _write_scene_files(root, sfmd, edges):
    """The scene as the command line takes it: edge PNGs and the
    OpenMVG JSON."""
    from PIL import Image

    from edgegraph3d_tpu_torch.core import sfm as sfm_io
    for d in ("imgs", "edges"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for v in range(edges.shape[0]):
        Image.fromarray(edges[v]).save(
            os.path.join(root, "edges", f"synthetic_{v:04d}.png"))
    sfm_io.write_sfm_data(sfmd, os.path.join(root, "input.json"))


def run_main_path(name, scene, max_starting_views, stages=(1, 2, 3),
                  config=None, via_files=False, working_folder=None):
    """One pipeline run on the card with the launch counts set to 0 just
    before it and read just after.  `via_files` goes through
    `edge_matching` on files in a temporary directory; else
    `working_folder` (optional) is run_pipeline's.  Returns (launches,
    stage counts)."""
    import tempfile

    import torch

    from edgegraph3d_tpu_torch import kernels
    from edgegraph3d_tpu_torch.core import sfm as sfm_io
    from edgegraph3d_tpu_torch.pipeline import (PipelineStats, edge_matching,
                                                run_pipeline)
    from edgegraph3d_tpu_torch.quality import quality_metrics

    from edgegraph3d_tpu_torch.matching import expansion

    sfmd, edges, curves = scene
    cfg = config or bench_config()
    k7_calls = []
    k7 = expansion.expand_chains_compact

    def counted_k7(*a, extent):
        k7_calls.append((a[-2], tile_histogram(extent)))
        return k7(*a, extent=extent)

    expansion.expand_chains_compact = counted_k7
    with tempfile.TemporaryDirectory() as tmp:
        if via_files:
            _write_scene_files(tmp, sfmd, edges)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.time()
        if via_files:
            work = os.path.join(tmp, "work")
            out = edge_matching(
                os.path.join(tmp, "imgs"), os.path.join(tmp, "edges"), work,
                os.path.join(tmp, "input.json"),
                os.path.join(tmp, "out.json"), cfg,
                max_starting_views=max_starting_views, device="cuda")
        else:
            stats = PipelineStats()
            out = run_pipeline(sfmd, edges, cfg,
                               working_folder=working_folder,
                               max_starting_views=max_starting_views,
                               stats=stats, stages=stages, device="cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(kernels.LAUNCHES)
        expansion.expand_chains_compact = k7
        if via_files:
            with open(os.path.join(work, "stats.json")) as f:
                counts = json.load(f)["counts"]
            back = sfm_io.read_sfm_data(os.path.join(tmp, "out.json"))
            if back.n_points != out.n_points:
                fail(f"{name}: out.json holds {back.n_points} points, the "
                     f"run returned {out.n_points}")
        else:
            log(stats.report())
            counts = dict(stats.counts)
    peak = torch.cuda.max_memory_allocated()
    qual = quality_metrics(out, sfmd, curves)
    # the working folder's checkpoints (host JSON writing) are left out
    # of views_per_s, so that it compares with runs without a folder
    ckpt = 0.0 if via_files else stats.timings.get("write_checkpoints", 0.0)
    log(f"{name}: views={sfmd.n_cameras} refpoints={sfmd.n_points} "
        f"stages={'(1, 2, 3)' if via_files else stages} "
        f"max_starting_views={max_starting_views or 'all'} wall_s={wall:.3f} "
        f"write_checkpoints_s={ckpt:.3f} "
        f"wall_without_checkpoints_s={wall - ckpt:.3f} "
        f"views_per_s={sfmd.n_cameras / (wall - ckpt):.4f} "
        f"max_memory_allocated_bytes={peak}")
    log(f"{name} stage counts: {json.dumps(counts)}")
    log(f"{name} quality: {json.dumps(qual)}")
    log(f"{name} launches: {json.dumps(launches)}")
    if not via_files and "joint_ba" in counts:
        log(f"{name} joint BA: {json.dumps(stats.metrics)}")
    log(f"{name} K7 calls (chains, chains by tile bucket): {k7_calls}")
    if qual["edge_points"] == 0 or not qual["coverage"] >= 0.9 \
            or not qual["med_dist3d"] <= 0.01:
        fail(f"{name}: quality gate (edge_points > 0, coverage >= 0.9, "
             f"med_dist3d <= 0.01) not met: {qual}")
    return launches, counts


# ----------------------------------------------------------------------
# phase 6: the optional paths (joint BA with K8, device claiming, LMedS F)
# ----------------------------------------------------------------------

#: K8's outputs and the Schur system against the plain version's, each
#: as a fraction of the array's largest magnitude (f32 sums in other
#: orders), on the perturbed state below
BA_BLOCK_TOL = 1e-4
#: after 3 LM steps with K8 against 3 plain steps: rotation entries (abs),
#: translations within BA_CAM_TOL (1 + max |t|), points within BA_X_TOL of
#: the largest distance the plain steps moved a point
BA_CAM_TOL, BA_X_TOL = 1e-4, 1e-2
#: the seeded perturbation joint BA starts from: rotations (rad, per
#: axis), translations and points (scene units; the full scene spans
#: ~1.7), so that gx is not ~0 as at triangulated points and the steps
#: move the state far enough for the checks to see a wrong gx
BA_PERTURB = dict(w=0.002, t=0.005, X=0.01)


def _rel_err(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def ba_work(N, V, O, n_obs):
    """(bytes, f32 operations) of one K8 call: each input read once,
    each output written once (the dense B and A dominate), and the
    arithmetic of every present observation and every point."""
    n_in = V * 21 * 4 + N * 12 + N * O * (4 + 8 + 1)
    n_out = N * (36 + 12) + 2 * N * V * 72 + V * (36 + 12) * 4 + 16
    return n_in + n_out, FLOPS["ba_obs"] * n_obs + FLOPS["ba_point"] * N


def ba_step1_errors(got, ref):
    """Every step-1 piece of K8 (`got`) and of the plain version, and the
    Schur S of each: {name: error / the plain array's largest magnitude}
    and the largest absolute error."""
    from edgegraph3d_tpu_torch.ops import ba
    pieces = {n: (getattr(got, n), getattr(ref, n)) for n in
              ("Hxx_inv", "gx", "B", "A", "Hcc", "gc", "rhs", "resid_sq")}
    pieces["S"] = (ba.schur_complement(got), ba.schur_complement(ref))
    rel = {n: _rel_err(a, b) for n, (a, b) in pieces.items()}
    return rel, max(float((a - b).abs().max()) for a, b in pieces.values())


def ba_steps_errors(st, st_p, X0):
    """Final state of 3 LM steps (`st`) against the plain steps' (`st_p`,
    started from points X0): the readings and whether they pass."""
    d = {n: float((getattr(st, n) - getattr(st_p, n)).abs().max())
         for n in ("R", "t", "X")}
    d["X moved (plain)"] = float((st_p.X - X0).norm(dim=-1).max())
    d["t_tol"] = BA_CAM_TOL * (1 + float(st_p.t.abs().max()))
    d["X_tol"] = BA_X_TOL * d["X moved (plain)"]
    ok = d["R"] <= BA_CAM_TOL and d["t"] <= d["t_tol"] \
        and d["X"] <= d["X_tol"]
    return d, ok


def perturbed_ba_state(aug, device, seed=0):
    """BAState of the augmented scene with the BA_PERTURB offsets drawn
    from `seed` (numpy), all f32 on `device`."""
    import numpy as np
    import torch

    from edgegraph3d_tpu_torch.ops import ba
    rng = np.random.default_rng(seed)
    V, N = aug.n_cameras, aug.n_points
    w = torch.as_tensor(rng.normal(0, BA_PERTURB["w"], (V, 3)))
    arrays = (aug.K, ba.exp_so3(w).numpy() @ aug.R,
              aug.t + rng.normal(0, BA_PERTURB["t"], (V, 3)),
              aug.points + rng.normal(0, BA_PERTURB["X"], (N, 3)))
    return ba.BAState(*(torch.as_tensor(np.asarray(a, np.float32),
                                        device=device) for a in arrays))


def check_joint_ba(aug, results, device="cuda"):
    """Joint BA on the augmented full scene (phase 4's
    before_filtering.json), from a seeded perturbation of it: step 1's
    blocks and Schur system with K8 against the plain version, then 3 LM
    steps with K8 (`ba.ba_step_single`) and 3 plain, each of which must
    lower the MSE, with the final cameras and points held together.  The
    same two checks must reject K8's outputs with gx zeroed and with gx
    negated.  Returns K8's launches in the kernel run."""
    import numpy as np
    import torch

    from edgegraph3d_tpu_torch import kernels
    from edgegraph3d_tpu_torch.matching import refpoints as rp
    from edgegraph3d_tpu_torch.ops import ba
    from edgegraph3d_tpu_torch.ops.linalg3 import det3

    dev = torch.device(device)
    N, V = aug.n_points, aug.n_cameras
    obs_xy, obs_mask = rp.dense_observations(aug)
    cam = torch.arange(V, dtype=torch.int32, device=dev).repeat(N, 1)
    xy = torch.as_tensor(np.asarray(obs_xy, np.float32), device=dev)
    mask = torch.as_tensor(obs_mask, device=dev)
    obs = (cam, xy, mask)
    state0 = perturbed_ba_state(aug, dev)
    n_obs = int(mask.sum())
    log(f"  joint BA: N={N} points, V={V}, {n_obs} observations, from "
        f"the augmented scene perturbed by {json.dumps(BA_PERTURB)} "
        "(seed 0)")

    # the observation index, built once a ba_run
    index, index_ms = cuda_time(
        lambda: ba.observation_index(cam, mask, V), 5)
    log(f"  ba observation index: {index.slot.shape[0]} slots, largest "
        f"view {index.max_count}, {int((~index.first).sum())} repeated "
        f"(point, view) pairs, built in {index_ms:.4f} ms")

    # step 1: every piece against the plain version
    got, ms = cuda_time(lambda: ba.ba_blocks(state0, *obs, index=index), 5)
    _, own_index_ms = cuda_time(lambda: ba.ba_blocks(state0, *obs), 5)
    ref, pms = cuda_time(lambda: ba._ba_blocks_plain(state0, *obs), 1)
    k8_ms = device_ms_by_kernel(
        lambda: ba.ba_blocks(state0, *obs, index=index), 5, r"ba_\w+")
    kms = sum(v for k, v in k8_ms.items() if k.startswith("ba_"))
    rel, err = ba_step1_errors(got, ref)
    gated = max(rel.values())
    log(f"  ba_blocks step 1, error / largest magnitude: {json.dumps(rel)}")
    # K8's decisions (the depth branch |p_z| < 1e-9, the det guard of the
    # damped inverse) are not among its outputs: their margins on these
    # inputs say whether f32 rounding could flip one
    pz = (state0.X @ state0.R[:, 2, :].T + state0.t[:, 2])[mask]
    r, Hxx = ba.ba_build_blocks(state0, *obs)[:2]
    dg = torch.diagonal(Hxx, dim1=-2, dim2=-1)
    det = det3(Hxx + 1e-4 * torch.diag_embed(dg)
               + 1e-8 * torch.eye(3, device=dev))
    # how far gx is from cancelling: its largest magnitude against its
    # terms' scale sqrt(Hxx_ii sum r^2) (Cauchy-Schwarz)
    scale = torch.sqrt(dg * (r * r).sum((1, 2))[:, None])
    log(f"  ba_blocks decision margins: min |p_z| {float(pz.abs().min()):.6g}"
        f" (branch below 1e-9), min |det| {float(det.abs().min()):.6g} "
        f"(guard below 1e-20); max |gx| {float(ref.gx.abs().max()):.6g}, "
        f"{float(ref.gx.abs().max() / scale.max()):.6g} of the largest "
        "terms' scale")
    del pz, r, Hxx, dg, det, scale
    if int(got.n_obs) != n_obs or int(ref.n_obs) != n_obs:
        fail(f"ba_blocks: observation count {int(got.n_obs)} / "
             f"{int(ref.n_obs)} != {n_obs}")
    for label, f in (("zeroed", 0.0), ("negated", -1.0)):
        mrel, _ = ba_step1_errors(got._replace(gx=got.gx * f), ref)
        log(f"  ba_blocks step-1 check of K8's outputs with gx {label}: "
            f"gx {mrel['gx']:.6g}, rhs {mrel['rhs']:.6g} (tolerance "
            f"{BA_BLOCK_TOL})")
        if max(mrel.values()) <= BA_BLOCK_TOL:
            fail(f"ba_blocks: the step-1 check passes gx {label}")
    # K8's launch alone (the C entry, as the wrapper calls it) into the
    # step-1 outputs, after the comparison
    launch_ms = cuda_time(k8_launch_alone(ba, kernels, state0, obs, got,
                                          index), 20)[1]
    A2, B2 = got.A.reshape(6 * V, 3 * N), got.B.reshape(3 * N, 6 * V)
    _, mm_ms = cuda_time(lambda: torch.matmul(A2, B2), 5)
    S, rhs = ba.schur_complement(ref), ref.rhs.reshape(-1)
    S += (1e-4 * torch.diagonal(S) + 1e-12) * torch.eye(6 * V, device=dev)
    pre = 1.0 / torch.sqrt(torch.clamp_min(torch.diagonal(S), 1e-12))
    S_p = S * pre[:, None] * pre[None, :]
    _, solve_ms = cuda_time(lambda: torch.linalg.solve(S_p, rhs * pre), 5)
    record_into(results, "ba_blocks", None, N, err, ms, pms, BA_BLOCK_TOL,
                gated=gated, work=ba_work(N, V, V, n_obs))
    bound_ms = results["ba_blocks"]["bound_ms"]
    log(f"  ba_blocks: device_ms={kms:.4f} (profiler: {json.dumps(k8_ms)}) "
        f"launch_alone_ms={launch_ms:.4f} bound_ms={bound_ms:.6f} "
        f"wrapper_ms={ms:.4f} (building its own index "
        f"{own_index_ms:.4f}) plain_ms={pms:.4f}; "
        f"S matmul [{6 * V}, {3 * N}] x [{3 * N}, {6 * V}] "
        f"{mm_ms:.4f} ms; solve {6 * V}x{6 * V} {solve_ms:.4f} ms")
    del got, ref, S, S_p, A2, B2

    def plain_step(st):
        """One LM step with the plain version's blocks."""
        blocks = ba._ba_blocks_plain(st, *obs)
        new, _, _ = ba.ba_apply(st, ba.schur_complement(blocks), blocks)
        return new, blocks.resid_sq / blocks.n_obs.clamp_min(1)

    def wrong_gx_step(f):
        """One LM step with K8's blocks, gx scaled by f."""
        def step(st):
            blocks = ba.ba_blocks(st, *obs, index=index)
            blocks = blocks._replace(gx=blocks.gx * f)
            new, _, _ = ba.ba_apply(st, ba.schur_complement(blocks), blocks)
            return new, blocks.resid_sq / blocks.n_obs.clamp_min(1)
        return step

    def steps(label, step):
        """3 LM steps, each timed on the host clock after a
        synchronize; K8's launches counted over the run."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        st, mses, walls = state0, [], []
        for _ in range(3):
            t0 = time.time()
            st, mse = step(st)
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
            mses.append(float(mse))
        launches = kernels.LAUNCHES["ba_blocks"]
        after = float(ba.ba_mse(st, *obs))
        log(f"  joint BA {label}: mse per step {mses}, after {after}, "
            f"step walls_s {walls}, K8 launches {launches}, "
            f"max_memory_allocated_bytes "
            f"{torch.cuda.max_memory_allocated()}")
        return st, launches, mses[0], after

    st_k, launches, mse0, after = steps(
        "with K8", lambda st: ba.ba_step_single(st, *obs, index=index))
    if not after < mse0:
        fail(f"joint BA with K8: the MSE did not fall ({mse0}, {after})")
    st_p, plain_launches, mse0, after = steps("plain", plain_step)
    if not after < mse0:
        fail(f"joint BA plain: the MSE did not fall ({mse0}, {after})")
    if launches != 3 or plain_launches != 0:
        fail(f"joint BA: K8 launched {launches} times with K8 and "
             f"{plain_launches} times in the plain run")
    d, ok = ba_steps_errors(st_k, st_p, state0.X)
    log(f"  joint BA, K8 against plain after 3 steps (max abs): "
        f"{json.dumps(d)}")
    if not ok:
        fail(f"joint BA: K8 and plain runs differ: {d}")
    for label, f in (("zeroed", 0.0), ("negated", -1.0)):
        st_m = steps(f"with K8, gx {label}", wrong_gx_step(f))[0]
        dm, ok = ba_steps_errors(st_m, st_p, state0.X)
        log(f"  joint BA, K8 with gx {label} against plain after 3 steps: "
            f"{json.dumps(dm)}")
        if ok:
            fail(f"joint BA: the 3-step check passes gx {label}")
    return launches


def k8_launch_alone(ba, kernels, state, obs, out, index=None):
    """fn() that launches K8's C entry alone into the preallocated
    outputs `out` (a BABlocks) for the port checkout whose ops/ba.py is
    `ba`: with the observation index `index` and a preallocated partial
    buffer where the checkout has one, else the first design's entry
    (its per-point scratch preallocated; B, which that design adds into,
    keeps accumulating)."""
    import torch
    K, R, t, X = state
    cam, xy, mask = obs
    V, (N, O) = K.shape[0], cam.shape
    if hasattr(ba, "observation_index"):
        partial = ba._view_partials(index, V, X.device)
        return lambda: ba._ba_blocks_launch(state, cam, xy, mask, 1e-4,
                                            index, out, partial)
    lib, stream = kernels.lib(), kernels.stream_of(X)
    rsq = torch.empty(N, device=X.device)
    cnt = torch.empty(N, dtype=torch.int32, device=X.device)
    ptrs = [a.data_ptr() for a in (out.Hxx_inv, out.gx, out.B, out.A, rsq,
                                   cnt, out.Hcc, out.gc, out.rhs,
                                   out.resid_sq, out.n_obs)]
    return lambda: kernels.check(lib.eg3d_ba_blocks(
        K.data_ptr(), R.data_ptr(), t.data_ptr(), V, X.data_ptr(),
        cam.data_ptr(), xy.data_ptr(), mask.data_ptr(), N, O, 1e-4, *ptrs,
        stream), "ba_blocks")


#: the synthetic problem of --time-k8: the shape of phase 6's augmented
#: full scene (61,008 points, 49 views, dense layout, 2,102,033 present
#: observations: 34.45 a point)
K8_SHAPE = dict(N=61008, V=FULL_VIEWS, present=2102033 / 61008 / FULL_VIEWS)


def k8_problem(device, seed=0):
    """(BAState, (cam, xy, mask)) of a seeded problem of K8_SHAPE: V
    cameras 4 units from the origin looking at it (focal 2,200 px,
    1600x1200), points in a ball of radius 0.5, observations with 0.5 px
    of noise, each view present with probability K8_SHAPE["present"]
    (at least 2 a point), then the poses and points perturbed by
    BA_PERTURB, as phase 6 starts."""
    import numpy as np
    import torch

    from edgegraph3d_tpu_torch.ops import ba
    rng = np.random.default_rng(seed)
    N, V = K8_SHAPE["N"], K8_SHAPE["V"]
    c = rng.normal(size=(V, 3))
    c = 4.0 * c / np.linalg.norm(c, axis=1, keepdims=True)
    z = -c / 4.0
    x = np.cross(z, rng.normal(size=(V, 3)))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    R = np.stack([x, np.cross(z, x), z], axis=1)
    t = -np.einsum("vij,vj->vi", R, c)
    K = np.tile(np.array([[2200.0, 0.0, WIDTH / 2], [0.0, 2200.0, HEIGHT / 2],
                          [0.0, 0.0, 1.0]]), (V, 1, 1))
    u = rng.normal(size=(N, 3))
    X = 0.5 * rng.uniform(0, 1, (N, 1)) ** (1 / 3) * u / np.linalg.norm(
        u, axis=1, keepdims=True)
    q = np.einsum("vij,nj->nvi", R, X) + t
    xy = np.einsum("vij,nvj->nvi", K, q / q[..., 2:])[..., :2]
    xy += rng.normal(0, 0.5, xy.shape)
    mask = rng.random((N, V)) < K8_SHAPE["present"]
    two = np.argsort(rng.random((N, V)), axis=1)[:, :2]
    mask[np.arange(N)[:, None], two] = True
    xy = np.where(mask[..., None], xy, 0.0)
    w = torch.as_tensor(rng.normal(0, BA_PERTURB["w"], (V, 3)))
    arrays = (K, ba.exp_so3(w).numpy() @ R,
              t + rng.normal(0, BA_PERTURB["t"], (V, 3)),
              X + rng.normal(0, BA_PERTURB["X"], (N, 3)))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    cam = torch.arange(V, dtype=torch.int32, device=device).repeat(N, 1)
    return (ba.BAState(*map(f32, arrays)),
            (cam, f32(xy), torch.as_tensor(mask, device=device)))


def time_k8(root: str) -> int:
    """K8 on the K8_SHAPE problem for the port checkout at `root`: the
    observation index's build (once a ba_run, where the checkout has
    one), the wrapper (given that index), its launch alone into
    preallocated outputs, each CUDA entry's device time from a profiler
    trace of the wrapper, and one LM step (`ba_step_single`, host clock
    after a synchronize, 5 steps from the same state after one warm-up
    step).  Prints one JSON line with the times and digests."""
    import torch
    sys.path.insert(0, os.path.abspath(root))
    from edgegraph3d_tpu_torch import kernels
    from edgegraph3d_tpu_torch.ops import ba
    if not torch.cuda.is_available():
        fail("no CUDA GPU")
    kernels.build()
    kernels.lib()
    state, obs = k8_problem("cuda")
    N, V = state.X.shape[0], state.K.shape[0]
    out = {"root": root, "source": ba.__file__, "card": card_name(),
           "N": N, "V": V, "n_obs": int(obs[2].sum())}
    kw, index = {}, None
    if hasattr(ba, "observation_index"):
        index, out["index_build_ms"] = cuda_time(
            lambda: ba.observation_index(obs[0], obs[2], V), 5)
        kw = {"index": index}
    run = lambda: ba.ba_blocks(state, *obs, **kw)
    blocks, out["wrapper_ms"] = cuda_time(run, 20)
    out["digest"] = [float(getattr(blocks, k).double().abs().sum()) for k in
                     ("Hxx_inv", "gx", "B", "A", "Hcc", "rhs", "resid_sq")]
    out["launch_alone_ms"] = cuda_time(
        k8_launch_alone(ba, kernels, state, obs, blocks, index), 20)[1]
    out["device_ms"] = device_ms_by_kernel(run, 10, r"ba_\w+")
    torch.cuda.synchronize()
    ba.ba_step_single(state, *obs, **kw)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.time()
        ba.ba_step_single(state, *obs, **kw)
        torch.cuda.synchronize()
        walls.append((time.time() - t0) * 1e3)
    out["lm_step_ms"] = walls
    log(json.dumps(out))
    return 0


def check_device_claiming(full, cfg, device="cuda"):
    """Stage 3 of the full scene (with expansion and chain extension)
    with claiming_backend="device" and "host": the same points bit for
    bit, the same counts and counters (but the device backend's own),
    and no fallback to the host pass.  Logs the chunks and their fixpoint
    rounds (the device_claiming_* counters)."""
    import dataclasses

    import numpy as np
    import torch

    from edgegraph3d_tpu_torch.matching import refpoints as rp
    from edgegraph3d_tpu_torch.matching.claiming_device import MAX_ROUNDS
    from edgegraph3d_tpu_torch.pipeline import (PipelineStats,
                                                reconstruct_all_stages)
    from edgegraph3d_tpu_torch.plgs.extraction import extract_plgs

    sfmd, edges, _ = full
    ctx = rp.build_context(sfmd, extract_plgs(edges, cfg), cfg,
                           device=device)
    res = {}
    for backend in ("device", "host"):
        c = dataclasses.replace(ctx, config=cfg.replace(
            claiming_backend=backend))
        stats = PipelineStats()
        torch.cuda.synchronize()
        pts = reconstruct_all_stages(sfmd, c, stats, stages=(3,))
        res[backend] = (pts, stats)
        log(f"  stage 3, claiming_backend={backend}: "
            f"stage3_refpoints_s={stats.timings['stage3_refpoints']:.4f}"
            f" counts {json.dumps(stats.counts)} counters "
            f"{json.dumps(stats.counters)}")
    (pd, sd), (ph, sh) = res["device"], res["host"]
    own = {k: sd.counters.pop(k) for k in list(sd.counters)
           if k.startswith("device_claiming")}
    if own.get("device_claiming_fallback", 0) != 0:
        fail("device claiming fell back to the host pass "
             f"{own['device_claiming_fallback']} times")
    if not own.get("device_claiming_rounds", 0):
        fail("device claiming: the fixpoint never ran")
    log(f"  device claiming: {own['device_claiming_chunks']} chunks, "
        f"{own['device_claiming_rounds']} fixpoint rounds (largest "
        f"{own['device_claiming_rounds_max']} of {MAX_ROUNDS})")
    same = all(np.array_equal(getattr(pd, f), getattr(ph, f))
               for f in ("X", "obs_xy", "obs_mask", "seed_refpoint",
                         "seed_id", "chain_order"))
    if not same or sd.counts != sh.counts or sd.counters != sh.counters:
        fail(f"device claiming: the points or counts differ from the host "
             f"backend's ({len(pd.X)} against {len(ph.X)} points)")
    log(f"  device claiming: {len(pd.X)} points, equal to the host "
        "backend's bit for bit")


def epipolar_median_px(F, sfmd):
    """Median distance (px) of the refpoints' observations on view j to
    the epipolar lines F[i, j] of their observations on view i, over
    every pair (i, j) whose F is not the (0, 0, 1) sentinel."""
    import torch

    from edgegraph3d_tpu_torch.matching import refpoints as rp
    obs_xy, obs_mask = rp.dense_observations(sfmd)
    dev = F.device
    xy = torch.as_tensor(obs_xy, device=dev)
    m = torch.as_tensor(obs_mask, device=dev)
    xh = torch.cat([xy, torch.ones_like(xy[..., :1])], -1)       # [N,V,3]
    V = F.shape[0]
    out = []
    for i in range(V):
        lines = torch.einsum("jab,nb->nja", F[i], xh[:, i])      # [N,V,3]
        d = (lines * xh).sum(-1).abs() / torch.clamp_min(
            lines[..., :2].norm(dim=-1), 1e-20)                   # [N,V]
        ok = m[:, i:i + 1] & m & (F[i, :, :2].abs().sum((-2, -1)) > 0)
        ok[:, i] = False
        out.append(d[ok])
    return float(torch.cat(out).median())


def check_lmeds(full, cfg, device="cuda"):
    """The LMedS F table of the full scene: its time and the median
    epipolar distance of the refpoint observations under it and under
    the exact table."""
    import torch

    from edgegraph3d_tpu_torch.matching import refpoints as rp
    from edgegraph3d_tpu_torch.ops.geometry import all_fundamental_matrices

    sfmd = full[0]
    torch.cuda.synchronize()
    t0 = time.time()
    F_lm = rp.lmeds_fundamental_table(sfmd, cfg, device=device)
    torch.cuda.synchronize()
    wall = time.time() - t0
    F_ex = all_fundamental_matrices(sfmd.P, sfmd.center).to(device)
    med_lm, med_ex = epipolar_median_px(F_lm, sfmd), \
        epipolar_median_px(F_ex, sfmd)
    n_sent = int((F_lm[..., :2, :].abs().sum((-2, -1)) == 0).sum()) - \
        sfmd.n_cameras
    log(f"  LMedS F table: {sfmd.n_cameras ** 2 - sfmd.n_cameras} pairs, "
        f"{sfmd.n_points} refpoints, {wall:.4f} s, {n_sent} sentinel "
        f"pairs; median epipolar distance {med_lm:.6g} px (exact table "
        f"{med_ex:.6g} px)")
    if not bool(torch.isfinite(F_lm).all()) or not med_lm < 0.5:
        fail(f"LMedS F table: not finite, or median epipolar distance "
             f"{med_lm} px >= 0.5")


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
    from edgegraph3d_tpu_torch.core import sfm as sfm_io
    from edgegraph3d_tpu_torch.matching import refpoints as rp
    from edgegraph3d_tpu_torch.plgs.extraction import extract_plgs

    t_start = time.time()
    log("== phase 1: card and build")
    card = card_name()
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
    compare_stage12_kernels(ctx, full[0], results)
    compare_expansion(ctx, full[0], results)
    check_large_tables(ctx, full[0])
    del ctx
    torch.cuda.empty_cache()

    log("== phase 3: main path, cube8 trend workload")
    cube = cube8_scene()
    run_main_path("cube8 stage 3", cube, 2, stages=(3,))
    _, counts = run_main_path("cube8 edge_matching", cube, 2,
                              via_files=True)
    if counts.get("stage1_sweep", 0) <= 0:
        fail(f"cube8 edge_matching: stage 1 made no points: {counts}")
    launches, counts = run_main_path(
        "cube8 stage-2 sets", cube, 2,
        config=bench_config().replace(closeness_max_dist_ratio=1e6))
    if counts.get("stage2_closeness_graph", 0) <= 0:
        fail(f"cube8 stage-2 sets: stage 2 made no match sets: {counts}")

    log("== phase 4: main path, full-scale workload, stages (1, 2, 3)")
    work = tempfile.mkdtemp(prefix="eg3d_smoke_")
    try:
        launches, counts = run_main_path("full", full, None,
                                         working_folder=work)
        if counts.get("stage1_similarity_graph", 0) <= 0 \
                or counts.get("stage1_sweep", 0) <= 0:
            fail(f"full: stage 1 made no match sets or no points: {counts}")
        missing = [k for k in kernels.MAIN_PATH_KERNELS if launches[k] <= 0]
        if missing:
            fail(f"kernels not launched on the main path: {missing}")

        log("== phase 6: optional paths (joint BA, device claiming, "
            "LMedS F)")
        t0 = time.time()
        aug = sfm_io.read_sfm_data(os.path.join(work,
                                                "before_filtering.json"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches["ba_blocks"] = check_joint_ba(aug, results)
    del aug
    torch.cuda.empty_cache()
    # torch.profiler's CUDA trace has come back empty in this process
    # after phase 4 (PERF.md section 7), so K8's kernels are also timed
    # alone in a fresh process
    k8 = subprocess.run([sys.executable, os.path.abspath(__file__),
                         "--time-k8", HERE], capture_output=True,
                        text=True, timeout=600)
    if k8.returncode != 0:
        fail(f"--time-k8 failed ({k8.returncode}): {k8.stdout[-2000:]} "
             f"{k8.stderr[-2000:]}")
    log(f"  K8 alone in a fresh process: {k8.stdout.strip().splitlines()[-1]}")
    check_device_claiming(full, cfg)
    check_lmeds(full, cfg)
    ba_launches, _ = run_main_path(
        "cube8 LMedS F + joint BA", cube, 2,
        config=bench_config().replace(fmat_source="lmeds", ba_steps=2))
    if ba_launches["ba_blocks"] != 2:
        fail(f"cube8 joint BA: K8 launched {ba_launches['ba_blocks']} "
             "times in 2 steps")
    log(f"phase 6 wall {time.time() - t0:.1f}s")

    kern = [dict(name=k, route="cuda", source=KERNEL_META[k][0],
                 replaces=KERNEL_META[k][1], launches=launches[k],
                 **results[k]) for k in kernels.KERNEL_NAMES]
    log(f"total smoke wall {time.time() - t_start:.1f}s")
    log(json.dumps({"kernels": kern}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def time_k7_chunk(root: str) -> int:
    """K7 alone on the first 4,096 stage-3 chains of the full scene
    (unsorted, the chunk both K7 designs run), for the port checkout at
    `root`: first after one warm-up call (the yardstick of earlier
    versions of this script), then with `cuda_time`'s 0.25 s warm-up.
    Prints one JSON line with both times and a digest of the outputs."""
    import inspect

    import torch
    sys.path.insert(0, os.path.abspath(root))
    from edgegraph3d_tpu_torch import kernels
    from edgegraph3d_tpu_torch.matching import expansion, matches
    from edgegraph3d_tpu_torch.matching import refpoints as rp
    from edgegraph3d_tpu_torch.plgs.extraction import extract_plgs
    if not torch.cuda.is_available():
        fail("no CUDA GPU")
    kernels.build()
    kernels.lib()
    sfmd, edges, _ = full_scene()
    cfg = bench_config()
    ctx = rp.build_context(sfmd, extract_plgs(edges, cfg), cfg,
                           device="cuda")
    mgr = matches.MatchesManager(ctx.plg_length.cpu().numpy())
    round0, _ = rp.compute_and_follow_seeds(sfmd, ctx)
    X, obs3, cams3, _, seed_ids, orders = rp.sweep_seeds(
        None, None, ctx, mgr, precomputed=round0)
    args, extent = _first_chains(ctx, X, obs3, cams3, seed_ids, orders)
    params = inspect.signature(expansion.expand_chains_compact).parameters
    kw = {"extent": extent} if "extent" in params else {}
    run = lambda: expansion.expand_chains_compact(*args, **kw)
    _, ms_one = cuda_time(run, 5, warm_s=0.0)
    (Xk, xyk, okk), ms = cuda_time(run, 5)
    log(json.dumps({
        "root": root, "source": expansion.__file__, "card": card_name(),
        "chains": args[-2], "points": int(Xk.shape[0]),
        "ms_after_one_warmup_call": ms_one, "ms": ms,
        "out_ok_sum": int(okk.sum()),
        "out_xy_sum": float(xyk.double().sum()),
        "X_sum": float(Xk.double().sum())}))
    return 0


def time_follow(root: str) -> int:
    """K3 and the follow for the port checkout at `root`, on phase 2's
    inputs (the same seeds and the same K3 rows): K3 in its O = 3 and
    O = V bodies, follow_seeds on the first refpoint chunk's seeds in both
    driving directions (the direction trials, the walk and whatever the
    checkout runs between them), and each K4 launch of that call alone
    with its arguments as captured (in an earlier checkout K4 walks
    only, and K3 then triangulates).  Prints one JSON line with the
    times, the launches of one follow_seeds call and digests."""
    import torch
    sys.path.insert(0, os.path.abspath(root))
    from edgegraph3d_tpu_torch import kernels
    from edgegraph3d_tpu_torch.matching import following
    from edgegraph3d_tpu_torch.matching import refpoints as rp
    from edgegraph3d_tpu_torch.ops import triangulation
    from edgegraph3d_tpu_torch.plgs.extraction import extract_plgs
    if not torch.cuda.is_available():
        fail("no CUDA GPU")
    kernels.build()
    kernels.lib()
    sfmd, edges, _ = full_scene()
    cfg = bench_config()
    ctx = rp.build_context(sfmd, extract_plgs(edges, cfg), cfg,
                           device="cuda")
    out = {"root": root, "source": following.__file__, "card": card_name()}
    V = ctx.P_mats.shape[0]
    for O, warm in ((3, False), (V, True)):
        a, X0, iters, n = k3_inputs(ctx, sfmd, O, warm)
        (X, _, ok), ms = cuda_time(lambda: triangulation.triangulate_gn(
            *a, X0=X0, max_iters=iters, accept_mse=cfg.match_gn_max_mse), 5)
        out[f"k3_O{O}_ms"] = ms
        out[f"k3_O{O}_digest"] = [int(ok.sum()),
                                  float(X[ok].double().sum())]
    M = cfg.max_candidates_per_view
    obs_xy, obs_mask = rp.dense_observations(sfmd)
    om = torch.as_tensor(obs_mask[:1024], device=ctx.device)
    oxc = torch.as_tensor(obs_xy[:1024], device=ctx.device)
    starts = rp._start_sweep(ctx, oxc, om, cfg.detection_starting_dist_px, M)
    both, drive = follow_seed_tuples(ctx, starts, oxc, om, M)
    run = lambda: following.follow_seeds(
        both, ctx.plg_coords, ctx.plg_length, ctx.P_mats, ctx.F_table, drive,
        cfg, cfg.max_follow_steps)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    run()
    torch.cuda.synchronize()
    out["follow_seeds_launches"] = {k: kernels.LAUNCHES[k] for k in (
        "follow_walk", "triangulate_gn")}
    res, out["follow_seeds_ms"] = cuda_time(run, 10)
    out["follow_digest"] = [int(res.n_steps.sum()),
                            float(res.X[res.valid].double().sum())]
    out["follow_lanes"] = len(both.cams)
    for i, fargs in enumerate(captured_follow_walks(ctx, both, drive)):
        _, out[f"k4_launch{i}_ms"] = cuda_time(
            lambda: following.follow_walk(*fargs), 10)
    log(json.dumps(out))
    return 0


def time_k1_k6(root: str) -> int:
    """K1 and K6 at phase 2's shapes for the port checkout at `root`: K1
    at the _start_sweep shape (every (refpoint, view) of the full scene,
    M = 4) as its wrapper, its launch alone and its device time
    (k1_times), and K6 on the first 64 stage-1 match sets (8 members,
    S = 24) as its wrapper and its device time.  Prints one JSON line
    with the times and digests of the outputs."""
    import torch
    sys.path.insert(0, os.path.abspath(root))
    from edgegraph3d_tpu_torch import kernels
    from edgegraph3d_tpu_torch.matching import detection, polyline_stages
    from edgegraph3d_tpu_torch.matching import refpoints as rp
    from edgegraph3d_tpu_torch.ops import gather
    from edgegraph3d_tpu_torch.plgs.extraction import extract_plgs
    if not torch.cuda.is_available():
        fail("no CUDA GPU")
    kernels.build()
    kernels.lib()
    sfmd, edges, _ = full_scene()
    cfg = bench_config()
    ctx = rp.build_context(sfmd, extract_plgs(edges, cfg), cfg,
                           device="cuda")
    out = {"root": root, "source": detection.__file__, "card": card_name()}
    obs_xy, _ = rp.dense_observations(sfmd)
    N, V = obs_xy.shape[:2]
    view = torch.arange(V, dtype=torch.int32, device=ctx.device).repeat(N)
    pts = torch.as_tensor(obs_xy, device=ctx.device).reshape(N * V, 2)
    M = cfg.max_candidates_per_view
    args = (ctx.grids, view, pts, ctx.cell, cfg.detection_starting_dist_px,
            M)
    got = detection.grid_topm_query(*args)
    out["k1"] = k1_times(args, got)
    out["k1_digest"] = [int(got.valid.sum()),
                        float(got.dist[got.valid].double().sum())]
    groups = polyline_stages.similarity_match_sets(sfmd, ctx)
    cam, pl, msk = (torch.as_tensor(a[:64], device=ctx.device) for a in
                    polyline_stages._member_table(groups, 8))
    Vp, P, L, _ = ctx.plg_coords.shape
    cs, ps = cam.clamp_min(0).long(), pl.clamp_min(0).long()
    coords = gather.gather_rows(ctx.plg_coords.reshape(Vp * P, 2 * L),
                                (cs * P + ps).reshape(-1)) \
        .reshape(*cam.shape, L, 2)
    lengths = torch.where(msk, ctx.plg_length[cs, ps], 0).to(torch.int32)
    k6 = lambda: polyline_stages.group_seed_sample(
        coords, lengths, cam, msk, ctx.F_table, 24,
        cfg.split_interval_distance_px)
    res, out["k6_ms"] = cuda_time(k6, 50)
    out["k6_device_ms"] = device_ms(k6, 20, "group_seed")
    out["k6_groups"] = int(cam.shape[0])
    out["k6_digest"] = [int(res[3].sum()), int(res[7].sum()),
                        float(res[4][res[7]].double().sum())]
    log(json.dumps(out))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--time-k8":
        sys.exit(time_k8(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--time-k1-k6":
        sys.exit(time_k1_k6(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--time-k7-chunk":
        sys.exit(time_k7_chunk(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--time-follow":
        sys.exit(time_follow(sys.argv[2]))
    sys.exit(main())
