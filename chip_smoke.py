"""GPU smoke test of the PyTorch / CUDA port (edgegraph3d_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU (an H100: the kernels are built for sm_90a) and nvcc.
Phases, each of which must pass or the script exits non-zero without
its final `ok` line:

  1. card and build: the card's name and power limit, then the nine
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
     K2 runs as the seeding calls it (its queries visited view-major in
     tiles of rows), with its neighbourhood counts logged, and its
     launch alone in each body (shared neighbourhoods, at several
     `min_share`; one thread a query, the body K7's "epipolar" mode
     runs) and visiting order (k2_variants), each identical to the
     wrapper's result.  K3 runs its O = 3 register
     body and its general body (O = 49, 30% of the observations present
     at random), with the mean GN iterations and the mean of each warp's
     slowest row logged; K4 runs both launches of one follow_seeds call
     on the first refpoint chunk's seeds (the direction trials, GN warm
     from the seed, T = 1; the walk, DLT + GN, max_follow_steps), each
     against its plain twin (the walk, the GN over the live steps, the
     cut at the first GN failure) with 0 decision mismatches allowed and
     X within 1e-4 relative.  K5 gather_rows, in a fresh process
     (--time-k5), must be bit-equal to `table[rows]` at the Pallas
     probe's shape (int32 indices), at the chain-extension shape (int64)
     and at phase 9(a)'s f64 extension shape, and again with the indices
     in the other type, each timed over 200 calls per event pair as its
     wrapper and its launch alone, and by device time (the kernels
     line's `ms` for K5 and K5 f64 is the device time; `table[rows]`'s
     device time is its `library_ms`); K6
     group_seed_sample runs on the full scene's stage-1 match sets, with
     0 decision mismatches allowed.
     K7 expand_chains runs the whole expansion of the full scene's
     stage-3 chains and of the first chain-extension round's chains, as
     refpoints.chain_chunks hands them over (one chunk on the card) and
     the wrapper launches them (one launch per tile bucket, each on a
     stream of its own), each bit-equal to its plain version (the old
     per-view loop around K1 and K3, so its time is the old path's).  The
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
     checkout, run in a fresh process (each of K8's kernels' device time:
     this process's profiler traces have come back empty after phase 4,
     and no device time is ever read from an empty trace; a trace without
     the kernel fails the run).  Device claiming: stage 3 of the full
     scene (with expansion and chain extension) with claiming_backend
     "device" and "host", bit-equal points, equal counts and counters
     (but the device backend's own), and no fallback to the host pass;
     the chunks, their fixpoint rounds and both stage3_refpoints times
     are logged.  The LMedS F
     table of the full scene: its time, and the median epipolar
     distance of the refpoint observations under it (< 0.5 px) and
     under the exact table.  K9 lmeds7_fit (`check_lmeds7`) on the full
     scene's OpenCV FM_LMEDS table (every ordered pair, 300 samples),
     against its plain twin on the same samples on the card, fit a chunk
     of pairs at a time as the plain route fits them: no pair valid on
     one side only, the samples' models counted alike within
     DECISION_TOL of the samples, the same winning sample on at least
     0.9 of the pairs, F within 1e-8 per entry where the sample is the
     same and the scores within 0.02 relative (the tolerances of
     tools/check_fmat_on_card.py, which a float32 solve fails), the
     inlier flags that differ logged; K9's ms, its bound and the plain
     route's ms; then the full scene's stage 3 with
     fmat_source="opencv_lmeds", under the quality gates, with K9's
     launches read from that run and its fmat_pairs_kernel counter
     equal to the pairs.  Last, cube8 through run_pipeline with
     fmat_source="lmeds" and ba_steps=2 (K8 launched twice), under the
     quality gates;
  7. the debug images and the host tools on cube8 (phase 3's scene
     files): the command line with `-i` (its default configuration),
     then `edge_matching(debug_images=True)` with
     closeness_max_dist_ratio=1e6 (stage-2 sets, so every family is
     drawn), each with the launch counts set to 0 just before it and
     read just after, under the quality gates; K1 and K2 must launch
     inside the `debug_images` span (save_debug_images, wrapped to read
     the counts and the wall), and the working folder must hold every
     image family save_debug_images writes, one image per view a set;
     then draw_detection_process for refpoints 0-2 on a CUDA context
     (K1, K2) and on a CPU context of the same arrays (their plain
     versions): equal candidate ids and masks, coordinates within
     1e-3 px, equal images; `json_to_ply --images` on the -i run's
     output JSON (as many colored vertices as points) and
     `coordinate_system_transform` onto a seeded similarity of the
     camera centers and back (within 1e-6 scene units);
  8. the mesh (edgegraph3d_tpu_torch/parallel), after phase 7.  (a) One
     process, a mesh of MESH_SHARDS shards on cuda:0 (and, where there
     are more cards, a mesh over all of them): the full scene's default
     stages and cube8's stage 3 through run_pipeline(mesh=...), each with
     the launch counts set to 0 just before it and read just after,
     against phases 4 and 3 (the same points, view lists equal, points
     within 1e-5), every main-path kernel launched and every shard
     launching K1-K4 and K7 (the per-shard counts logged); stage 3 of the
     full scene with device claiming sharded over the mesh, bit-equal to
     phase 6's host claiming; one shard's K4 launches (the direction
     trials and the walk) on its block of the first refpoint chunk's
     seeds against the plain twin (0 decision mismatches); 3 steps of
     the distributed BA on phase 6's perturbed augmented scene against 3
     of the single-device ba_run (MESH_BA_TOL), K8 launched 3 times on
     every shard, and one shard's K8 blocks against the plain version
     (BA_BLOCK_TOL).  (b) Two processes on cuda:0 joined over gloo (the
     `--mesh-worker` mode below), 2 shards each: the sharded GN on
     cube8's refpoints, 2 steps of the distributed BA on the K8_SHAPE
     problem and cube8's stage 3 through run_pipeline(mesh=global_mesh());
     both processes must agree bit for bit, the GN and stage 3 with the
     one-process runs of (a) bit for bit, the BA with (a)'s mesh within
     MESH_BA_TOL.  (c) The same with an NCCL group of one process per
     card.  The phase's wall is logged with the card's name and power
     limit;
  9. float64 on stage 3 (EdgeGraphConfig(dtype="float64"), which runs
     stage 3 only), after phase 8.  (a) The full scene's f64 context
     (P, F and the polylines in f64, the grids in f32): each f64
     instantiation against its plain twin in f64 on the card at phase
     2's shapes, 0 decision mismatches and coordinates within
     F64_COORD_TOL: K1 with f64 points, K2 with f64 lines over the f32
     starts, K3's O = 3 body (cold) and its general body (the padded
     loop, O = 49, warm), K4's two launches of one follow_seeds call
     (K5's f64 body is checked and timed at this shape in phase 2), and
     K7 over
     the full scene's f64 stage-3 expansion (bit-equal); each logged
     with its kernel / plain ms and its f64 bound.  (b) The full scene
     through run_pipeline(stages=(3,)) in f64 and in f32, each under the
     quality gates: every f64 instantiation launched in the f64 run,
     and the f64 edge-point count, its view-list flips against the f32
     run (points matched by position) and both walls logged; K7 in
     "epipolar" mode on the same chains in (a), its f64 table (61,152 B)
     opted in to shared memory above 48 KiB.  (c)
     cube8 stage 3 in f64 on MESH_SHARDS shards of cuda:0, bit-equal to
     the single-device f64 run.  The JSON line gains one entry per f64
     instantiation, its launches from (b), its mesh_launches from (c).

Each kernel's bound is the larger of the bytes it must move (each input
read once, each output written once) over 3.35 TB/s and its operations
over the peak rate of their type, 67 TFLOP/s in f32 and 34 TFLOP/s in
f64 (an H100 SXM's published peaks outside the tensor cores), both
counted from this run's inputs with the per-item costs in FLOPS below
(the same counts for an f64 operation as for an f32 one).

Prints one JSON line of per-kernel results and, as its last line,
{"ok": true, "device": {...}}.  Imports nothing of JAX.

    python3 chip_smoke.py --time-k7 ROOT

times K7 for the port checkout at ROOT (e.g. an unpacked `git archive`
of an earlier commit), so that two versions of K7 are timed with one
yardstick in one call: in f32 and f64 on the full scene, the K7
launches of one stage-3 expand_and_assemble call and of the first
chain-extension call, and each tile bucket of the stage-3 chains alone,
by device time from profiler traces (per launch, their sum, and the
time in which some K7 kernel ran), with the host wall of each call, the
bound of its work, its chains and warps per launch and digests of its
outputs (`time_k7`); it prints one JSON line and skips every check.

    python3 chip_smoke.py --time-k2 ROOT

times K2 of the checkout at ROOT and of this tree in fresh processes,
in turns (ROOT, this, this, ROOT; `--time-k2-checkout`): in f32 and f64
on the full scene, phase 2's shape and each launch of the main path's
seeding through the wrapper, and the one-thread body's launch alone in
the caller's order, by device time from profiler traces, with the bound
and an exact digest of every output, which must equal ROOT's; this
tree's process also runs k2_variants.

    python3 chip_smoke.py --time-follow ROOT

does the same for K3 (phase 2's two shapes) and the follow (one
follow_seeds call on phase 2's seeds, and each of its K4 launches).

    python3 chip_smoke.py --time-k1-k6 ROOT

does the same for K1 (its wrapper, its launch alone into preallocated
outputs and its device time, at phase 2's M = 4 shape) and K6 (its
wrapper and device time on the first 64 stage-1 match sets).

    python3 chip_smoke.py --time-k5 ROOT

does the same for K5 at the probe's shape, phase 2's extension shape
and phase 9(a)'s f64 extension shape: its wrapper, its launch alone
into a preallocated output, its device time, and table[rows] by events
and by device time, with the bound and a digest of each output.

    python3 chip_smoke.py --time-k8 ROOT

does the same for K8 on a seeded problem of phase 6's shape (K8_SHAPE:
61,008 points, 49 views, dense, ~34.5 views a point): the observation
index's build, the wrapper, its launch alone into preallocated outputs,
each CUDA entry's device time and one LM step's wall; it needs no phase
4, so an earlier checkout and this one compare in one call.

    python3 chip_smoke.py --check-k9

runs phase 6's K9 check alone on the full scene (`check_lmeds7`), its
gates included, and prints its results as one JSON line.

    python3 chip_smoke.py --mesh-worker RANK WORLD PORT OUT [BACKEND]

is one process of phase 8(b) (BACKEND gloo, the default) or (c) (nccl):
it joins a group of WORLD processes at localhost:PORT as RANK and writes
its results to OUT (npz); phase 8 starts and waits for them.

    python3 chip_smoke.py --mesh-cards

runs phase 8 across every card of a machine with two or more, alone
(`mesh_cards`): one shard a card in one process, and an NCCL group of
one process a card, each against the one-card runs; it also times the
full scene's stage-3 seeding and following with the shards stepped
together against one after another (`time_shard_steps`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))

# full-scale workload (the benchmark's build_full_workload)
FULL_VIEWS, FULL_REFPOINTS, WIDTH, HEIGHT = 49, 6268, 1600, 1200
DECISION_TOL = 1e-4          # fraction of rows whose decisions may differ
COORD_TOL_PX = 1e-3
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12       # H100 SXM f32, outside the tensor cores
PEAK_F64_FLOPS = 34e12       # H100 SXM f64, outside the tensor cores
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
    # K9 replaces no TPU kernel: the port's plain FM_LMEDS route
    "lmeds7_fit": ("edgegraph3d_tpu_torch/csrc/lmeds7_fit.cu",
                   "edgegraph3d_tpu_torch/ops/geometry.py:531"),
}
#: f64 operations of one OpenCV epipolar error as K9 forms it (err_bits:
#: 12 fused multiply-adds, two squared norms, r * r, a division, a min)
K9_ERROR_FLOPS = 33


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    log(f"FAIL: {msg}")
    sys.exit(1)


def card_names() -> list:
    """Each card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return smi.stdout.strip().splitlines()


def card_name() -> str:
    """The first card's name and power limit."""
    return (card_names() or [""])[0]


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


def bound(n_bytes: float, flops: float, peak: float = PEAK_F32_FLOPS):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    the operations over the peak rate of their type (f32 by default;
    PEAK_F64_FLOPS for the f64 bodies)."""
    t_b = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_f = flops / peak * 1e3
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
    """Operations of GN (and DLT when cold) over the live observations
    of every row, at `iters` mean iterations."""
    live = float(mask.sum())
    rows = mask.shape[0]
    f = iters * (FLOPS["gn_obs"] * live + FLOPS["gn_iter"] * rows)
    if cold:
        f += FLOPS["dlt_obs"] * live + FLOPS["dlt_solve"] * rows
    return f


def record_into(results, name, mism, rows, err, ms, plain_ms, err_tol,
                gated=None, exact=False, work=(0.0, 0.0), library_ms=None,
                peak=PEAK_F32_FLOPS):
    """Log and gate one kernel's comparison.  `gated` is the error held
    against err_tol (default: err); `exact` allows no decision mismatch
    at all (else DECISION_TOL of the rows); `mism` None: the kernel's
    decisions are not among its outputs, and none is compared.  `work`
    is (bytes, operations) for the bound, the operations at `peak`."""
    gated = err if gated is None else gated
    bound_ms, bound_by = bound(*work, peak=peak)
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


#: profiler traces taken of one measurement before its device time falls
#: back to CUDA events: on the H100 machine a trace has come back with no
#: CUDA entry at all, up to twice in a row, in a fresh process too
PROFILE_TRIES = 6


def device_ms_by_kernel(fn, reps: int, pattern: str, need=None):
    """{kernel: mean device ms per call of fn()} for every CUDA entry of
    one torch.profiler trace of `reps` calls (kernels, memsets, copies),
    each named by its match of the regular expression `pattern`, or by
    its first 48 characters.  A trace without any CUDA entry, or without
    one of the names in `need`, is taken again, up to PROFILE_TRIES
    times; no device time is read from it.  Returns None when every
    trace came back so."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_TRIES + 1):
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
        if out and (need is None or any(out.get(k, 0.0) > 0 for k in need)):
            return out
        log(f"  device_ms_by_kernel: trace {attempt} without "
            f"{list(need) if need else 'a CUDA entry'} ({len(out)} CUDA "
            f"entries: {list(out)[:6]})")
    return None


def device_ms(fn, reps: int, name) -> float:
    """Mean device time per call of fn() of the CUDA kernels whose name
    holds `name` (or one of a tuple of names), from a trace of
    device_ms_by_kernel.  When every trace lacks them, the time of the
    whole of fn() between two CUDA events on its stream instead (logged
    so): the profiler failed, not the kernel."""
    import re
    names = (name,) if isinstance(name, str) else tuple(name)
    times = device_ms_by_kernel(fn, reps, "|".join(map(re.escape, names)),
                                need=names)
    if times is None:
        ms = cuda_time(fn, reps)[1]
        log(f"  device_ms: {PROFILE_TRIES} profiler traces without "
            f"{names}; timed by CUDA events instead: {ms:.4f} ms")
        return ms
    return sum(v for k, v in times.items() if k in names)


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


def k2_phase2_args(ctx, sfmd):
    """K2 at the _seed_from_starts shape: the starts of the first
    refpoint chunk (1,024 refpoints, every viewing camera) x every view,
    start-major as the seeding issues them.  Returns (K2's arguments,
    the starts, the chunk's observations and observation mask, the
    number of queries on a view that does not observe their refpoint)."""
    import torch

    from edgegraph3d_tpu_torch.matching import refpoints as rp
    from edgegraph3d_tpu_torch.ops.geometry import epipolar_line
    cfg = ctx.config
    dev = ctx.device
    M = cfg.max_candidates_per_view
    obs_xy, obs_mask = rp.dense_observations(sfmd)
    N, V = obs_mask.shape
    om = torch.as_tensor(obs_mask[:min(1024, N)], device=dev)
    oxc = torch.as_tensor(obs_xy[:min(1024, N)], device=dev)
    starts = rp._start_sweep(ctx, oxc, om, cfg.detection_starting_dist_px, M)
    K = len(starts["ridx"])
    lines = epipolar_line(ctx.F_table[starts["vs"]],
                          starts["xy"][:, None, :])
    radius = torch.clamp_min(torch.clamp_max(starts["dist"] * 3.0, 30.0),
                             3.0).repeat_interleave(V)
    view2 = torch.arange(V, dtype=torch.int32, device=dev).repeat(K)
    args2 = (ctx.grids, view2, oxc[starts["ridx"]].reshape(K * V, 2),
             lines.reshape(K * V, 3), radius, ctx.cell, M)
    return args2, starts, oxc, om, int((~om[starts["ridx"]]).sum())


def k2_bytes(args, n_cells: int) -> float:
    """Bytes K2 must move: each query's view, point, line and radius,
    its [M] row of every output (pl, seg, t, xy, dist, valid) and each
    distinct grid cell once."""
    grids, view, pts, lines, radius, _, M = args
    q_in = 4 + 2 * pts.element_size() + 3 * lines.element_size() \
        + radius.element_size()
    q_out = M * (4 + 4 + 1 + 4 * lines.element_size())
    return len(view) * (q_in + q_out) + n_cells * grids.shape[3] * 24


def k2_neighbourhoods(args, unobserved: int) -> dict:
    """The sharing K2 can exploit: the queries, their distinct (view,
    cell) neighbourhoods (the 5x5 cells a query reads depend on nothing
    else), queries a neighbourhood (mean, max), the share of queries on
    a view that does not observe their refpoint (point (0, 0)) and the
    non-empty slots a query reads (mean)."""
    import torch
    grids, view, pts, _, _, cell, _ = args
    V, GH, GW = grids.shape[:3]
    c = torch.nan_to_num(pts / cell, nan=0.0).clamp(-1e9, 1e9).trunc().long()
    key = (view.long() * GH + c[:, 1].clamp(0, GH - 1)) * GW \
        + c[:, 0].clamp(0, GW - 1)
    _, counts = torch.unique(key, return_counts=True)
    entries, _ = grid_work(grids, view, pts, cell, 2)
    Q = len(view)
    return dict(queries=Q, neighbourhoods=len(counts),
                queries_per_neighbourhood_mean=Q / max(1, len(counts)),
                queries_per_neighbourhood_max=int(counts.max()),
                unobserved_share=unobserved / max(1, Q),
                nonempty_slots_per_query=entries / max(1, Q))


def k2_digest(c) -> list:
    """An exact digest of each output of a Candidates: the sum of its
    elements' bits weighted by position (int64, wrapping)."""
    import torch
    out = []
    for t in c:
        x = t.reshape(-1)
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        bits = x.view({1: torch.uint8, 4: torch.int32,
                       8: torch.int64}[x.element_size()]).long()
        w = torch.arange(len(x), device=x.device) % 65521 + 1
        out.append(int((bits * w).sum()))
    return out


#: K2's bodies by the C entry's `body`
K2_BODIES = {"shared": 0, "one thread": 1}


def k2_launch(args, out, body: str, order=None, n_rows: int = 0,
              tile_rows: int = 0, min_share: int = 0, exclude=None):
    """One launch of K2's C entry alone into the preallocated Candidates
    `out`, as the wrapper makes it: `body` "one thread" (the body K7's
    "epipolar" mode runs) or "shared" (the shared-neighbourhood body,
    with `min_share`), the queries visited in `order` (or view-major in
    tiles of `tile_rows` rows by `n_rows`, or as given).  Works with the C
    entries of this tree and of the checkouts before the shared body,
    whose entry takes a one_thread flag (0: eight lanes a query,
    body "8 lanes") and no n_rows, tile_rows or min_share."""
    import torch

    from edgegraph3d_tpu_torch import kernels
    from edgegraph3d_tpu_torch.matching import detection
    grids, view, pts, lines, radius, cell, M = args
    V, GH, GW, Kc, _ = grids.shape
    f64 = lines.dtype == torch.float64
    if radius.dtype != lines.dtype:
        fail("k2_launch: the radius must come in the lines' type, as the "
             "wrapper widens it")
    lib = kernels.lib()
    entry = lib.eg3d_epipolar_topm_f64 if f64 else lib.eg3d_epipolar_topm
    pts_arg = (pts.data_ptr(), int(pts.dtype == torch.float64)) if f64 \
        else (pts.data_ptr(),)
    use = exclude is not None
    tail = (int(use), float(exclude) if use else 0.0,
            *detection._out_ptrs(out), kernels.stream_of(pts))
    o = None if order is None else order.data_ptr()
    if len(kernels._SIGNATURES["eg3d_epipolar_topm"]) == 23:
        if body.startswith("shared") or n_rows:
            fail("k2_launch: this checkout has no shared body")
        mid = (o, len(view), float(cell), M, int(body == "one thread"))
    else:
        mid = (o, n_rows, tile_rows, len(view), float(cell), M,
               K2_BODIES[body], min_share)
    rc = entry(grids.data_ptr(), V, GH, GW, Kc, view.data_ptr(), *pts_arg,
               lines.data_ptr(), radius.data_ptr(), *mid, *tail)
    kernels.check(rc, "epipolar_topm_query")


def k2_variants(args2, want, unobserved: int, full: bool = True):
    """K2's launch alone, at phase 2's shape, in its two bodies (the
    shared-neighbourhood body, the wrapper's; one thread a query, the
    body K7's "epipolar" mode runs) and visiting orders: as the caller
    issues the queries (start-major), view-major by arithmetic in the
    wrapper's tiles, in tiles of 512 and 2,048 rows and in one tile, and
    sorted by (view, cell) (the wrapper's plan for other callers); the
    shared body also with every group staged (`min_share` 1) and none
    (33); each identical to the wrapper's result `want`.  `full` False
    times the shared body in the wrapper's plan and the one-thread
    body's yardstick only.  The sort is timed apart.  Logs the
    neighbourhood counts first (k2_neighbourhoods)."""
    import torch

    from edgegraph3d_tpu_torch.matching import detection

    grids, view, pts, lines, radius, cell, M = args2
    args2 = (*args2[:4], radius.to(lines.dtype), *args2[5:])
    V = grids.shape[0]
    Q = len(view)
    log(f"  epipolar_topm_query neighbourhoods: "
        f"{json.dumps(k2_neighbourhoods(args2, unobserved))}")
    order, ms = cuda_time(lambda: detection.k2_plan(grids, view, pts, cell,
                                                    False)[0], 5)
    log(f"  epipolar_topm_query order by view+cell: sort_ms={ms:.4f}")
    tr = detection.K2_TILE_ROWS
    orders = {"start-major": (None, 0, 0), "view-major": (None, Q // V, 0),
              "view+cell": (order, 0, 0)}
    orders.update({f"tiles of {t}": (None, Q // V, t)
                   for t in (tr, 512, 2048)})
    ms2, wrapper = detection.K2_MIN_SHARE, f"tiles of {tr}"
    plan = [("one thread", 0, "start-major"), ("shared", ms2, wrapper)]
    if full:
        plan += [("one thread", 0, wrapper)] \
            + [("shared", ms2, o) for o in orders
               if o not in ("start-major", wrapper)] \
            + [("shared", ms2, "start-major"), ("shared", 1, wrapper),
               ("shared", 33, wrapper)]
    out = detection._empty_outputs(Q, M, pts.device, lines.dtype)
    for body, min_share, name in plan:
        order, n_rows, tile_rows = orders[name]
        for t in out:
            t.fill_(7)                    # every slot must be rewritten
        _, ms = cuda_time(lambda: k2_launch(args2, out, body, order, n_rows,
                                            tile_rows, min_share), 5)
        same = all(torch.equal(a, b) for a, b in zip(out, want))
        log(f"  epipolar_topm_query {lines.dtype} body={body} "
            f"min_share={min_share} order={name}: launch_ms={ms:.4f} "
            f"identical={same}")
        if not same:
            fail(f"epipolar_topm_query: body {body}, min_share {min_share}, "
                 f"{name} order, differs from the wrapper's result")


def compare_kernels(ctx, sfmd):
    import torch

    from edgegraph3d_tpu_torch.matching import detection, following
    from edgegraph3d_tpu_torch.matching import refpoints as rp
    from edgegraph3d_tpu_torch.ops import triangulation

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

    # K2 at the _seed_from_starts shape, as the seeding calls it
    args2, starts, oxc, om, unobserved = k2_phase2_args(ctx, sfmd)
    got, ms = cuda_time(lambda: detection.epipolar_topm_query(
        *args2, view_cycle=True), 5)
    ref, pms = cuda_time(lambda: detection._epipolar_topm_plain(*args2), 1)
    mism, err, rows = _cand_diff(got, ref)
    k2_variants(args2, got, unobserved)
    entries, cells = grid_work(ctx.grids, args2[1], args2[2], ctx.cell, 2)
    record("epipolar_topm_query", mism, rows, err, ms, pms, COORD_TOL_PX,
           work=(k2_bytes(args2, len(cells)),
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


def follow_work(ctx, args, T, walk, gn, ref, fs=4):
    """(bytes, operations) of one K4 call from this run's counts, and
    the counts: the walk steps tried, the GN runs (one per walked step up
    to the cut) and their mean iterations.  `fs` is the bytes of a float
    (4, or 8 for the f64 body)."""
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
    n_bytes = (polys * (2 * L * fs + 4)
               + S * (49 + 9 * fs + 16 + 3 * fs
                      + (3 * fs if X0 is not None else 0))
               + S * T * (13 + 12 * fs) + V * 12 * fs + V * V * 9 * fs)
    return (n_bytes, flops), dict(walk_steps=tried, gn_runs=n_gn,
                                  mean_gn_iterations=round(its, 4),
                                  accepted=int(ref.valid.sum()))


def compare_stage12_kernels(ctx, sfmd, results):
    """K5 at the probe's, the extension's and the f64 extension's shapes
    (in a fresh process), K6 at the group sweep's shape, and label
    propagation's ordered bucket sums, on the full-scale scene."""
    import numpy as np
    import torch

    from edgegraph3d_tpu_torch import kernels
    from edgegraph3d_tpu_torch.matching import communities, polyline_stages
    from edgegraph3d_tpu_torch.ops import gather

    cfg = ctx.config
    dev = ctx.device
    V, P, L, _ = ctx.plg_coords.shape

    # K5 at the probe's, the extension's and phase 9(a)'s f64 extension
    # shape, checked and timed in a fresh process (--time-k5): the
    # profiler's trace has come back empty in this process after phase 4
    # (PERF.md section 7), and phase 9 comes after it
    k5 = subprocess.run([sys.executable, os.path.abspath(__file__),
                         "--time-k5", HERE], capture_output=True,
                        text=True, timeout=600)
    if k5.returncode != 0:
        fail(f"--time-k5 failed ({k5.returncode}): {k5.stdout[-3000:]} "
             f"{k5.stderr[-2000:]}")
    k5 = json.loads(k5.stdout.strip().splitlines()[-1])
    for label in ("probe", "extension", "extension_f64"):
        log(f"  gather_rows {label}: {json.dumps(k5[label])}")
    record_k5(results, "gather_rows", k5["extension"],
              max(k5["probe"]["max_abs_err"], k5["extension"]["max_abs_err"]))
    record_k5(results, f64_name("gather_rows"), k5["extension_f64"],
              k5["extension_f64"]["max_abs_err"], peak=PEAK_F64_FLOPS)

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


def gather_bytes(table, rows) -> int:
    """Bytes K5 must move: each distinct row it reads once, the indices,
    and every output row written once."""
    import torch
    row = table.shape[1] * table.element_size()
    return (torch.unique(rows).numel() * row
            + rows.numel() * (rows.element_size() + row))


def k5_launch(table, rows, out):
    """K5's C entry alone, into the preallocated `out`, with the launch
    plan computed once (a checkout without `gather.launch_plan` has the
    one-warp-a-row entry, which takes no plan)."""
    import torch

    from edgegraph3d_tpu_torch import kernels
    from edgegraph3d_tpu_torch.ops import gather
    (R, W), S = table.shape, len(rows)
    entry = getattr(kernels.lib(), "eg3d_gather_rows_f64"
                    if table.dtype == torch.float64 else "eg3d_gather_rows")
    args = [table.data_ptr(), R, W, rows.data_ptr(),
            int(rows.dtype == torch.int64), S, out.data_ptr()]
    if hasattr(gather, "launch_plan"):
        plan = gather.launch_plan(W, table.element_size(), table.data_ptr(),
                                  out.data_ptr(), S,
                                  gather._sm_count(table.device))
        args += [int(plan.vec), plan.blocks]
    args.append(kernels.stream_of(table))
    return lambda: kernels.check(entry(*args), "gather_rows")


def k5_times(table, rows, reps: int) -> dict:
    """K5 at one shape for the port checkout on sys.path: its wrapper,
    its launch alone into a preallocated output (CUDA events over `reps`
    calls a pair) and that launch's device time (a torch.profiler
    trace), beside `table[rows]` (K5's plain version and the one PyTorch
    call for the same function) by events and by device time; the rows
    that differ from it, whether the launch alone and the other index
    type give the same rows, the bytes K5 must move (gather_bytes) and
    a digest of the output."""
    import torch

    from edgegraph3d_tpu_torch.ops import gather
    got, ms = cuda_time(lambda: gather.gather_rows(table, rows), reps)
    ref, pms = cuda_time(lambda: table[rows], reps)
    other = rows.to(torch.int32 if rows.dtype == torch.int64
                    else torch.int64)
    out = torch.empty_like(got)
    launch = k5_launch(table, rows, out)
    _, launch_ms = cuda_time(launch, reps)
    n_bytes = gather_bytes(table, rows)
    return dict(
        table=list(table.shape), dtype=str(table.dtype), rows=len(rows),
        index=str(rows.dtype),
        mismatched_rows=int((got != ref).any(1).sum()),
        max_abs_err=float((got - ref).abs().max()),
        other_index_type_equal=torch.equal(
            gather.gather_rows(table, other), ref),
        launch_alone_equal=torch.equal(out, got),
        device_ms=device_ms(launch, 20, "gather_rows"),
        wrapper_ms=ms, launch_alone_ms=launch_ms,
        table_rows_ms=pms,
        table_rows_device_ms=device_ms(lambda: table[rows], 20, ""),
        bytes=n_bytes, bound_ms=bound(n_bytes, 0)[0],
        digest=float(got.double().sum()))


def record_k5(results, name, t, err, peak=PEAK_F32_FLOPS):
    """K5's row of the kernels line from k5_times: `ms` is its device
    time, with the wrapper and the launch alone beside it; plain_ms is
    table[rows] by events, library_ms the same call's device time."""
    record_into(results, name, t["mismatched_rows"], t["rows"], err,
                t["device_ms"], t["table_rows_ms"], 0.0, exact=True,
                work=(t["bytes"], 0.0), library_ms=t["table_rows_device_ms"],
                peak=peak)
    results[name].update(wrapper_ms=t["wrapper_ms"],
                         launch_alone_ms=t["launch_alone_ms"])


def tile_histogram(extent):
    """Chains per K7 tile bucket (<= 8, <= 16, <= 32, <= 64 slots)."""
    import numpy as np

    from edgegraph3d_tpu_torch.matching import expansion
    return np.bincount(np.searchsorted(expansion.TILE_SLOTS, extent),
                       minlength=4).tolist()


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


def expansion_work(ctx, chunks):
    """K7's plain version over every (args, extent) chunk, counted (K1
    grid entries, GN observations and iterations): (its outputs per
    chunk, (bytes, flops) that K7 must move and compute for the bound,
    the counts for the log).  `ctx` is the checkout's context whose
    expansion module the chunks go through."""
    import torch

    from edgegraph3d_tpu_torch.matching import expansion

    cfg = ctx.config
    V, GH, GW, Kc, _ = ctx.grids.shape
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

    expansion.grid_topm_query, expansion.triangulate_gn = (counted_query,
                                                            counted_gn)
    try:
        ref = [expansion._expand_chains_compact_plain(*a) for a, _ in chunks]
    finally:
        expansion.grid_topm_query, expansion.triangulate_gn = query, gn
    K = sum(a[5].shape[0] for a, _ in chunks)
    C = sum(a[-2] for a, _ in chunks)
    T = chunks[0][0][-1]
    samp = [torch.cat(t) for t in zip(*count["gn_sample"])]
    its, _ = gn_iterations(ctx.P_mats, *samp, cfg.follow_gn_iters,
                           cfg.gn_epsilon, cfg.match_gn_max_mse)
    live = sum(count["gn_mask"])
    gn_f = its * (FLOPS["gn_obs"] * live + FLOPS["gn_iter"] * count["gn_rows"])
    cells = torch.unique(torch.cat(count["cells"])).numel()
    fs = ctx.P_mats.element_size()
    n_bytes = (K * 9 * fs + C * (12 + 5 * T) + V * 12 * fs
               + cells * Kc * 24 + K * 3 * fs + K * V * (2 * fs + 1))
    flops = FLOPS["grid_entry"] * count["entries"] + gn_f
    stats = dict(chains=C, points=K,
                 views_added=sum(int(r[2].sum()) for r in ref) - 3 * K,
                 gn_tries=count["gn_rows"], gn_live_obs=live,
                 mean_gn_iterations=its, grid_entries=count["entries"])
    return ref, (n_bytes, flops), stats


def check_expansion(ctx, label, chunks, peak=PEAK_F32_FLOPS):
    """K7 against its plain version over every chunk of one expansion,
    laid out as refpoints.expand_and_assemble lays them out
    (refpoints.chain_chunks: one chunk on the card): decisions, out_xy
    and X bit-equal.  The plain run is counted for the bound
    (expansion_work), then timed once more without the counting; K7 is
    timed as the wrapper runs it (its launch plan: one launch per bucket,
    each on a stream of its own).  Returns (mismatched rows, rows, max
    |out_xy - plain| over the observations both accept, kernel ms, plain
    ms, (bytes, flops)) over all chunks."""
    import numpy as np
    import torch

    from edgegraph3d_tpu_torch.matching import expansion

    chunks = [(a, e) for _, a, e in chunks]
    ref, work, stats = expansion_work(ctx, chunks)
    _, pms = cuda_time(lambda: [expansion._expand_chains_compact_plain(*a)
                                for a, _ in chunks], 1, warmup=False)
    got, ms = cuda_time(lambda: [expansion.expand_chains_compact(
        *a, extent=e) for a, e in chunks], 5)
    exact = all(torch.equal(x, y) for out, r in zip(got, ref)
                for x, y in zip(out, r))
    bad = sum(int((g[2] != r[2]).any(1).sum()) for g, r in zip(got, ref))
    err = 0.0
    for g, r in zip(got, ref):
        both = g[2] & r[2]
        if both.any():
            err = max(err, float((g[1] - r[1]).abs()[both].max()))
    hist = np.sum([tile_histogram(e) for _, e in chunks], 0).tolist()
    launches = sum(len(expansion.launch_plan(e).launches) for _, e in chunks)
    log(f"  expand_chains {label}: {stats['chains']} chains in {len(chunks)} "
        f"chunk(s), {stats['points']} points, chains by tile bucket (<=8, "
        f"<=16, <=32, <=64 slots) {hist}; views added="
        f"{stats['views_added']} gn_tries={stats['gn_tries']} "
        f"gn_live_obs={stats['gn_live_obs']} mean_gn_iterations="
        f"{stats['mean_gn_iterations']:.4f} grid_entries="
        f"{stats['grid_entries']} bit_equal={exact} max_abs_err={err:.3g} "
        f"kernel_ms ({launches} launches)={ms:.4f} plain_ms={pms:.4f} "
        f"bytes={work[0]:.6g} flops={work[1]:.6g} "
        f"bound_ms={bound(*work, peak)[0]:.6f}")
    if not exact:
        fail(f"expand_chains {label}: not bit-equal to its plain version")
    return bad, stats["points"], err, ms, pms, work


def compare_expansion(ctx, sfmd, results):
    """K7 against its plain version over the whole expansion of the full
    scene's stage-3 chains (recorded) and of the first chain-extension
    round's chains (logged; they are longer), each in the chunks
    refpoints.expand_and_assemble makes."""
    from edgegraph3d_tpu_torch.matching import matches
    from edgegraph3d_tpu_torch.matching import refpoints as rp

    t0 = time.time()
    mgr = matches.MatchesManager(ctx.plg_length.cpu().numpy())
    round0, _ = rp.compute_and_follow_seeds(sfmd, ctx)
    res = rp.sweep_seeds(None, None, ctx, mgr, precomputed=round0)
    X, obs3, cams3, refs, seed_ids, orders = res
    log(f"  expand_chains: the full scene's {len(X)} stage-3 points "
        f"({time.time() - t0:.1f}s)")
    mism, K, err, ms, pms, work = check_expansion(
        ctx, "stage 3", rp.chain_chunks(ctx, X, obs3, cams3, seed_ids,
                                        orders))
    record_into(results, "expand_chains", mism, K, err, ms, pms,
                COORD_TOL_PX, exact=True, work=work)
    args = first_extension_call(ctx, res, mgr)
    mism, K, _, _, _, _ = check_expansion(
        ctx, "extension", rp.chain_chunks(ctx, *args[1:4], *args[5:7]))
    if mism:
        fail(f"expand_chains extension: {mism} of {K} rows differ")


def first_extension_call(ctx, res, mgr):
    """The arguments of the first chain-extension round's
    expand_and_assemble call (ctx, X, obs3, cams3, refs, seed_ids,
    orders), after expanding the stage-3 sweep `res` in full; copied as
    they come in (the caller reuses its seed-id array afterwards)."""
    import numpy as np

    from edgegraph3d_tpu_torch.matching import refpoints as rp
    pts = rp.expand_and_assemble(ctx, *res)
    seen = []
    real = rp.expand_and_assemble

    def capture(*a, **kw):
        seen.append(tuple(np.array(x) if isinstance(x, np.ndarray) else x
                          for x in a[:7]))
        return real(*a, **kw)

    rp.expand_and_assemble = capture
    try:
        rp._extend_once(ctx, pts, mgr)
    finally:
        rp.expand_and_assemble = real
    if not seen:
        fail("the chain extension expanded no points")
    return seen[0]


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


#: each run_main_path call's output scene, by name (phase 8 holds the
#: mesh runs against them)
MAIN_OUTPUTS = {}
#: per run_main_path run: launches per kernel and dtype, and the wall
MAIN_DTYPE_LAUNCHES = {}
MAIN_WALLS = {}
#: the stats counters of each run_main_path run through run_pipeline
MAIN_COUNTERS = {}


def run_main_path(name, scene, max_starting_views, stages=(1, 2, 3),
                  config=None, via_files=False, working_folder=None,
                  mesh=None):
    """One pipeline run on the card with the launch counts set to 0 just
    before it and read just after.  `via_files` goes through
    `edge_matching` on files in a temporary directory; else
    `working_folder` (optional) and `mesh` (optional) are run_pipeline's.
    Keeps the output in MAIN_OUTPUTS[name].  Returns (launches, stage
    counts)."""
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
                               stats=stats, stages=stages, device="cuda",
                               mesh=mesh)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = kernels.launch_totals()
        MAIN_DTYPE_LAUNCHES[name] = {k: dict(v) for k, v in
                                     kernels.LAUNCHES.items()}
        MAIN_WALLS[name] = wall
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
            MAIN_COUNTERS[name] = dict(stats.counters)
    peak = torch.cuda.max_memory_allocated()
    MAIN_OUTPUTS[name] = out
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
    if any(c["float64"] for c in MAIN_DTYPE_LAUNCHES[name].values()):
        log(f"{name} float64 launches: " + json.dumps(
            {k: c["float64"] for k, c in MAIN_DTYPE_LAUNCHES[name].items()}))
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
    log(f"  ba_blocks: launch_alone_ms={launch_ms:.4f} "
        f"bound_ms={bound_ms:.6f} "
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
        launches = kernels.launch_totals()["ba_blocks"]
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
    out["device_ms"] = device_ms_by_kernel(run, 10, r"ba_\w+") or {
        "all, by CUDA events (no profiler trace)": cuda_time(run, 10)[1]}
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
    rounds (the device_claiming_* counters).  Returns the host backend's
    points."""
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
    return ph


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


def lmeds_table_inputs(sfmd, cfg, device="cuda"):
    """refpoints.opencv_lmeds_fit's inputs on `device`: x1, x2 [P, n_max,
    2], n_common [P] (host) and samples [P, T, 7] of every ordered pair
    with at least max(fmat_min_common_points, 8) common refpoints."""
    import numpy as np
    import torch

    from edgegraph3d_tpu_torch.matching import refpoints as rp
    from edgegraph3d_tpu_torch.ops import geometry
    xy, mask = rp.dense_observations(sfmd)
    m = mask.astype(np.int64)
    common = m.T @ m
    V = sfmd.n_cameras
    least = max(cfg.fmat_min_common_points, 8)
    pairs = np.asarray([(i, j) for i in range(V) for j in range(V)
                        if i != j and common[i, j] >= least])
    n = common[pairs[:, 0], pairs[:, 1]]
    pi = torch.as_tensor(pairs, device=device)
    x1, x2 = rp.common_points(torch.as_tensor(xy, device=device),
                              torch.as_tensor(mask, device=device),
                              pi[:, 0], pi[:, 1], int(n.max()))
    samples = geometry.lmeds7_samples(
        n, geometry.lmeds_trials(cfg.fmat_lmeds_confidence)).to(device)
    return x1, x2, n, samples


def check_lmeds7(full, cfg, results, device="cuda"):
    """K9 lmeds7_fit on the full scene's OpenCV FM_LMEDS table against
    its plain twin on the same samples (the plain route's chunks of
    pairs), then the full scene's stage 3 with fmat_source="opencv_lmeds"
    with the launch counts set to 0 just before it: K9's launches there,
    which must be the route's chunks, and fmat_pairs_kernel, which must
    be the pairs.  The bound counts one error pass over every model's
    points; the selections' passes come on top.  Returns the launches."""
    import torch

    from edgegraph3d_tpu_torch import kernels
    from edgegraph3d_tpu_torch.matching import refpoints as rp
    from edgegraph3d_tpu_torch.ops import geometry, lmeds7

    sfmd = full[0]
    x1, x2, n, samples = lmeds_table_inputs(sfmd, cfg, device)
    P, T = samples.shape[:2]
    N = x1.shape[1]
    chunk = rp.opencv_lmeds_chunk(sfmd.n_points, N, T, False)

    def plain():
        out = {}
        for lo in range(0, P, chunk):
            part = geometry.fundamental_lmeds_opencv(
                x1[lo:lo + chunk], x2[lo:lo + chunk],
                torch.as_tensor(n[lo:lo + chunk], device=device),
                samples[lo:lo + chunk])
            for k, v in part.items():
                out.setdefault(k, []).append(v)
        return {k: torch.cat(v) for k, v in out.items()}

    got, ms = cuda_time(lambda: lmeds7.lmeds7_fit(x1, x2, n, samples), 5)
    want, plain_ms = cuda_time(plain, 1)
    got = {k: v.cpu() for k, v in got.items()}
    want = {k: v.cpu() for k, v in want.items()}
    both = got["valid"] & want["valid"]
    same = both & (got["best"] // 3 == want["best"] // 3)
    gap = torch.minimum((got["F"] - want["F"]).abs().amax((-2, -1)),
                        (got["F"] + want["F"]).abs().amax((-2, -1)))
    f_same = float(gap[same].max()) if bool(same.any()) else 0.0
    rel = (got["score"][both].double() / want["score"][both].double()
           - 1).abs()
    score_rel = float(rel.max()) if bool(both.any()) else 0.0
    share = float(same.sum()) / max(int(both.sum()), 1)
    model_diff = int((got["models"] - want["models"]).abs().sum()
                     + (got["no_model"] - want["no_model"]).abs().sum())
    live = torch.arange(N)[None] < torch.as_tensor(n)[:, None]
    inl_diff = int((got["inliers"] != want["inliers"])[same[:, None]
                                                       & live].sum())
    valid_mism = int((got["valid"] != want["valid"]).sum())
    errors = float((want["models"] * torch.as_tensor(n)).sum())
    work = (float(x1.numel() * 8 + samples.numel() * 8
                  + P * 3 * T * (72 * 2 + 2) + P * N),
            errors * K9_ERROR_FLOPS)
    log(f"  lmeds7_fit: {P} pairs, up to {N} points, {T} samples, "
        f"placed {kernels.LAST_PLACEMENT.get('lmeds7_fit')}; {errors:.6g} "
        f"errors in one pass; valid mismatches {valid_mism}, model-count "
        f"differences {model_diff} of {P * T} samples, same sample on "
        f"{share:.6f} of the pairs valid on both, F gap there {f_same:.3g}, "
        f"score rel {score_rel:.3g}, inlier flags differing on those pairs "
        f"{inl_diff} of {int(live[same].sum())}")
    record_into(results, "lmeds7_fit", valid_mism, P, f_same, ms, plain_ms,
                1e-8, exact=True, work=work, library_ms=plain_ms,
                peak=PEAK_F64_FLOPS)
    results["lmeds7_fit"].update(
        same_sample_share=share, score_rel=score_rel,
        model_count_differences=model_diff, inlier_flags_differing=inl_diff)
    if model_diff > DECISION_TOL * P * T:
        fail(f"lmeds7_fit: {model_diff} model counts differ over {P * T} "
             f"samples")
    if share < 0.9 or not score_rel <= 0.02:
        fail(f"lmeds7_fit: same sample on {share} of the pairs (< 0.9) or "
             f"scores {score_rel} apart (> 0.02)")
    del x1, x2, samples, got, want
    torch.cuda.empty_cache()
    name = "full stage 3 (opencv_lmeds)"
    launches, _ = run_main_path(name, full, None, stages=(3,),
                                config=cfg.replace(
                                    fmat_source="opencv_lmeds"))
    chunks = -(-P // rp.opencv_lmeds_chunk(sfmd.n_points, N, T, True))
    kern = MAIN_COUNTERS[name].get("fmat_pairs_kernel")
    log(f"  {name}: K9 launched {launches['lmeds7_fit']} times "
        f"({chunks} chunks), fmat_pairs_kernel {kern} of {P} pairs")
    if launches["lmeds7_fit"] != chunks or kern != P:
        fail(f"{name}: K9 launched {launches['lmeds7_fit']} times, not "
             f"{chunks}, or fmat_pairs_kernel {kern} != {P}")
    return launches["lmeds7_fit"]


def check_k9_alone() -> int:
    """`--check-k9`: check_lmeds7 on the full scene in this process."""
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA GPU")
    sys.path.insert(0, HERE)
    from edgegraph3d_tpu_torch import kernels
    log(card_name())
    kernels.build(verbose=False)
    kernels.lib()
    results = {}
    launches = check_lmeds7(full_scene(), bench_config(), results)
    log(json.dumps(dict(results["lmeds7_fit"], launches=launches)))
    log(json.dumps({"ok": True}))
    return 0


# ----------------------------------------------------------------------
# phase 7: the debug images (K1 and K2 on their path) and the host tools
# ----------------------------------------------------------------------

#: the debug-image families save_debug_images writes: one image per view,
#: or per view for each of a few match sets (pmsg_epi_SSS_VVVV) or
#: refpoints (epipolar_RRRRR_VVVV, detection_RRRRR_VVVV)
PER_VIEW_FAMILIES = ("plgs_imgs", "plgs_comp", "output_on_imgs",
                     "output_on_plgs", "pmsg", "pmsg_comm", "pmctr",
                     "claimed_intervals", "chains")
INDEXED_FAMILIES = ("pmsg_epi", "epipolar", "detection")


def debug_image_sets(folder, V) -> dict:
    """{family: number of sets} of the PNGs in `folder`; fails unless
    every set holds exactly one image per view 0..V-1."""
    import re
    views = {}
    for n in os.listdir(folder):
        if not n.endswith(".png"):
            continue
        m = re.fullmatch(r"(.+?)_(?:(\d{3}|\d{5})_)?(\d{4})\.png", n)
        if m is None:
            fail(f"debug images: unexpected file {n}")
        views.setdefault((m[1], m[2]), []).append(int(m[3]))
    sets = {}
    for (fam, idx), vs in views.items():
        if sorted(vs) != list(range(V)):
            fail(f"debug images: {fam} {idx} has views {sorted(vs)}, "
                 f"not one per view of {V}")
        sets[fam] = sets.get(fam, 0) + 1
    return sets


def run_debug_path(name, scene, root, config=None):
    """The -i path on cube8's files in `root`: through the command line
    (`-i`, its default configuration) when `config` is None, else
    `edge_matching(config, debug_images=True)`.  The launch counts are
    set to 0 just before the run and read just after; save_debug_images
    is wrapped to read the launches and the wall of its span.  Checks
    the output's quality and the image families; returns (output path,
    launches, span)."""
    import torch

    from edgegraph3d_tpu_torch import kernels
    from edgegraph3d_tpu_torch.cli import edge_graph_3d as cli
    from edgegraph3d_tpu_torch.core import sfm as sfm_io
    from edgegraph3d_tpu_torch.pipeline import edge_matching
    from edgegraph3d_tpu_torch.quality import quality_metrics
    from edgegraph3d_tpu_torch.utils import drawing

    sfmd, _, curves = scene
    tag = "cli" if config is None else "stage2"
    work = os.path.join(root, f"work_{tag}")
    out_json = os.path.join(root, f"out_{tag}.json")
    files = [os.path.join(root, "imgs"), os.path.join(root, "edges"), work,
             os.path.join(root, "input.json"), out_json]
    span = {"detection_s": 0.0}
    save, detect = drawing.save_debug_images, drawing.detection_candidates

    def spanned(*a, **kw):
        torch.cuda.synchronize()
        before = kernels.launch_totals()
        t0 = time.time()
        save(*a, **kw)
        torch.cuda.synchronize()
        span["wall_s"] = time.time() - t0
        after = kernels.launch_totals()
        span["launches"] = {k: after[k] - before[k] for k in before}

    def timed_detect(*a, **kw):
        # its results are read back to the host inside, so the host
        # clock covers K1's and K2's device work
        t0 = time.time()
        out = detect(*a, **kw)
        span["detection_s"] += time.time() - t0
        return out

    drawing.save_debug_images = spanned
    drawing.detection_candidates = timed_detect
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.time()
        if config is None:
            if cli.main(["-i"] + files + ["--max-starting-views", "2",
                                          "--device", "cuda"]) != 0:
                fail(f"{name}: the command line failed")
        else:
            edge_matching(*files, config, max_starting_views=2,
                          debug_images=True, device="cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = kernels.launch_totals()
    finally:
        drawing.save_debug_images = save
        drawing.detection_candidates = detect
    if "wall_s" not in span:
        fail(f"{name}: save_debug_images was not called")
    with open(os.path.join(work, "stats.json")) as f:
        counts = json.load(f)["counts"]
    out = sfm_io.read_sfm_data(out_json)
    qual = quality_metrics(out, sfmd, curves)
    sets = debug_image_sets(work, sfmd.n_cameras)
    log(f"{name}: wall_s={wall:.3f} debug_images_s={span['wall_s']:.3f} "
        f"(detection candidates, K1 + K2 and their read-backs: "
        f"{span['detection_s']:.3f}) points={out.n_points}")
    log(f"{name} stage counts: {json.dumps(counts)}")
    log(f"{name} quality: {json.dumps(qual)}")
    log(f"{name} launches (run): {json.dumps(launches)}")
    log(f"{name} launches (debug_images span): "
        f"{json.dumps(span['launches'])}")
    log(f"{name} image sets: {json.dumps(sets, sort_keys=True)}")
    if qual["edge_points"] == 0 or not qual["coverage"] >= 0.9 \
            or not qual["med_dist3d"] <= 0.01:
        fail(f"{name}: quality gate (edge_points > 0, coverage >= 0.9, "
             f"med_dist3d <= 0.01) not met: {qual}")
    for k in ("grid_topm_query", "epipolar_topm_query"):
        if span["launches"][k] <= 0:
            fail(f"{name}: {k} was not launched in the debug_images span")
    # as save_debug_images writes them: match-set images only when the
    # stage made sets, the epipolar overlays of the first 3 stage-1 sets
    n1 = counts.get("stage1_similarity_graph", 0)
    n2 = counts.get("stage2_closeness_graph", 0)
    want = {f: 1 for f in PER_VIEW_FAMILIES}
    want.update(pmsg=int(n1 > 0), pmsg_comm=int(n1 > 0), pmctr=int(n2 > 0),
                pmsg_epi=min(3, n1), epipolar=min(3, sfmd.n_points),
                detection=min(3, sfmd.n_points))
    want = {f: n for f, n in want.items() if n}
    if sets != want:
        fail(f"{name}: image sets {sets}, expected {want}")
    return out_json, launches, span


def compare_detection_images(scene, cfg):
    """draw_detection_process for the suite's refpoints (0, 1, 2) on a
    CUDA context (K1 and K2) and on a CPU context of the same arrays
    (their plain versions): equal candidate ids and masks, coordinates
    within COORD_TOL_PX, equal images.  Returns the largest coordinate
    difference."""
    import numpy as np

    from edgegraph3d_tpu_torch.matching import refpoints as rp
    from edgegraph3d_tpu_torch.plgs.extraction import extract_plgs
    from edgegraph3d_tpu_torch.utils import drawing

    sfmd, edges, _ = scene
    stack = extract_plgs(edges, cfg)
    ctx = rp.build_context(sfmd, stack, cfg, device="cuda")
    host = lambda t: t.cpu().numpy()
    cpu = rp.context_from_arrays(
        host(ctx.plg_coords), host(ctx.plg_length), host(ctx.grids),
        host(ctx.P_mats), host(ctx.F_table), ctx.cell, cfg, device="cpu")
    W, H = int(sfmd.widths.max()), int(sfmd.heights.max())
    err, n_cand = 0.0, 0

    def same(a, b, what):
        nonlocal err, n_cand
        if not (np.array_equal(a.pl_id, b.pl_id)
                and np.array_equal(a.valid, b.valid)):
            fail(f"detection images: {what}: candidate ids or masks differ "
                 f"between K1/K2 and their plain versions")
        if a.valid.any():
            err = max(err, float(np.abs(a.xy - b.xy)[a.valid].max()))
        n_cand += int(a.valid.sum())

    for r in range(min(3, sfmd.n_points)):
        got = drawing.detection_candidates(ctx, sfmd, r)
        ref = drawing.detection_candidates(cpu, sfmd, r)
        if list(got) != list(ref):
            fail(f"detection images: refpoint {r}: views differ")
        for v in got:
            same(got[v][0], ref[v][0], f"refpoint {r} view {v} starts")
            for u, (rows, res) in got[v][1].items():
                rows_ref, res_ref = ref[v][1][u]
                if rows != rows_ref:
                    fail(f"detection images: refpoint {r} ({v}, {u}): "
                         f"start rows {rows} vs {rows_ref}")
                if rows:
                    same(res, res_ref, f"refpoint {r} pair ({v}, {u})")
        a = drawing.draw_detection_process(sfmd, ctx, r, W, H, stack=stack)
        b = drawing.draw_detection_process(sfmd, cpu, r, W, H, stack=stack)
        diff = np.argwhere((a != b).any(-1))
        if len(diff):
            fail(f"detection images: refpoint {r}: {len(diff)} pixels "
                 f"differ, first (view, y, x) {diff[0].tolist()}")
    if err > COORD_TOL_PX:
        fail(f"detection images: coordinates differ by {err} px")
    log(f"detection images, K1/K2 against their plain versions on "
        f"refpoints 0-2: {n_cand} candidates, ids and masks equal, "
        f"max_abs_err={err:.3g} px, images equal")
    return err


def check_host_tools(out_json, edges_dir, root):
    """json_to_ply --images on the output JSON (its vertex count and
    colors), then coordinate_system_transform onto a seeded similarity
    of the camera centers and back."""
    import numpy as np

    from edgegraph3d_tpu_torch.cli import coordinate_system_transform as cst
    from edgegraph3d_tpu_torch.cli import json_to_ply
    from edgegraph3d_tpu_torch.core import sfm as sfm_io

    out = sfm_io.read_sfm_data(out_json)
    ply = os.path.join(root, "out.ply")
    t0 = time.time()
    if json_to_ply.main([out_json, ply, "--images", edges_dir]) != 0:
        fail("json_to_ply failed")
    with open(ply) as f:
        head, body = f.read().split("end_header\n")
    rows = body.splitlines()
    if f"element vertex {out.n_points}\n" not in head \
            or len(rows) != out.n_points \
            or "property uchar red" not in head \
            or any(len(r.split()) != 6 for r in rows):
        fail(f"json_to_ply: {len(rows)} vertex rows for {out.n_points} "
             "points, or no colors")
    log(f"json_to_ply --images: {len(rows)} vertices = n_points, colored "
        f"({time.time() - t0:.2f}s)")

    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    c, R, t = 1.7, q * np.sign(np.linalg.det(q)), rng.normal(size=3)
    target = c * out.center @ R.T + t

    def poses(name, centers):
        path = os.path.join(root, name)
        with open(path, "w") as f:
            f.writelines(f"{x:.12f} {y:.12f} {z:.12f}\n" for x, y, z in
                         centers)
        return path

    there, back = (os.path.join(root, n) for n in ("there.json",
                                                   "back.json"))
    if cst.main([out_json, poses("target.txt", target), there]) != 0 \
            or cst.main([there, poses("orig.txt", out.center), back]) != 0:
        fail("coordinate_system_transform failed")
    moved = sfm_io.read_sfm_data(there)
    rt = sfm_io.read_sfm_data(back)
    e_there = float(np.abs(moved.points - (c * out.points @ R.T + t)).max())
    e_back = max(float(np.abs(rt.points - out.points).max()),
                 float(np.abs(rt.center - out.center).max()))
    log(f"coordinate_system_transform round trip on {out.n_points} points: "
        f"onto the similarity within {e_there:.3g}, back within "
        f"{e_back:.3g} (scene units)")
    if not (e_there < 1e-6 and e_back < 1e-6):
        fail("coordinate_system_transform: round trip off by more than "
             "1e-6 scene units")


def check_debug_and_host_tools(cube):
    """Phase 7 on cube8: the command line's -i, edge_matching with
    stage-2 sets and debug images, K1/K2 against their plain versions
    on the detection images, json_to_ply and the coordinate transform."""
    root = tempfile.mkdtemp(prefix="eg3d_debug_")
    try:
        _write_scene_files(root, cube[0], cube[1])
        out_json, launches, span = run_debug_path("cube8 -i (command line)",
                                                  cube, root)
        _, _, span2 = run_debug_path(
            "cube8 -i with stage-2 sets", cube, root,
            config=bench_config().replace(closeness_max_dist_ratio=1e6))
        err = compare_detection_images(cube, bench_config())
        check_host_tools(out_json, os.path.join(root, "edges"), root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(launches=launches, span=span, span_stage2=span2,
                detection_max_abs_err=err)


# ----------------------------------------------------------------------
# phase 8: the mesh on the card (edgegraph3d_tpu_torch/parallel)
# ----------------------------------------------------------------------

#: shards of phase 8's one-process mesh, all on cuda:0
MESH_SHARDS = 4
#: the distributed BA against the single-device BA: rotations, points
#: and the MSE absolute (tests/test_ba.py's bounds); translations, which
#: those tests leave out, within phase 6's BA_CAM_TOL (1 + max |t|)
MESH_BA_TOL = dict(R=1e-5, X=1e-4, mse=1e-3)
#: the kernels the sharded sweeps and the distributed BA launch per shard
SHARD_KERNELS = ("grid_topm_query", "epipolar_topm_query", "triangulate_gn",
                 "follow_walk", "expand_chains", "ba_blocks")


def shard_launches() -> dict:
    """Per global shard, the launches of SHARD_KERNELS since the last
    sharded.reset_shard_launches()."""
    from edgegraph3d_tpu_torch.parallel import sharded
    return {g: {k: c[k] for k in SHARD_KERNELS}
            for g, c in sorted(sharded.SHARD_LAUNCHES.items())}


def same_scene(label, got, ref, x_tol=1e-5) -> float:
    """Two output scenes: the same point count and observation lists
    (so equal observation masks), points within x_tol.  Returns the
    largest point difference."""
    import numpy as np
    if got.n_points != ref.n_points:
        fail(f"{label}: {got.n_points} points against {ref.n_points}")
    if len(got.obs_cam) != len(ref.obs_cam) or any(
            not np.array_equal(a, b)
            for a, b in zip(got.obs_cam, ref.obs_cam)):
        fail(f"{label}: the observation lists differ")
    d = float(np.abs(got.points - ref.points).max()) if got.n_points else 0.0
    if not d <= x_tol:
        fail(f"{label}: points differ by {d} > {x_tol}")
    log(f"  {label}: {got.n_points} points, observation lists equal, "
        f"max point difference {d:.3g} (tolerance {x_tol})")
    return d


def check_mesh_main_path(full, cube, mesh, label):
    """Phase 8(a): the full scene's default stages and cube8's stage 3
    through run_pipeline(mesh=...) against phases 4 and 3, with the
    per-shard launches of the sharded kernels logged; every shard must
    launch K1-K4 and K7 on the full scene."""
    from edgegraph3d_tpu_torch import kernels
    from edgegraph3d_tpu_torch.parallel import sharded

    sharded.reset_shard_launches()
    launches, _ = run_main_path(f"full {label}", full, None, mesh=mesh)
    per_shard = shard_launches()
    log(f"  full {label}: launches per shard {json.dumps(per_shard)}")
    missing = [k for k in kernels.MAIN_PATH_KERNELS if launches[k] <= 0]
    idle = [(g, k) for g in range(mesh.size) for k in SHARD_KERNELS[:5]
            if per_shard.get(g, {}).get(k, 0) <= 0]
    if missing or idle:
        fail(f"full {label}: kernels not launched: {missing}, "
             f"(shard, kernel) pairs with no launch: {idle}")
    same_scene(f"full {label} against phase 4", MAIN_OUTPUTS[f"full {label}"],
               MAIN_OUTPUTS["full"])
    sharded.reset_shard_launches()
    run_main_path(f"cube8 stage 3 {label}", cube, 2, stages=(3,), mesh=mesh)
    log(f"  cube8 stage 3 {label}: launches per shard "
        f"{json.dumps(shard_launches())}")
    same_scene(f"cube8 stage 3 {label} against phase 3",
               MAIN_OUTPUTS[f"cube8 stage 3 {label}"],
               MAIN_OUTPUTS["cube8 stage 3"])
    return launches, per_shard


def check_mesh_claiming(full, cfg, host_pts, mesh):
    """Phase 8(a): stage 3 of the full scene with device claiming sharded
    over the mesh, bit-equal to phase 6's host claiming, no fallback."""
    import numpy as np

    from edgegraph3d_tpu_torch.matching import refpoints as rp
    from edgegraph3d_tpu_torch.pipeline import (PipelineStats,
                                                reconstruct_all_stages)
    from edgegraph3d_tpu_torch.plgs.extraction import extract_plgs

    sfmd, edges, _ = full
    c = cfg.replace(claiming_backend="device")
    ctx = rp.build_context(sfmd, extract_plgs(edges, c), c,
                           device=mesh.device, mesh=mesh)
    stats = PipelineStats()
    pts = reconstruct_all_stages(sfmd, ctx, stats, stages=(3,))
    own = {k: v for k, v in stats.counters.items()
           if k.startswith("device_claiming")}
    log(f"  stage 3, device claiming on the mesh: stage3_refpoints_s="
        f"{stats.timings['stage3_refpoints']:.4f} {json.dumps(own)}")
    if own.get("device_claiming_fallback", 0) or \
            not own.get("device_claiming_rounds", 0):
        fail(f"mesh device claiming: fell back or never ran: {own}")
    same = all(np.array_equal(getattr(pts, f), getattr(host_pts, f))
               for f in ("X", "obs_xy", "obs_mask", "seed_refpoint",
                         "seed_id", "chain_order"))
    if not same:
        fail(f"mesh device claiming: {len(pts.X)} points differ from the "
             f"host claiming's {len(host_pts.X)}")
    log(f"  mesh device claiming: {len(pts.X)} points, equal to host "
        "claiming's bit for bit")


def ba_state_errors(st, ref) -> dict:
    """The distributed BA's final state against another: max abs
    differences and the translation bound."""
    d = {n: float((getattr(st, n).to(getattr(ref, n).device)
                   - getattr(ref, n)).abs().max()) for n in ("R", "t", "X")}
    d["t_tol"] = BA_CAM_TOL * (1 + float(ref.t.abs().max()))
    return d


def ba_within(d, mse_diff) -> bool:
    return (d["R"] <= MESH_BA_TOL["R"] and d["t"] <= d["t_tol"]
            and d["X"] <= MESH_BA_TOL["X"] and mse_diff <= MESH_BA_TOL["mse"])


def augmented_ba_problem(aug, dev):
    """Phase 6's joint-BA problem: the augmented scene's dense
    observations and its seeded perturbation, on `dev`."""
    import numpy as np
    import torch

    from edgegraph3d_tpu_torch.matching import refpoints as rp
    N, V = aug.n_points, aug.n_cameras
    obs_xy, obs_mask = rp.dense_observations(aug)
    cam = torch.arange(V, dtype=torch.int32, device=dev).repeat(N, 1)
    xy = torch.as_tensor(np.asarray(obs_xy, np.float32), device=dev)
    mask = torch.as_tensor(obs_mask, device=dev)
    return perturbed_ba_state(aug, dev), (cam, xy, mask)


def check_mesh_ba(mesh, state0, obs, label):
    """Phase 8(a): 3 steps of sharded.distributed_ba on `label`'s problem
    (state0, obs on the mesh's first device) against 3 of the
    single-device ba_run, to MESH_BA_TOL, each shard launching K8 once a
    step; then one shard's K8 blocks against the plain version
    (BA_BLOCK_TOL).  Returns K8's launches in the distributed run."""
    import torch

    from edgegraph3d_tpu_torch.ops import ba
    from edgegraph3d_tpu_torch.parallel import sharded
    from edgegraph3d_tpu_torch.parallel.mesh import shard_bounds

    dev = mesh.device
    cam, xy, mask = obs
    N = len(state0.X)
    torch.cuda.synchronize()
    t0 = time.time()
    st_s, mses_s = ba.ba_run(state0, cam, xy, mask, 3)
    torch.cuda.synchronize()
    t1 = time.time()
    sharded.reset_shard_launches()
    st_d, mses_d = sharded.distributed_ba(mesh, state0, cam, xy, mask, 3)
    torch.cuda.synchronize()
    t2 = time.time()
    d = ba_state_errors(st_d, st_s)
    mse_diff = float((mses_d.to(dev) - mses_s).abs().max())
    per_shard = {g: c["ba_blocks"] for g, c in shard_launches().items()}
    log(f"  distributed BA, {mesh.size} shards, 3 steps on {label} "
        f"(N={N}): mse per step {mses_d.tolist()} (single "
        f"{mses_s.tolist()}); against ba_run {json.dumps(d)}, mse "
        f"{mse_diff:.3g} (tolerances {json.dumps(MESH_BA_TOL)}); walls_s "
        f"single {t1 - t0:.4f} mesh {t2 - t1:.4f}; K8 launches per shard "
        f"{json.dumps(per_shard)}")
    if not ba_within(d, mse_diff):
        fail(f"distributed BA differs from ba_run: {d}, mse {mse_diff}")
    if sorted(per_shard.values()) != [3] * mesh.size:
        fail(f"distributed BA: K8 launches per shard {per_shard}, not 3")
    g = min(1, mesh.size - 1)
    lo, hi = shard_bounds(N, mesh.size)[g]
    sd = mesh.devices[g % mesh.local]
    st_g = ba.BAState(*(a.to(sd) for a in state0[:3]), state0.X[lo:hi].to(sd))
    obs_g = tuple(a[lo:hi].to(sd) for a in (cam, xy, mask))
    rel, err = ba_step1_errors(ba.ba_blocks(st_g, *obs_g),
                               ba._ba_blocks_plain(st_g, *obs_g))
    log(f"  shard {g} K8 blocks ({hi - lo} points on {sd}) against the "
        f"plain version, error / largest magnitude: {json.dumps(rel)}")
    if max(rel.values()) > BA_BLOCK_TOL:
        fail(f"shard {g} K8 blocks differ from the plain version: {rel}")
    return sum(per_shard.values())


def check_mesh_k4_shard(full, cfg, mesh):
    """Phase 8(a): one shard's K4 launches (the direction trials and the
    walk of one follow_seeds call) on its block of the first refpoint
    chunk's seeds, on its device against the context's replica there,
    against the plain twin: 0 decision mismatches."""
    import torch

    from edgegraph3d_tpu_torch.matching import following
    from edgegraph3d_tpu_torch.matching import refpoints as rp
    from edgegraph3d_tpu_torch.parallel.mesh import shard_bounds
    from edgegraph3d_tpu_torch.plgs.extraction import extract_plgs

    sfmd, edges, _ = full
    ctx = rp.build_context(sfmd, extract_plgs(edges, cfg), cfg,
                           device=mesh.device, mesh=mesh)
    obs_xy, obs_mask = rp.dense_observations(sfmd)
    seeds = rp.compute_seeds_chunk(ctx, *(
        torch.as_tensor(x[:1024], device=mesh.device)
        for x in (obs_xy, obs_mask, obs_mask)))
    n = len(seeds["cams"])
    g = min(1, mesh.size - 1)
    lo, hi = shard_bounds(n, mesh.size)[g]
    sd = mesh.devices[g % mesh.local]
    rc = ctx.on(sd)
    st = rp._seed_tuple({k: seeds[k][lo:hi].to(sd)
                         for k in ("cams", "pl_id", "seg", "t", "xy", "X")})
    both = following.SeedTuple(*[torch.cat([a, a]) for a in st])
    ones = torch.ones(hi - lo, dtype=torch.int32, device=sd)
    for mode, fargs in zip(("warm", "cold"), captured_follow_walks(
            rc, both, torch.cat([ones, -ones]))):
        got = following.follow_walk(*fargs)
        walk, gn = following.follow_params(cfg, mode == "warm")
        want = following._follow_plain(*fargs[:12], fargs[12], *walk, *gn)
        mism, err, rel = follow_diff(got, want)
        log(f"  shard {g} follow_walk {mode} ({2 * (hi - lo)} lanes on "
            f"{sd}, of the first refpoint chunk's {n} seeds): "
            f"decision_mismatches={mism} max_abs_err={err:.3g} "
            f"X_max_rel_err={rel:.3g}")
        if mism or rel > 1e-4 or err > COORD_TOL_PX:
            fail(f"shard {g} follow_walk {mode} differs from its plain "
                 f"twin: {mism} mismatches, err {err}, X rel {rel}")
    del ctx, rc


def gn_problem(device):
    """Phase 8's per-point GN problem: cube8's refpoints, their packed
    observations (all 8 views at most) and points perturbed by 0.01
    (seed 0): (P_obs, xy, mask, X0) on `device`."""
    import numpy as np
    import torch

    from edgegraph3d_tpu_torch.core import sfm as sfm_io
    sfmd = cube8_scene()[0]
    packed = sfm_io.pack_observations(sfmd.obs_cam, sfmd.obs_xy, max_obs=8,
                                      dtype=np.float32)
    X0 = sfmd.points + np.random.default_rng(0).normal(
        0, 0.01, sfmd.points.shape)
    P_obs = sfmd.P[np.clip(packed.cam_idx, 0, None)]
    return tuple(torch.as_tensor(np.asarray(a, dt), device=device)
                 for a, dt in ((P_obs, np.float32), (packed.xy, np.float32),
                               (packed.mask, bool), (X0, np.float32)))


#: the distributed BA problem of the phase-8 workers: K8_SHAPE's seeded
#: problem (--time-k8's), 2 steps
WORKER_BA_STEPS = 2


def mesh_worker(rank: int, world: int, port: int, out: str,
                backend: str = "gloo") -> int:
    """One process of phase 8(b) / (c): joins a process group of `world`
    processes over `backend` at localhost:`port`, drives 2 shards (on
    cuda:0 for gloo, on card rank for nccl), and runs the sharded GN
    (gn_problem), WORKER_BA_STEPS steps of the distributed BA (the
    K8_SHAPE problem) and cube8's stage 3 through
    run_pipeline(mesh=global_mesh()); writes the results to `out` (npz)."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    from edgegraph3d_tpu_torch.parallel import distributed, sharded
    from edgegraph3d_tpu_torch.pipeline import run_pipeline

    t0 = time.time()
    distributed.initialize(f"localhost:{port}", world, rank,
                           local_device_count=2, backend=backend)
    card = rank % torch.cuda.device_count() if backend == "nccl" else 0
    mesh = distributed.global_mesh(devices=[f"cuda:{card}"] * 2)
    dev = mesh.device
    X, _, ok = sharded.sharded_gauss_newton(mesh, *gn_problem(dev))
    state, obs = k8_problem(dev)
    st, mses = sharded.distributed_ba(mesh, state, *obs, WORKER_BA_STEPS)
    sfmd, edges, _ = cube8_scene()
    res = run_pipeline(sfmd, edges, bench_config(), max_starting_views=2,
                       stages=(3,), mesh=mesh, device=dev)
    torch.cuda.synchronize()
    np.savez(out, gn_X=X.cpu().numpy(), gn_ok=ok.cpu().numpy(),
             ba_R=st.R.cpu().numpy(), ba_t=st.t.cpu().numpy(),
             ba_X=st.X.cpu().numpy(), ba_mses=mses.cpu().numpy(),
             points=res.points, obs=np.concatenate(res.obs_cam),
             n_points=res.n_points, size=mesh.size, first=mesh.first,
             launches=json.dumps(shard_launches()),
             wall_s=time.time() - t0)
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_mesh_workers(world: int, backend: str, tmp: str) -> list:
    """Start `world` mesh_worker processes, wait for them (600 s), kill
    them all if one fails or hangs; returns their results."""
    import numpy as np
    port = free_port()
    outs = [os.path.join(tmp, f"{backend}{r}.npz") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-worker", str(r),
         str(world), str(port), outs[r], backend], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    except subprocess.TimeoutExpired:
        logs.append("timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        fail(f"{backend} mesh workers failed "
             f"{[p.returncode for p in procs]}: "
             + " | ".join(x[-3000:] for x in logs))
    return [dict(np.load(o)) for o in outs]


def check_worker_results(label, res, ref):
    """Phase 8(b) / (c): every process's results equal bit for bit; the
    GN and stage 3 equal the one-process references `ref` bit for bit,
    the distributed BA within MESH_BA_TOL of ref's one-process mesh run."""
    import numpy as np
    import torch
    for r, got in enumerate(res):
        log(f"  {label} rank {r}: global shards {int(got['size'])}, first "
            f"{int(got['first'])}, wall {float(got['wall_s']):.1f}s, "
            f"launches per shard {got['launches']}")
        for k in ("gn_X", "gn_ok", "ba_R", "ba_t", "ba_X", "ba_mses",
                  "points", "obs", "n_points"):
            if not np.array_equal(got[k], res[0][k]):
                fail(f"{label}: rank {r}'s {k} differs from rank 0's")
    got = res[0]
    for k in ("gn_X", "gn_ok", "points", "obs"):
        if not np.array_equal(got[k], ref[k]):
            fail(f"{label}: {k} differs from the one-process run")
    st = lambda p: SimpleNamespace(**{n: torch.as_tensor(p["ba_" + n])
                                      for n in "RtX"})
    d = ba_state_errors(st(got), st(ref))
    mse_diff = float(np.abs(got["ba_mses"] - ref["ba_mses"]).max())
    log(f"  {label}: GN ({len(got['gn_X'])} points, {int(got['gn_ok'].sum())}"
        f" valid) and cube8 stage 3 ({int(got['n_points'])} points) equal "
        f"to the one-process run bit for bit; distributed BA against the "
        f"one-process mesh: {json.dumps(d)}, mse {mse_diff:.3g}, mses "
        f"{got['ba_mses'].tolist()}")
    if not ba_within(d, mse_diff):
        fail(f"{label}: distributed BA differs from the one-process mesh")


def worker_reference(mesh, label) -> dict:
    """The one-process results the mesh workers are held against: the
    unsharded GN on gn_problem, WORKER_BA_STEPS distributed BA steps on
    `mesh` (K8_SHAPE's problem), and check_mesh_main_path's cube8 stage 3
    run on `mesh` (`label`)."""
    import numpy as np
    import torch

    from edgegraph3d_tpu_torch.ops.triangulation import gauss_newton_batched
    from edgegraph3d_tpu_torch.parallel import sharded

    dev = mesh.device
    X, _, ok = gauss_newton_batched(*gn_problem(dev))
    state, obs = k8_problem(dev)
    st, mses = sharded.distributed_ba(mesh, state, *obs, WORKER_BA_STEPS)
    out = MAIN_OUTPUTS[f"cube8 stage 3 {label}"]
    ref = dict(gn_X=X.cpu().numpy(), gn_ok=ok.cpu().numpy(),
               ba_R=st.R.cpu().numpy(), ba_t=st.t.cpu().numpy(),
               ba_X=st.X.cpu().numpy(), ba_mses=mses.cpu().numpy(),
               points=out.points, obs=np.concatenate(out.obs_cam))
    del state, obs, st
    torch.cuda.empty_cache()
    return ref


def check_mesh(full, cube, cfg, aug, host_claims):
    """Phase 8: the mesh on the card.  (a) one process, MESH_SHARDS
    shards on cuda:0 (and a mesh over every card where there are more);
    (b) two processes on cuda:0 joined over gloo, 2 shards each; (c) an
    NCCL group of one process per card, 2 shards each.  Returns the
    launches of (a)'s full-scene run (K8's: of its distributed BA) and
    that run's launches per shard."""
    import torch

    from edgegraph3d_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=["cuda:0"] * MESH_SHARDS)
    label = f"mesh{MESH_SHARDS}"
    launches, per_shard = check_mesh_main_path(full, cube, mesh, label)
    check_mesh_claiming(full, cfg, host_claims, mesh)
    check_mesh_k4_shard(full, cfg, mesh)
    launches["ba_blocks"] = check_mesh_ba(
        mesh, *augmented_ba_problem(aug, mesh.device),
        "the perturbed augmented scene")
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        check_mesh_main_path(full, cube, make_mesh(), f"cards{n_cards}")

    ref = worker_reference(mesh, label)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        check_worker_results("gloo, 2 processes on cuda:0",
                             run_mesh_workers(2, "gloo", tmp), ref)
        log(f"  gloo workers: {time.time() - t0:.1f}s")
        t0 = time.time()
        check_worker_results(f"nccl, {n_cards} process(es), one a card",
                             run_mesh_workers(n_cards, "nccl", tmp), ref)
        log(f"  nccl workers: {time.time() - t0:.1f}s")
    return launches, per_shard

def time_shard_steps(full, cfg, mesh):
    """`--mesh-cards`: the full scene's stage-3 seeding and following
    (compute_and_follow_seeds: K1-K4 on every shard of every refpoint
    chunk) on the mesh of cards, with the seeding's shards stepped
    together (sharded._run_shards: every shard's work queued before any
    reads back) and run one after another (each to its end before the
    next starts), in the order stepped, one after another, one after
    another, stepped after a warm-up; and on one card.  The results must
    be equal bit for bit.  Logs each wall (every card synchronized)."""
    import inspect

    import numpy as np
    import torch

    from edgegraph3d_tpu_torch.matching import refpoints as rp
    from edgegraph3d_tpu_torch.parallel import sharded
    from edgegraph3d_tpu_torch.plgs.extraction import extract_plgs

    sfmd, edges, _ = full
    stack = extract_plgs(edges, cfg)
    one = rp.build_context(sfmd, stack, cfg, device=mesh.device)
    ctx = rp.build_context(sfmd, stack, cfg, device=mesh.device, mesh=mesh)
    stepped = sharded._run_shards

    def one_after_another(jobs):
        return [rp.run_steps(r) if inspect.isgenerator(r) else r
                for r in (sharded._on_shard(g, fn, *args)
                          for g, fn, args in jobs)]

    def run(c, step):
        sharded._run_shards = stepped if step else one_after_another
        try:
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)
            t0 = time.time()
            round0, n = rp.compute_and_follow_seeds(sfmd, c)
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)
            return time.time() - t0, round0, n
        finally:
            sharded._run_shards = stepped

    _, ref, n_ref = run(one, True)
    walls = {"one card": [run(one, True)[0]]}
    for mode in ("stepped", "one after another", "one after another",
                 "stepped"):
        wall, round0, n = run(ctx, mode == "stepped")
        same = n == n_ref and len(round0) == len(ref) and all(
            a[0] == b[0] and np.array_equal(a[2], b[2])
            and np.array_equal(a[3], b[3])
            and all(np.array_equal(a[1][k], b[1][k]) for k in a[1])
            for a, b in zip(round0, ref))
        if not same:
            fail(f"stage-3 seeding and following on {mesh.size} cards "
                 f"({mode}) differ from one card's")
        walls.setdefault(mode, []).append(wall)
    log(f"  stage-3 seeding + following, {n_ref} seeds, equal on every "
        f"run: walls (s) {json.dumps(walls)}")
    return walls


def mesh_cards() -> int:
    """`--mesh-cards`: phase 8 across every card of a machine with two or
    more, alone: the full scene's default stages and cube8's stage 3 on
    one card, then on a one-process mesh of all the cards (one shard a
    card; a shard on cuda:1 and above launches there while cuda:0 is
    current), shard 1's K4 launches against the plain twin, 3 distributed
    BA steps on K8_SHAPE's problem against ba_run, and an NCCL group of
    one process a card (2 shards each) against the one-process runs."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        fail("--mesh-cards needs two CUDA GPUs or more")
    sys.path.insert(0, HERE)
    from edgegraph3d_tpu_torch import kernels
    from edgegraph3d_tpu_torch.parallel.mesh import make_mesh

    t_start = time.time()
    n = torch.cuda.device_count()
    log(f"{n} cards: {card_names()}")
    kernels.build()
    kernels.lib()
    full, cube, cfg = full_scene(), cube8_scene(), bench_config()
    run_main_path("full", full, None)
    run_main_path("cube8 stage 3", cube, 2, stages=(3,))
    mesh = make_mesh()
    label = f"cards{n}"
    t0 = time.time()
    check_mesh_main_path(full, cube, mesh, label)
    time_shard_steps(full, cfg, mesh)
    check_mesh_k4_shard(full, cfg, mesh)
    check_mesh_ba(mesh, *k8_problem(mesh.device), "the K8_SHAPE problem")
    ref = worker_reference(mesh, label)
    with tempfile.TemporaryDirectory() as tmp:
        check_worker_results(f"nccl, {n} processes, one a card",
                             run_mesh_workers(n, "nccl", tmp), ref)
    log(f"mesh over {n} cards: {time.time() - t0:.1f}s of "
        f"{time.time() - t_start:.1f}s")
    log(json.dumps({"mesh_cards_ok": True, "cards": n}))
    return 0


# ----------------------------------------------------------------------
# phase 9: float64, stage 3 (EdgeGraphConfig(dtype="float64"))
# ----------------------------------------------------------------------

#: f64 coordinates: each double body against its plain twin in f64 on the
#: card.  Both round every operation once in f64 (the walk's fused
#: multiply-adds correctly rounded on both sides), so the differences
#: expected are at the last bit (~1e-13 px at 1600 px); 1e-9 leaves room
#: for a reordered sum and none for an f32 rounding (~1e-4 px here).
F64_COORD_TOL = 1e-9


def f64_name(k: str) -> str:
    return f"{k} (float64)"


def compare_kernels_f64(full, cfg, results):
    """Phase 9(a): each f64 instantiation (K1, K2, K3 at O = 3 and in its
    general body, K4, K7; K5's runs in phase 2) against its plain twin in
    f64, at phase 2's full-scale shapes with the full scene's f64
    context, 0 decision mismatches allowed, timed with CUDA events and
    bounded at the f64 peak."""
    import torch

    from edgegraph3d_tpu_torch import kernels
    from edgegraph3d_tpu_torch.matching import detection, following
    from edgegraph3d_tpu_torch.matching import matches
    from edgegraph3d_tpu_torch.matching import refpoints as rp
    from edgegraph3d_tpu_torch.ops import triangulation
    from edgegraph3d_tpu_torch.plgs.extraction import extract_plgs

    sfmd = full[0]
    cfg64 = cfg.replace(dtype="float64")
    ctx = rp.build_context(sfmd, extract_plgs(full[1], cfg64), cfg64,
                           device="cuda")
    dev = ctx.device
    M = cfg.max_candidates_per_view
    _, obs_mask = rp.dense_observations(sfmd)
    N, V = obs_mask.shape
    Kc = ctx.grids.shape[3]
    log(f"  f64 context: P {ctx.P_mats.dtype}, F {ctx.F_table.dtype}, "
        f"polylines {ctx.plg_coords.dtype}, grids {ctx.grids.dtype}")

    def record(name, *a, **kw):
        record_into(results, f64_name(name), *a, exact=True,
                    peak=PEAK_F64_FLOPS, **kw)

    # K1 as chain extension launches it (M = 1, extension_reanchor_px):
    # the f64 projections of every scene point through every f64 camera,
    # (refpoint, view) rows.  They are not f32 values, so a body that
    # rounded its query points to f32 would disagree with the twin.
    view = torch.arange(V, dtype=torch.int32, device=dev).repeat(N)
    X = torch.as_tensor(sfmd.points, dtype=torch.float64, device=dev)
    pts = rp._project_pos(ctx.P_mats, X).reshape(N * V, 2).contiguous()
    off_f32 = float((pts.float().double() != pts).any(1).double().mean())
    if pts.dtype != torch.float64 or off_f32 < 0.9:
        fail(f"grid_topm_query (float64): query points {pts.dtype}, "
             f"{off_f32:.4f} of them off the f32 grid (want >= 0.9)")
    k1 = dict(mism=0, rows=0, err=0.0, ms=0.0, pms=0.0)
    for m, radius in ((1, cfg.extension_reanchor_px),
                      (M, cfg.detection_starting_dist_px)):
        args = (ctx.grids, view, pts, ctx.cell, radius, m)
        got, ms = cuda_time(lambda: detection.grid_topm_query(
            *args, view_cycle=True), 10)
        ref, pms = cuda_time(lambda: detection._grid_topm_plain(*args), 1)
        mism, err, rows = _cand_diff(got, ref)
        log(f"  grid_topm_query (float64) M={m} radius={radius}: "
            f"rows={rows} off_f32_grid={off_f32:.4f} "
            f"decision_mismatches={mism} max_abs_err={err:.3g} "
            f"kernel_ms={ms:.4f} plain_ms={pms:.4f}")
        if m == 1:
            # the row of the main path's shape; its hits are K5's f64 rows
            # (extension_rows, timed by --time-k5 in phase 2)
            k1.update(mism=mism, rows=rows, err=err, ms=ms, pms=pms)
        elif mism or not err <= F64_COORD_TOL:
            fail(f"grid_topm_query (float64) M={m}: {mism} decision "
                 f"mismatches, max_abs_err {err} (tolerance "
                 f"{F64_COORD_TOL})")
    entries, cells = grid_work(ctx.grids, view, pts, ctx.cell, 1)
    record("grid_topm_query", k1["mism"], k1["rows"], k1["err"], k1["ms"],
           k1["pms"], F64_COORD_TOL,
           work=(k1["rows"] * (20 + 41) + len(cells) * Kc * 24,
                 FLOPS["grid_entry"] * entries))

    # K2: f64 lines from the f64 F over the f32 starts and observations
    args2, starts, oxc, om, _ = k2_phase2_args(ctx, sfmd)
    if args2[3].dtype != torch.float64:
        fail(f"f64 epipolar lines came out {args2[3].dtype}")
    got, ms = cuda_time(lambda: detection.epipolar_topm_query(
        *args2, view_cycle=True), 5)
    ref, pms = cuda_time(lambda: detection._epipolar_topm_plain(*args2), 1)
    mism, err, rows = _cand_diff(got, ref)
    entries, cells = grid_work(ctx.grids, args2[1], args2[2], ctx.cell, 2)
    record("epipolar_topm_query", mism, rows, err, ms, pms, F64_COORD_TOL,
           work=(k2_bytes(args2, len(cells)),
                 FLOPS["epipolar_entry"] * entries))

    # K3: the O = 3 body cold and the general body (the padded loop) warm
    k3 = dict(err=0.0, mism=0, rows=0, ms=0.0, pms=0.0, bytes=0.0,
              flops=0.0)
    for O, warm in ((3, False), (V, True)):
        a, X0, iters, n = k3_inputs(ctx, sfmd, O, warm)
        accept = cfg.match_gn_max_mse
        (Xk, _, okk), ms = cuda_time(lambda: triangulation.triangulate_gn(
            *a, X0=X0, max_iters=iters, accept_mse=accept), 5)
        place = kernels.LAST_PLACEMENT.get("triangulate_gn") \
            if O != 3 else "registers"
        (Xp, _, okp), pms = cuda_time(
            lambda: triangulation._triangulate_gn_plain(
                *a, X0, iters, cfg.gn_epsilon, accept, 1e-5), 1)
        both = okk & okp
        its, warp_its = gn_iterations(*a, X0, iters, cfg.gn_epsilon, accept)
        mask = a[3]
        k3["bytes"] += V * 96 + n * O * 21 + (n * 24 if warm else 0) \
            + n * 33
        k3["flops"] += gn_flops(mask, its, cold=not warm)
        # the general body's padded loop also runs the absent
        # observations: work the function does not need, left out of
        # the bound and logged apart
        padded = 0.0
        if O != 3:
            padded = gn_flops(torch.ones_like(mask), its, cold=not warm) \
                - gn_flops(mask, its, cold=not warm)
        log(f"  triangulate_gn (float64) O={O} warm={warm} ({place}): "
            f"rows={n} valid={int(okp.sum())} mean_iterations={its:.4f} "
            f"padded_loop_extra_flops={padded:.6g} "
            f"mean_per_warp_max_iterations={warp_its:.4f} "
            f"decision_mismatches={int((okk != okp).sum())} "
            f"kernel_ms={ms:.4f} plain_ms={pms:.4f}")
        if both.any():
            k3["err"] = max(k3["err"], float((Xk - Xp).abs()[both].max()))
        for key, v in (("mism", int((okk != okp).sum())), ("rows", n),
                       ("ms", ms), ("pms", pms)):
            k3[key] += v
        del a, X0, Xk, Xp, okk, okp
    record("triangulate_gn", k3["mism"], k3["rows"], k3["err"], k3["ms"],
           k3["pms"], F64_COORD_TOL, work=(k3["bytes"], k3["flops"]))

    # K4: the chunk's seeds, both launches of one follow_seeds call
    both, drive = follow_seed_tuples(ctx, starts, oxc, om, M)
    k4 = dict(mism=0, lanes=0, err=0.0, ms=0.0, pms=0.0, bytes=0.0,
              flops=0.0)
    for mode, fargs in zip(("warm", "cold"),
                           captured_follow_walks(ctx, both, drive)):
        fa, T = fargs[:12], fargs[12]
        got, ms = cuda_time(lambda: following.follow_walk(*fargs), 10)
        walk, gn = following.follow_params(cfg, mode == "warm")
        ref, pms = cuda_time(lambda: following._follow_plain(
            *fa, T, *walk, *gn), 1)
        mism, err, rel = follow_diff(got, ref)
        xerr = float((got.X - ref.X).abs().max())
        work, counts = follow_work(ctx, fa, T, walk, gn, ref, fs=8)
        log(f"  follow_walk (float64) {mode}: lanes={len(fa[4])} T={T} "
            f"decision_mismatches={mism} max_abs_err={err:.3g} "
            f"X_max_abs_err={xerr:.3g} kernel_ms={ms:.4f} "
            f"plain_ms={pms:.4f} {json.dumps(counts)}")
        for key, v in (("mism", mism), ("lanes", len(fa[4])), ("ms", ms),
                       ("pms", pms), ("bytes", work[0]),
                       ("flops", work[1])):
            k4[key] += v
        k4["err"] = max(k4["err"], err, xerr)
    record("follow_walk", k4["mism"], k4["lanes"], k4["err"], k4["ms"],
           k4["pms"], F64_COORD_TOL, work=(k4["bytes"], k4["flops"]))

    # K7: the whole expansion of the full scene's f64 stage-3 chains
    t0 = time.time()
    mgr = matches.MatchesManager(ctx.plg_length.cpu().numpy())
    round0, _ = rp.compute_and_follow_seeds(sfmd, ctx)
    X, obs3, cams3, refs, seed_ids, orders = rp.sweep_seeds(
        None, None, ctx, mgr, precomputed=round0)
    log(f"  expand_chains (float64): the full scene's {len(X)} f64 stage-3"
        f" points ({time.time() - t0:.1f}s)")
    mism, K, err, ms, pms, work = check_expansion(
        ctx, "stage 3 (float64)", rp.chain_chunks(ctx, X, obs3, cams3,
                                                  seed_ids, orders),
        peak=PEAK_F64_FLOPS)
    expect_k7_placement(ctx.config, V)
    record("expand_chains", mism, K, err, ms, pms, F64_COORD_TOL, work=work)
    # "epipolar" mode: its f64 table (1,248 V bytes, 61,152 B here) is
    # the one that must opt in to shared memory above 48 KiB
    ep = dataclasses.replace(ctx, config=ctx.config.replace(
        expand_correspondence_mode="epipolar"))
    check_expansion(ep, "stage 3 (float64, epipolar)",
                    rp.chain_chunks(ep, X, obs3, cams3, seed_ids, orders),
                    peak=PEAK_F64_FLOPS)
    expect_k7_placement(ep.config, V)
    del ctx, ep
    torch.cuda.empty_cache()


def expect_k7_placement(config, V: int) -> None:
    """K7's last f64 launch placed its table where
    kernels.table_placement puts k7_table_bytes on an H100."""
    import torch

    from edgegraph3d_tpu_torch import kernels
    from edgegraph3d_tpu_torch.matching import expansion
    epipolar = config.expand_correspondence_mode == "epipolar"
    n_bytes = expansion.k7_table_bytes(V, epipolar, torch.float64)
    want = kernels.table_placement(n_bytes, kernels.H100_SMEM_OPTIN_BYTES)
    got = kernels.LAST_PLACEMENT.get("expand_chains")
    log(f"  expand_chains (float64, {config.expand_correspondence_mode}): "
        f"table {n_bytes} B at V = {V}, placed {got}")
    if got != want:
        fail(f"expand_chains (float64): table of {n_bytes} B placed {got}, "
             f"not {want}")


def observation_flips(a, b, n0, match_tol=1e-3, device="cuda") -> dict:
    """The edge points of two output scenes matched by position (each of
    a's to its nearest of b's within match_tol scene units, on the card):
    the counts, the points of a with no match, and the matched pairs
    whose view lists differ (an observation flip)."""
    import numpy as np
    import torch
    pa = torch.as_tensor(a.points[n0:], device=device)
    pb = torch.as_tensor(b.points[n0:], device=device)
    dist, idx = [], []
    for lo in range(0, len(pa), 4096):
        d = torch.cdist(pa[lo:lo + 4096], pb)
        m = d.min(1)
        dist.append(m.values)
        idx.append(m.indices)
    dist = torch.cat(dist).cpu().numpy() if dist else np.zeros(0)
    idx = torch.cat(idx).cpu().numpy() if idx else np.zeros(0, np.int64)
    hit = np.flatnonzero(dist <= match_tol)
    flips = sum(not np.array_equal(a.obs_cam[n0 + i], b.obs_cam[n0 + j])
                for i, j in zip(hit, idx[hit]))
    return dict(points=(a.n_points - n0, b.n_points - n0),
                unmatched=int(len(pa) - len(hit)),
                max_matched_distance=float(dist[hit].max()) if len(hit)
                else 0.0, view_list_flips=int(flips))


def check_f64(full, cube, cfg, results):
    """Phase 9: float64 on stage 3.  (a) compare_kernels_f64; (b) the full
    scene through run_pipeline(stages=(3,)) in f64 and in f32, each f64
    instantiation launched, quality floors, the flips and both walls;
    (c) cube8 stage 3 in f64 on MESH_SHARDS shards of cuda:0 bit-equal to
    the single-device f64 run.  Returns (f64 launches of (b), of (c)'s
    mesh run)."""
    from edgegraph3d_tpu_torch import kernels
    from edgegraph3d_tpu_torch.parallel import mesh as pmesh

    compare_kernels_f64(full, cfg, results)
    cfg64 = cfg.replace(dtype="float64")
    run_main_path("full stage 3 (float64)", full, None, stages=(3,),
                  config=cfg64)
    expect_k7_placement(cfg64, full[0].n_cameras)
    run_main_path("full stage 3 (float32)", full, None, stages=(3,))
    f64 = {k: c["float64"] for k, c in
           MAIN_DTYPE_LAUNCHES["full stage 3 (float64)"].items()}
    f32_in_f64 = {k: c["float32"] for k, c in
                  MAIN_DTYPE_LAUNCHES["full stage 3 (float64)"].items()
                  if c["float32"]}
    missing = [k for k in kernels.F64_KERNELS if f64[k] <= 0]
    if missing:
        fail(f"full stage 3 (float64): f64 kernels not launched: {missing}")
    n0 = full[0].n_points
    flips = observation_flips(MAIN_OUTPUTS["full stage 3 (float64)"],
                              MAIN_OUTPUTS["full stage 3 (float32)"], n0)
    log(f"  full stage 3: float64 edge points {flips['points'][0]}, "
        f"float32 {flips['points'][1]}; matched by position "
        f"{json.dumps(flips)}; walls float64 "
        f"{MAIN_WALLS['full stage 3 (float64)']:.3f} s, float32 "
        f"{MAIN_WALLS['full stage 3 (float32)']:.3f} s; f64 launches "
        f"{json.dumps(f64)}; f32 launches in the f64 run "
        f"{json.dumps(f32_in_f64)} (the f32 filter GN and the f32 starts)")
    run_main_path("cube8 stage 3 (float64)", cube, 2, stages=(3,),
                  config=cfg64)
    mesh = pmesh.make_mesh(devices=["cuda:0"] * MESH_SHARDS)
    run_main_path("cube8 stage 3 (float64) mesh", cube, 2, stages=(3,),
                  config=cfg64, mesh=mesh)
    same_scene(f"cube8 stage 3 (float64) on {MESH_SHARDS} shards of cuda:0",
               MAIN_OUTPUTS["cube8 stage 3 (float64) mesh"],
               MAIN_OUTPUTS["cube8 stage 3 (float64)"], x_tol=0.0)
    mesh_f64 = {k: c["float64"] for k, c in
                MAIN_DTYPE_LAUNCHES["cube8 stage 3 (float64) mesh"].items()}
    return f64, mesh_f64


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
    launches["lmeds7_fit"] = check_lmeds7(full, cfg, results)
    torch.cuda.empty_cache()
    # torch.profiler's CUDA trace has come back empty in this process
    # after phase 4 (PERF.md section 7), so K8's device times come from a
    # fresh process
    k8 = subprocess.run([sys.executable, os.path.abspath(__file__),
                         "--time-k8", HERE], capture_output=True,
                        text=True, timeout=600)
    if k8.returncode != 0:
        fail(f"--time-k8 failed ({k8.returncode}): {k8.stdout[-2000:]} "
             f"{k8.stderr[-2000:]}")
    log(f"  K8 alone in a fresh process: {k8.stdout.strip().splitlines()[-1]}")
    host_claims = check_device_claiming(full, cfg)
    check_lmeds(full, cfg)
    ba_launches, _ = run_main_path(
        "cube8 LMedS F + joint BA", cube, 2,
        config=bench_config().replace(fmat_source="lmeds", ba_steps=2))
    if ba_launches["ba_blocks"] != 2:
        fail(f"cube8 joint BA: K8 launched {ba_launches['ba_blocks']} "
             "times in 2 steps")
    log(f"phase 6 wall {time.time() - t0:.1f}s")

    log("== phase 7: debug images and host tools, cube8")
    t0 = time.time()
    debug = check_debug_and_host_tools(cube)
    log(f"debug path: K1 {debug['span']['launches']['grid_topm_query']} and "
        f"K2 {debug['span']['launches']['epipolar_topm_query']} launches in "
        f"the debug_images span of the -i run ({debug['span']['wall_s']:.3f}"
        f" s; with stage-2 sets {debug['span_stage2']['wall_s']:.3f} s)")
    log(f"phase 7 wall {time.time() - t0:.1f}s")

    log("== phase 8: the mesh (edgegraph3d_tpu_torch/parallel)")
    t0 = time.time()
    mesh_launches, per_shard = check_mesh(full, cube, cfg, aug, host_claims)
    del aug, host_claims
    log(f"phase 8 wall {time.time() - t0:.1f}s on {card}")

    log("== phase 9: float64, stage 3")
    t0 = time.time()
    f64_launches, f64_mesh = check_f64(full, cube, cfg, results)
    log(f"phase 9 wall {time.time() - t0:.1f}s on {card} (f64 bounds at "
        f"{PEAK_F64_FLOPS / 1e12:.0f} TFLOP/s and "
        f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s)")

    kern = [dict(name=k, route="cuda", source=KERNEL_META[k][0],
                 replaces=KERNEL_META[k][1], launches=launches[k],
                 mesh_launches=mesh_launches[k], **results[k])
            for k in kernels.KERNEL_NAMES]
    kern += [dict(name=f64_name(k), route="cuda", source=KERNEL_META[k][0],
                  replaces=KERNEL_META[k][1], launches=f64_launches[k],
                  mesh_launches=f64_mesh[k], **results[f64_name(k)])
             for k in kernels.F64_KERNELS]
    log(f"total smoke wall {time.time() - t_start:.1f}s")
    log(json.dumps({"kernels": kern}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def device_runs(fn, kernel: str = "expand_chains", reps: int = 3,
                tries: int = PROFILE_TRIES):
    """fn() (one call: its launches of the kernel whose name holds
    `kernel` and whatever host work surrounds them) once to warm up,
    `reps` times on the host clock after a synchronize, then `reps` times
    more, each alone in a profiler trace of its own, so that every CUDA
    entry of a trace is the run's (splitting one trace of several runs
    by their host ranges, as this did before, found no kernel in the
    first run and one in each other, three traces in a row, on the H100
    machine): per run, each launch's device ms and stream, their sum,
    the device time in which some such kernel ran (the union of their
    intervals: launches on several streams overlap), the span from the
    first start to the last end, and the sum over every CUDA entry of
    the run (`all_ms`: sorts, copies and memsets too).  A trace without
    the kernel is taken again, up to `tries` times, and then fails the
    run: no time is read from an incomplete trace (the profiler's trace
    has come back empty on this machine, in a fresh process too).
    Returns (fn()'s first result, the times)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out = fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        walls.append((time.time() - t0) * 1e3)
    cuda = torch.autograd.DeviceType.CUDA
    runs, retakes = [], 0
    for _ in range(reps):
        for attempt in range(1, tries + 1):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            dev = [e for e in prof.events() if e.device_type == cuda]
            ev = sorted((e.time_range.start, e.time_range.end,
                         getattr(e, "device_resource_id", -1))
                        for e in dev if kernel in e.name)
            if ev:
                break
            retakes += 1
            log(f"  device_runs: trace {attempt} without a {kernel} kernel "
                f"({len(dev)} CUDA entries)")
        else:
            fail(f"device_runs: {tries} profiler traces without a {kernel} "
                 f"launch")
        busy, end = 0.0, ev[0][0]
        for a, b, _ in ev:
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        runs.append(dict(
            launch_ms=[(b - a) / 1e3 for a, b, _ in ev],
            streams=[r for _, _, r in ev],
            sum_ms=sum(b - a for a, b, _ in ev) / 1e3, busy_ms=busy / 1e3,
            span_ms=(end - ev[0][0]) / 1e3,
            all_ms=sum(e.time_range.end - e.time_range.start
                       for e in dev) / 1e3))
    if len({len(r["launch_ms"]) for r in runs}) != 1:
        fail(f"device_runs: the runs' traces hold different counts of "
             f"{kernel} launches: {[len(r['launch_ms']) for r in runs]}")
    return out, dict(wall_ms=walls, runs=runs, retakes=retakes,
                     busy_ms=sum(r["busy_ms"] for r in runs) / reps,
                     all_ms=sum(r["all_ms"] for r in runs) / reps)


def k7_chunk_plans(chunks) -> list:
    """Each chunk's chains by tile bucket and its K7 launches: the
    buckets, chains and warps of each (a checkout without
    expansion.launch_plan makes one launch a chunk, 4, 2, 1 and 1 chains
    a warp)."""
    from edgegraph3d_tpu_torch.matching import expansion
    out = []
    for _, e in chunks:
        hist = tile_histogram(e)
        if hasattr(expansion, "launch_plan"):
            launches = [dict(buckets=[L.bucket], chains=L.n,
                             warps=2 * L.tasks)
                        for L in expansion.launch_plan(e).launches]
        else:
            launches = [dict(buckets=[b for b in range(4) if hist[b]],
                             chains=hist, warps=sum(
                                 -(-n // w) for n, w in zip(hist,
                                                            (4, 2, 1, 1))))]
        out.append(dict(chains_by_bucket=hist, launches=launches))
    return out


def time_k7(root: str) -> int:
    """K7 for the port checkout at `root`, in f32 and f64 on the full
    scene: the launches of one stage-3 expand_and_assemble call and of
    the first chain-extension call, and each tile bucket of the stage-3
    chains alone (bucket_pieces of one chunk of every chain; the 64-slot
    bucket is the one the two-warp tile runs), each by device_runs
    (device ms from profiler traces, in this fresh process) beside the
    bound of its work (expansion_work) and digests of its outputs.
    Prints one JSON line."""
    import numpy as np
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
    out = {"root": root, "source": expansion.__file__, "card": card_name()}

    def timed(entry, fn, digest):
        got, t = device_runs(fn)
        entry.update(t, digest=digest(got))
        return entry

    for dtype, peak in (("float32", PEAK_F32_FLOPS),
                        ("float64", PEAK_F64_FLOPS)):
        cfg = bench_config().replace(dtype=dtype)
        ctx = rp.build_context(sfmd, extract_plgs(edges, cfg), cfg,
                               device="cuda")
        mgr = matches.MatchesManager(ctx.plg_length.cpu().numpy())
        round0, _ = rp.compute_and_follow_seeds(sfmd, ctx)
        res = rp.sweep_seeds(None, None, ctx, mgr, precomputed=round0)
        calls = {"stage3": (ctx, *res),
                 "extension": first_extension_call(ctx, res, mgr)}
        r = out[dtype] = {}
        for label, args in calls.items():
            chunks = [(a, e) for _, a, e in rp.chain_chunks(
                *args[:4], *args[5:7])]
            _, work, stats = expansion_work(ctx, chunks)
            r[label] = timed(
                dict(stats, bound_ms=bound(*work, peak)[0],
                     launch_plan=k7_chunk_plans(chunks)),
                lambda: rp.expand_and_assemble(*args),
                lambda p: [float(p.X.sum()), float(p.obs_xy.sum(dtype=float)),
                           int(p.obs_mask.sum())])
        (a_all, e_all), = [(a, e) for _, a, e in rp.chain_chunks(
            ctx, *res[:3], *res[4:6], chain_chunk=1 << 30)]
        for piece, e in bucket_pieces(a_all, e_all):
            b = int(np.searchsorted(expansion.TILE_SLOTS, e.max()))
            _, work, stats = expansion_work(ctx, [(piece, e)])
            r[f"bucket{b}"] = timed(
                dict(stats, bound_ms=bound(*work, peak)[0],
                     launch_plan=k7_chunk_plans([(piece, e)])),
                lambda: expansion.expand_chains_compact(*piece, extent=e),
                lambda g: [float(g[0].double().sum()),
                           float(g[1].double().sum()), int(g[2].sum())])
        del ctx, calls, res, a_all
        torch.cuda.empty_cache()
    log(json.dumps(out))
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
    totals = kernels.launch_totals()
    out["follow_seeds_launches"] = {k: totals[k] for k in (
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


def time_k5(root: str) -> int:
    """K5 for the port checkout at `root` at its three shapes (k5_times):
    the Pallas probe's (a seeded f32 table [65536, 128], 16,384 int32
    rows), chain extension's on the full scene (int64 rows: the polyline
    K1 finds at M = 1 at every (refpoint, view), phase 2's) and chain
    extension's in f64 (phase 9(a)'s: the f64 context's K1 at the f64
    projections of the scene points).  Prints one JSON line with the
    times and digests of the outputs; it fails if a row differs from
    table[rows]."""
    import torch
    sys.path.insert(0, os.path.abspath(root))
    from edgegraph3d_tpu_torch import kernels
    from edgegraph3d_tpu_torch.matching import detection
    from edgegraph3d_tpu_torch.matching import refpoints as rp
    from edgegraph3d_tpu_torch.ops import gather
    from edgegraph3d_tpu_torch.plgs.extraction import extract_plgs
    if not torch.cuda.is_available():
        fail("no CUDA GPU")
    kernels.build()
    kernels.lib()
    sfmd, edges, _ = full_scene()
    cfg = bench_config()
    out = {"root": root, "source": gather.__file__, "card": card_name()}
    g = torch.Generator(device="cuda").manual_seed(1)
    shapes = [("probe", torch.randn((65536, 128), generator=g, device="cuda"),
               torch.randint(0, 65536, (16384,), generator=g, device="cuda",
                             dtype=torch.int32))]
    obs_xy, _ = rp.dense_observations(sfmd)
    for label, c in (("extension", cfg),
                     ("extension_f64", cfg.replace(dtype="float64"))):
        ctx = rp.build_context(sfmd, extract_plgs(edges, c), c,
                               device="cuda")
        V, P, L, _ = ctx.plg_coords.shape
        view = torch.arange(V, dtype=torch.int32,
                            device=ctx.device).repeat(len(obs_xy))
        if c.dtype == "float64":
            X = torch.as_tensor(sfmd.points, dtype=torch.float64,
                                device=ctx.device)
            pts = rp._project_pos(ctx.P_mats, X).reshape(-1, 2).contiguous()
            kw = {"view_cycle": True}
        else:
            pts = torch.as_tensor(obs_xy, device=ctx.device).reshape(-1, 2)
            kw = {}
        loc = detection.grid_topm_query(ctx.grids, view, pts, ctx.cell,
                                        c.extension_reanchor_px, 1, **kw)
        rows = view.long() * P + loc.pl_id[:, 0].clamp_min(0).long()
        shapes.append((label, ctx.plg_coords.reshape(V * P, 2 * L), rows))
    for label, table, rows in shapes:
        t = out[label] = k5_times(table, rows, 200)
        if t["mismatched_rows"] or not (t["other_index_type_equal"]
                                        and t["launch_alone_equal"]):
            fail(f"gather_rows {label}: {json.dumps(t)}")
    log(json.dumps(out))
    return 0


def time_k2(root: str) -> int:
    """K2 of the port checkout at `root` (e.g. an unpacked `git archive`
    of an earlier commit) against this tree's, in one call: time_k2_checkout
    in a fresh process for root, this tree, this tree and root, in turns.
    Prints each process's JSON line, then one JSON line of device ms per
    item (f32 and f64: phase 2's shape, each main-path launch, the
    one-thread launch alone; the K2 kernel's own and, `all_ms`, every
    CUDA entry of the call) for both checkouts, and fails if an output
    digest differs between them."""
    res = []
    for r in (root, HERE, HERE, root):
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--time-k2-checkout", r], capture_output=True,
                           text=True, timeout=900)
        log(p.stdout)
        if p.returncode != 0:
            fail(f"--time-k2-checkout {r} failed ({p.returncode}): "
                 f"{p.stderr[-3000:]}")
        res.append(json.loads(p.stdout.strip().splitlines()[-1]))
    summary = {"card": card_name(), "parent": root}
    for dtype in ("float32", "float64"):
        for item, t in res[1][dtype].items():
            if "device_ms" not in t:
                continue
            summary[f"{dtype} {item}"] = dict(
                parent_ms=[res[i][dtype][item]["device_ms"] for i in (0, 3)],
                this_ms=[res[i][dtype][item]["device_ms"] for i in (1, 2)],
                parent_all_ms=[res[i][dtype][item].get("all_ms")
                               for i in (0, 3)],
                this_all_ms=[res[i][dtype][item].get("all_ms")
                             for i in (1, 2)],
                bound_ms=t.get("bound_ms"))
            if "digest" in t and any(res[i][dtype][item]["digest"]
                                     != t["digest"] for i in (0, 2, 3)):
                fail(f"--time-k2: {dtype} {item}: outputs differ from the "
                     f"parent's")
    log(json.dumps(summary))
    return 0


def time_k2_checkout(root: str) -> int:
    """K2 for the port checkout at `root`, in f32 and f64 on the full
    scene: phase 2's shape (k2_phase2_args, with its neighbourhood
    counts, k2_neighbourhoods) and each launch of the main path's
    seeding (compute_seeds_chunk over every 1,024-refpoint chunk, as
    compute_and_follow_seeds calls it, arguments captured), each through
    the wrapper by device_runs (device ms from profiler traces: the K2
    kernel's own time and every CUDA entry of the call, sorts included),
    beside its bound and an exact digest of its outputs; then, at phase
    2's shape, the one-thread body's launch alone in the caller's
    (start-major) order, which must equal the wrapper's result, and, for
    this tree, k2_variants.  Phase 2's shape goes through the wrapper as
    the seeding calls it (view_cycle, where the checkout's wrapper takes
    it).  Prints one JSON line."""
    import inspect

    import torch
    sys.path.insert(0, os.path.abspath(root))
    from edgegraph3d_tpu_torch import kernels
    from edgegraph3d_tpu_torch.matching import detection
    from edgegraph3d_tpu_torch.matching import refpoints as rp
    from edgegraph3d_tpu_torch.plgs.extraction import extract_plgs
    if not torch.cuda.is_available():
        fail("no CUDA GPU")
    kernels.build()
    kernels.lib()
    sfmd, edges, _ = full_scene()
    out = {"root": root, "source": detection.__file__, "card": card_name()}
    obs_xy, obs_mask = rp.dense_observations(sfmd)
    start_mask = rp._start_mask(obs_mask, None)
    for dtype, peak in (("float32", PEAK_F32_FLOPS),
                        ("float64", PEAK_F64_FLOPS)):
        cfg = bench_config().replace(dtype=dtype)
        ctx = rp.build_context(sfmd, extract_plgs(edges, cfg), cfg,
                               device="cuda")
        args2, *_, unobserved = k2_phase2_args(ctx, sfmd)
        captured = []
        real = rp.epipolar_topm_query

        def spy(*a, **kw):
            captured.append((a, kw))
            return real(*a, **kw)

        rp.epipolar_topm_query = spy
        try:
            for lo in range(0, len(obs_xy), 1024):
                rp.compute_seeds_chunk(ctx, *(
                    torch.as_tensor(a[lo:lo + 1024], device=ctx.device)
                    for a in (obs_xy, obs_mask, start_mask)))
        finally:
            rp.epipolar_topm_query = real
        r = out[dtype] = dict(neighbourhoods=k2_neighbourhoods(args2,
                                                               unobserved))
        cyc = "view_cycle" in inspect.signature(
            detection.epipolar_topm_query).parameters
        calls = [("phase2", args2, {"view_cycle": True} if cyc else {})] + [
            (f"launch{i}", a, kw) for i, (a, kw) in enumerate(captured)]
        for label, a, kw in calls:
            got, t = device_runs(
                lambda: detection.epipolar_topm_query(*a, **kw),
                "epipolar_topm")
            entries, cells = grid_work(a[0], a[1], a[2], a[5], 2)
            r[label] = dict(
                queries=len(a[1]), kw=sorted(kw), device_ms=t["busy_ms"],
                all_ms=t["all_ms"], runs=t["runs"], wall_ms=t["wall_ms"],
                bound_ms=bound(k2_bytes(a, len(cells)),
                               FLOPS["epipolar_entry"] * entries, peak)[0],
                digest=k2_digest(got))
            if label == "phase2":
                want = got
        Q, M = len(args2[1]), args2[6]
        one = detection._empty_outputs(Q, M, args2[2].device,
                                       args2[3].dtype)
        args1 = (*args2[:4], args2[4].to(args2[3].dtype), *args2[5:])
        _, t = device_runs(lambda: k2_launch(args1, one, "one thread"),
                           "epipolar_topm")
        r["one_thread_start_major"] = dict(
            device_ms=t["busy_ms"], runs=t["runs"],
            identical=all(torch.equal(x, y) for x, y in zip(one, want)))
        if not r["one_thread_start_major"]["identical"]:
            fail(f"epipolar_topm_query {dtype}: the one-thread launch "
                 f"differs from the wrapper")
        if os.path.abspath(root) == HERE:
            k2_variants(args2, want, unobserved, dtype == "float32")
        log(f"  {dtype}: " + json.dumps({k: v.get("device_ms", v) for k, v
                                         in r.items()}))
        del ctx, captured, calls, args1, args2, want, one, got
        torch.cuda.empty_cache()
    log(json.dumps(out))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--mesh-cards"]:
        sys.exit(mesh_cards())
    if len(sys.argv) in (6, 7) and sys.argv[1] == "--mesh-worker":
        sys.exit(mesh_worker(int(sys.argv[2]), int(sys.argv[3]),
                             int(sys.argv[4]), sys.argv[5],
                             *sys.argv[6:]))
    if len(sys.argv) == 3 and sys.argv[1] == "--time-k8":
        sys.exit(time_k8(sys.argv[2]))
    if sys.argv[1:] == ["--check-k9"]:
        sys.exit(check_k9_alone())
    if len(sys.argv) == 3 and sys.argv[1] == "--time-k1-k6":
        sys.exit(time_k1_k6(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--time-k5":
        sys.exit(time_k5(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--time-k2":
        sys.exit(time_k2(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--time-k2-checkout":
        sys.exit(time_k2_checkout(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--time-k7":
        sys.exit(time_k7(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--time-follow":
        sys.exit(time_follow(sys.argv[2]))
    sys.exit(main())
