"""Full edge-matching pipeline orchestration on one GPU.

Port of edgegraph3d_tpu/pipeline.py:

    edge images -> polyline graphs (plgs/extraction.py, native C++)
    -> device context (F table + per-view segment grids)
    -> stage 3: reconstruction from refpoints (matching/refpoints.py)
    -> 2D density filter (filtering/density.py)
    -> append edge-points, write before_filtering.json
    -> GN + view-count outlier filter (filtering/outliers.py)

`run_pipeline` keeps the reference signature (default stages=(1, 2, 3));
stages 1 and 2, joint BA, meshes and debug images are not ported yet and
raise NotImplementedError rather than being skipped.  `device` defaults
to "cuda" and never falls back to the CPU on its own.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from edgegraph3d_tpu_torch.config import DEFAULT_CONFIG, EdgeGraphConfig
from edgegraph3d_tpu_torch.core import sfm as sfm_io
from edgegraph3d_tpu_torch.filtering.density import density_filter
from edgegraph3d_tpu_torch.filtering.outliers import filter_sfm_data
from edgegraph3d_tpu_torch.matching import refpoints as refpoints_mod
from edgegraph3d_tpu_torch.plgs.extraction import extract_plgs

_NOT_PORTED = "is not ported to the torch package yet (ROADMAP queue A item {})"


@dataclass
class PipelineStats:
    """Wall-clock + count bookkeeping."""
    timings: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)
    #: suppression/truncation/overflow observability
    counters: dict = field(default_factory=dict)
    #: float-valued quality/diagnostic metrics
    metrics: dict = field(default_factory=dict)

    def log(self, name: str, t0: float, count: int | None = None):
        self.timings[name] = time.time() - t0
        if count is not None:
            self.counts[name] = count

    def report(self) -> str:
        lines = ["=== edgegraph3d_tpu_torch stats ==="]
        for k, v in self.timings.items():
            c = f"  ({self.counts[k]})" if k in self.counts else ""
            lines.append(f"  {k}: {v:.2f}s{c}")
        if self.counters:
            lines.append("  counters: " + ", ".join(
                f"{k}={v}" for k, v in self.counters.items()))
        if self.metrics:
            lines.append("  metrics: " + ", ".join(
                f"{k}={v:.6g}" for k, v in self.metrics.items()))
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return dict(
            timings={k: round(float(v), 4) for k, v in
                     self.timings.items()},
            counts={k: int(v) for k, v in self.counts.items()},
            counters={k: int(v) for k, v in self.counters.items()},
            metrics={k: float(v) for k, v in self.metrics.items()})


def config_hash(config: EdgeGraphConfig) -> str:
    import dataclasses
    import hashlib
    import json
    blob = json.dumps(dataclasses.asdict(config), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def write_run_manifest(working_folder: str, config: EdgeGraphConfig,
                       stats: PipelineStats, extra: dict | None = None
                       ) -> str:
    """Machine-readable per-run record `stats.json` in the working
    folder: config (+hash), stage timings, counts, counters, and any
    caller-supplied fields."""
    import dataclasses
    import json
    manifest = dict(config_hash=config_hash(config),
                    config=dataclasses.asdict(config),
                    **stats.to_dict())
    if extra:
        manifest.update(extra)
    path = os.path.join(working_folder, "stats.json")
    os.makedirs(working_folder, exist_ok=True)
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True, default=str)
        f.write("\n")
    return path


def edge_points_to_obs_lists(pts: refpoints_mod.EdgePoints):
    """EdgePoints tensors -> ragged per-point obs lists for SfMData."""
    obs_cam, obs_xy = [], []
    for i in range(len(pts.X)):
        cams = np.flatnonzero(pts.obs_mask[i]).astype(np.int32)
        obs_cam.append(cams)
        obs_xy.append(pts.obs_xy[i][cams].astype(np.float64))
    return obs_cam, obs_xy


def reconstruct_all_stages(sfmd, ctx, stats: PipelineStats,
                           stages=(1, 2, 3),
                           max_starting_views: int | None = None):
    """Run the enabled reconstruction stages with one shared interval
    manager, then expansion and chain extension.  Only stage 3 is
    ported; asking for stage 1 or 2 raises."""
    from edgegraph3d_tpu_torch.matching import matches as matches_mod

    for s in stages:
        if s in (1, 2):
            raise NotImplementedError(
                f"stage {s} " + _NOT_PORTED.format(8)
                + "; run with stages=(3,)")
        if s != 3:
            raise ValueError(f"unknown stage {s}")
    V = ctx.P_mats.shape[0]
    manager = matches_mod.MatchesManager(ctx.plg_length.cpu().numpy())
    pieces = []
    if 3 in stages:
        t0 = time.time()
        n = 0
        round0, _ = refpoints_mod.compute_and_follow_seeds(
            sfmd, ctx, max_starting_views=max_starting_views)
        res = (refpoints_mod.sweep_seeds(
            None, None, ctx, manager, seed_id_offset=2 * 10 ** 7,
            precomputed=round0) if round0 is not None else None)
        if res is not None:
            pieces.append(res)
            n = len(res[0])
        stats.log("stage3_refpoints", t0, n)

    if not pieces:
        stats.counters.update(manager.counters)
        return refpoints_mod._empty_points(V)
    merged = [np.concatenate([p[i] for p in pieces]) for i in range(6)]
    t0 = time.time()
    pts = refpoints_mod.expand_and_assemble(ctx, *merged)
    stats.log("expand_all_views", t0, len(pts.X))
    t0 = time.time()
    pts = refpoints_mod.extend_chains(ctx, pts, manager, stats=stats)
    stats.log("chain_extension", t0,
              manager.counters.get("extension_points", 0))
    stats.counters.update(manager.counters)
    return pts


def resolve_device(device) -> torch.device:
    """The requested device; a CUDA request without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA GPU is "
                           "available (pass device='cpu' explicitly)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def run_pipeline(
    sfmd: sfm_io.SfMData,
    edge_images: np.ndarray,
    config: EdgeGraphConfig = DEFAULT_CONFIG,
    working_folder: str | None = None,
    max_starting_views: int | None = None,
    stats: PipelineStats | None = None,
    stages=(1, 2, 3),
    mesh=None,
    debug_images: bool = False,
    device="cuda",
) -> sfm_io.SfMData:
    """In-memory pipeline: returns the filtered, edge-augmented scene."""
    if mesh is not None:
        raise NotImplementedError("mesh sharding " + _NOT_PORTED.format(10))
    if debug_images:
        raise NotImplementedError("debug images " + _NOT_PORTED.format(9))
    if config.ba_steps > 0:
        raise NotImplementedError("joint BA (ba_steps > 0) "
                                  + _NOT_PORTED.format(9))
    dev = resolve_device(device)
    stats = stats if stats is not None else PipelineStats()

    t0 = time.time()
    plg_ckpt = (os.path.join(working_folder, "plgs.npz")
                if working_folder else None)
    if plg_ckpt and os.path.exists(plg_ckpt):
        from edgegraph3d_tpu_torch.plgs.plg_io import load_plg_stack
        stack = load_plg_stack(plg_ckpt)
    else:
        stack = extract_plgs(edge_images, config)
        if plg_ckpt:
            os.makedirs(working_folder, exist_ok=True)
            from edgegraph3d_tpu_torch.plgs.plg_io import save_plg_stack
            save_plg_stack(stack, plg_ckpt)
    stats.log("plg_extraction", t0, int((stack.length >= 2).sum()))
    stats.counters["polylines_dropped_overflow"] = stack.overflow_dropped
    if stack.overflow_dropped:
        import sys
        print(f"WARNING: {stack.overflow_dropped} polylines dropped to "
              f"the max_polylines_per_view={config.max_polylines_per_view}"
              " budget — raise it to keep full recall", file=sys.stderr)

    t0 = time.time()
    ctx = refpoints_mod.build_context(sfmd, stack, config, device=dev)
    stats.log("context(F+grids)", t0)

    pts = reconstruct_all_stages(sfmd, ctx, stats, stages,
                                 max_starting_views)

    t0 = time.time()
    keep = density_filter(pts.obs_xy, pts.obs_mask,
                          int(sfmd.widths.max()), int(sfmd.heights.max()),
                          cell=config.density_cell_size_px)
    pts = pts.select(keep)
    stats.log("density_filter", t0, len(pts.X))

    first_edgepoint = sfmd.n_points
    obs_cam, obs_xy = edge_points_to_obs_lists(pts)
    augmented = sfm_io.add_edge_points(sfmd, pts.X, obs_cam, obs_xy)

    if working_folder:
        os.makedirs(working_folder, exist_ok=True)
        sfm_io.write_sfm_data(
            augmented, os.path.join(working_folder, "before_filtering.json"))
        from edgegraph3d_tpu_torch.plgs.polyline_graph_3d import \
            assemble_from_edge_points
        plg3d = assemble_from_edge_points(pts, sfmd.n_cameras)
        if config.output_3d_simplify:
            plg3d = plg3d.simplify(config.output_3d_simplify_tol)
        if config.output_3d_fragment_maxlen is not None:
            plg3d = plg3d.fragment(config.output_3d_fragment_maxlen)
        plg3d.save(os.path.join(working_folder, "outgraph_3d.npz"))

    t0 = time.time()
    filtered = filter_sfm_data(augmented, first_edgepoint,
                               gn_max_mse=config.filter_gn_max_mse,
                               min_views_floor=config.filter_min_views,
                               epsilon=config.gn_epsilon, device=dev)
    stats.log("outlier_filter", t0, filtered.n_points)

    if working_folder:
        write_run_manifest(working_folder, config, stats, extra=dict(
            n_views=sfmd.n_cameras, n_refpoints=sfmd.n_points,
            n_edge_points_prefilter=augmented.n_points - first_edgepoint,
            n_edge_points=filtered.n_points - first_edgepoint,
            n_points_out=filtered.n_points, device=str(dev)))
    return filtered
