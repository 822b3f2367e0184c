"""Full edge-matching pipeline orchestration on one GPU.

Port of edgegraph3d_tpu/pipeline.py:

    edge images -> polyline graphs (plgs/extraction.py, native C++)
    -> device context (F table + per-view segment grids)
    -> stage 1: similarity match sets, stage 2: closeness match sets,
       each swept for seeds (matching/polyline_stages.py)
    -> stage 3: reconstruction from refpoints (matching/refpoints.py)
    -> expansion and chain extension
    -> 2D density filter (filtering/density.py)
    -> append edge-points, write before_filtering.json
    -> optional joint BA over cameras and points (ops/ba.py, kernel K8;
       config.ba_steps > 0)
    -> GN + view-count outlier filter (filtering/outliers.py)
    -> optional debug images (`debug_images`, utils/drawing.py; the
       detection images run kernels K1 and K2)

`run_pipeline` and `edge_matching` keep the reference signatures
(default stages=(1, 2, 3)).  `device` defaults to "cuda" and never falls
back to the CPU on its own.  With `mesh` (parallel/mesh.py, one process,
or parallel/distributed.global_mesh across processes) the sweeps shard
their work-item axis and joint BA its points over the mesh
(parallel/sharded.py); the unsharded device work runs on the mesh's
first device, and the result equals the single-device run's.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from edgegraph3d_tpu_torch.config import DEFAULT_CONFIG, EdgeGraphConfig
from edgegraph3d_tpu_torch.core import sfm as sfm_io
from edgegraph3d_tpu_torch.devices import resolve_device
from edgegraph3d_tpu_torch.filtering.density import density_filter
from edgegraph3d_tpu_torch.filtering.outliers import filter_sfm_data
from edgegraph3d_tpu_torch.io.images import load_edge_images
from edgegraph3d_tpu_torch.matching import refpoints as refpoints_mod
from edgegraph3d_tpu_torch.plgs.extraction import extract_plgs


def profiler_range(name: str):
    """A range "eg3d.<name>" on torch.profiler's CPU timeline, open for as
    long as the context it returns is entered.

    It is made with the private `torch._C._profiler._RecordFunctionFast`
    because that range is an ordinary CPU operation in the trace
    (`is_user_annotation()` False): a reducer that labels each idle gap
    of the device with the innermost CPU operation open across it
    (h100bench/devtrace.py) then names the program's stage.  A
    `torch.profiler.record_function` range is a user annotation, which
    such a reducer skips, and on the card it also puts a
    `gpu_user_annotation` on the device timeline.  With no profiler
    running the range costs about a microsecond.  Should torch drop the
    class, switch to `torch.profiler.record_function` and have the
    reducer read user annotations on the CPU timeline."""
    return torch._C._profiler._RecordFunctionFast("eg3d." + name)


class Span:
    """One span of `PipelineStats.span` while it is open; set `count`
    before it closes to log a count under its name."""

    def __init__(self, stats: "PipelineStats", name: str,
                 count: int | None):
        self.stats, self.name, self.count = stats, name, count

    def __enter__(self) -> "Span":
        open_ = self.stats.open_spans
        self.parent = open_[-1] if open_ else None
        open_.append(self.name)
        self._range = profiler_range(self.name)
        self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        end_ns = time.time_ns()
        self._range.__exit__(*exc)
        st = self.stats
        st.open_spans.pop()
        st.spans.append((self.name, self.parent, self.start_ns, end_ns))
        st.timings[self.name] = (st.timings.get(self.name, 0.0)
                                 + (end_ns - self.start_ns) / 1e9)
        if self.count is not None:
            st.counts[self.name] = st.counts.get(self.name, 0) + self.count


@dataclass
class PipelineStats:
    """The port's spans, counts and counters for one run.

    `span(name)` times a block of work: its seconds are added to
    `timings[name]` (a name that repeats sums) and its count to
    `counts[name]`, and `spans` gets (name, parent name, start_ns,
    end_ns), both stamps on `time.time_ns()`, the profiler's clock, the
    parent the innermost span open when it started."""
    timings: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)
    #: suppression/truncation/overflow observability
    counters: dict = field(default_factory=dict)
    #: float-valued quality/diagnostic metrics
    metrics: dict = field(default_factory=dict)
    #: closed spans, (name, parent name or None, start_ns, end_ns)
    spans: list = field(default_factory=list)
    #: names of the spans open now, outermost first
    open_spans: list = field(default_factory=list)

    def span(self, name: str, count: int | None = None) -> Span:
        """A context manager timing its block as the span `name` (see
        the class); it also holds `profiler_range(name)`."""
        return Span(self, name, count)

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
            metrics={k: float(v) for k, v in self.metrics.items()},
            spans=[list(sp) for sp in self.spans])


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


def check_stages(config: EdgeGraphConfig, stages) -> None:
    """Refuse, before any work, what the JAX package cannot run: stages
    1 and 2 with dtype="float64".  There the JAX package's group-seed
    sweep fails (a lax.scan carry of f32 t = jnp.float32(0.0) against an
    f64 step, edgegraph3d_tpu/ops/polyline_ops.py:294, reached from
    polyline_stages._group_seed_sweep); the port raises the same refusal
    early."""
    from edgegraph3d_tpu_torch.matching.polyline_stages import F64_REFUSAL
    if config.dtype != "float32" and (1 in stages or 2 in stages):
        raise NotImplementedError(F64_REFUSAL)


def reconstruct_all_stages(sfmd, ctx, stats: PipelineStats,
                           stages=(1, 2, 3),
                           max_starting_views: int | None = None,
                           debug: dict | None = None):
    """Run the enabled reconstruction stages with one shared interval
    manager (stage 1 similarity, stage 2 closeness, stage 3 refpoints,
    each skipping intervals claimed by earlier stages), then expansion
    and chain extension.  A `debug` dict receives what the debug images
    draw: groups1, groups2, manager and edge_points.  On a mesh
    (ctx.mesh) the same stages shard their seeding, following and
    expansion over it.  Values of `stages` other than 1, 2 and 3 are
    ignored, as the JAX package ignores them."""
    from edgegraph3d_tpu_torch.matching import matches as matches_mod
    from edgegraph3d_tpu_torch.matching import polyline_stages

    V = ctx.P_mats.shape[0]
    manager = matches_mod.MatchesManager(ctx.plg_length.cpu().numpy())
    pieces = []

    def sweep(span, round0, offset):
        """Claim and collect one stage's followed seeds."""
        res = (refpoints_mod.sweep_seeds(
            None, None, ctx, manager, seed_id_offset=offset,
            precomputed=round0) if round0 is not None else None)
        if res is not None:
            pieces.append(res)
        span.count = 0 if res is None else len(res[0])

    if 1 in stages:
        with stats.span("stage1_similarity_graph") as sp:
            groups1 = polyline_stages.similarity_match_sets(sfmd, ctx,
                                                            stats=stats)
            sp.count = len(groups1)
        if debug is not None:
            debug["groups1"] = groups1
        with stats.span("stage1_sweep") as sp:
            sweep(sp, polyline_stages.group_seeds_and_follow(groups1,
                                                             ctx)[0], 0)
    if 2 in stages:
        with stats.span("stage2_closeness_graph") as sp:
            groups2 = polyline_stages.closeness_match_sets(sfmd, ctx)
            sp.count = len(groups2)
        if debug is not None:
            debug["groups2"] = groups2
        with stats.span("stage2_sweep") as sp:
            sweep(sp, polyline_stages.group_seeds_and_follow(groups2,
                                                             ctx)[0],
                  10 ** 7)
    if 3 in stages:
        with stats.span("stage3_refpoints") as sp:
            round0, _ = refpoints_mod.compute_and_follow_seeds(
                sfmd, ctx, max_starting_views=max_starting_views)
            sweep(sp, round0, 2 * 10 ** 7)

    if not pieces:
        stats.counters.update(manager.counters)
        return refpoints_mod._empty_points(V)
    merged = [np.concatenate([p[i] for p in pieces]) for i in range(6)]
    with stats.span("expand_all_views") as sp:
        pts = refpoints_mod.expand_and_assemble(ctx, *merged, stats=stats)
        sp.count = len(pts.X)
    with stats.span("chain_extension") as sp:
        pts = refpoints_mod.extend_chains(ctx, pts, manager, stats=stats)
        sp.count = manager.counters.get("extension_points", 0)
    stats.counters.update(manager.counters)
    if debug is not None:
        debug["manager"] = manager
        debug["edge_points"] = pts
    return pts


def joint_ba_refine(sfmd: sfm_io.SfMData, n_steps: int,
                    damping: float = 1e-4, device="cuda", mesh=None):
    """Joint Schur-complement LM over the (augmented) scene: camera
    poses AND all 3D points free, intrinsics fixed, camera 0
    gauge-fixed (ops/ba.py; kernel K8 on the card).  Observations are
    dense, one slot per view (O = V, cam = arange(V)).  The JAX
    package's pow2 padding of the point axis (a compile-cache measure)
    is dropped: padded rows would add exact zeros to S and rhs.  With
    `mesh`, the point axis is padded to a multiple of its shard count
    (rows with no observation) and the steps run sharded
    (sharded.distributed_ba); the rest runs on the mesh's first device.

    Returns (refined SfMData, mse_before, mse_after) in px^2, with R and
    t in float64 and the centers recomputed."""
    import dataclasses

    from edgegraph3d_tpu_torch.ops import ba as ba_ops
    from edgegraph3d_tpu_torch.parallel.mesh import pad_to_multiple

    dev = resolve_device(device) if mesh is None else mesh.device
    N, V = sfmd.n_points, sfmd.n_cameras
    if N == 0 or n_steps <= 0:
        return sfmd, None, None
    obs_xy, obs_mask = refpoints_mod.dense_observations(sfmd)
    points = sfmd.points
    if mesh is not None:
        obs_xy, obs_mask, points = (pad_to_multiple(a, mesh.size)
                                    for a in (obs_xy, obs_mask, points))
    Np = len(points)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    cam = torch.arange(V, dtype=torch.int32, device=dev).repeat(Np, 1)
    xy = f32(obs_xy)
    mask = torch.as_tensor(obs_mask, device=dev)
    state = ba_ops.BAState(K=f32(sfmd.K), R=f32(sfmd.R), t=f32(sfmd.t),
                           X=f32(points))
    if mesh is None:
        st, mses = ba_ops.ba_run(state, cam, xy, mask, n_steps, damping)
    else:
        from edgegraph3d_tpu_torch.parallel import sharded
        st, mses = sharded.distributed_ba(mesh, state, cam, xy, mask,
                                          n_steps, damping)
    mse_after = ba_ops.ba_mse(st, cam, xy, mask)
    # one read back to the host for everything
    flat = torch.cat([st.X[:N].reshape(-1), st.R.reshape(-1),
                      st.t.reshape(-1), mses,
                      mse_after.reshape(1)]).cpu().numpy()
    o1, o2, o3 = N * 3, N * 3 + V * 9, N * 3 + V * 12
    R_new = flat[o1:o2].reshape(V, 3, 3).astype(np.float64)
    t_new = flat[o2:o3].reshape(V, 3).astype(np.float64)
    out = dataclasses.replace(
        sfmd, points=flat[:o1].reshape(N, 3).astype(np.float64), R=R_new,
        t=t_new, center=-np.einsum("vji,vj->vi", R_new, t_new))
    return out, float(flat[o3]), float(flat[-1])


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
    """In-memory pipeline: returns the filtered, edge-augmented scene.
    With `debug_images` and a working folder, the `-i` debug-image suite
    is written into the folder (utils/drawing.save_debug_images).  With
    `mesh` (parallel/mesh.Mesh; its devices of `device`'s type), the
    sweeps and joint BA are sharded over it and the unsharded device
    work runs on its first device.  config.dtype="float64" runs stage 3
    only (check_stages)."""
    check_stages(config, stages)
    dev = resolve_device(device)
    if mesh is not None:
        if mesh.device.type != dev.type:
            raise ValueError(f"mesh on {mesh.device} but device={device!r}")
        dev = mesh.device
    stats = stats if stats is not None else PipelineStats()
    with stats.span("run_pipeline"):
        with stats.span("plg_extraction") as sp:
            plg_ckpt = (os.path.join(working_folder, "plgs.npz")
                        if working_folder else None)
            if plg_ckpt and os.path.exists(plg_ckpt):
                from edgegraph3d_tpu_torch.plgs.plg_io import load_plg_stack
                stack = load_plg_stack(plg_ckpt)
            else:
                stack = extract_plgs(edge_images, config)
                if plg_ckpt:
                    os.makedirs(working_folder, exist_ok=True)
                    from edgegraph3d_tpu_torch.plgs.plg_io import \
                        save_plg_stack
                    save_plg_stack(stack, plg_ckpt)
            sp.count = int((stack.length >= 2).sum())
        stats.counters["polylines_dropped_overflow"] = \
            stack.overflow_dropped
        if stack.overflow_dropped:
            import sys
            print(f"WARNING: {stack.overflow_dropped} polylines dropped to "
                  "the max_polylines_per_view="
                  f"{config.max_polylines_per_view} budget — raise it to "
                  "keep full recall", file=sys.stderr)

        with stats.span("context(F+grids)"):
            ctx = refpoints_mod.build_context(sfmd, stack, config,
                                              device=dev, mesh=mesh,
                                              stats=stats)

        debug: dict | None = {} if debug_images else None
        pts = reconstruct_all_stages(sfmd, ctx, stats, stages,
                                     max_starting_views, debug=debug)

        with stats.span("density_filter") as sp:
            stats.counters["density_points_in"] = len(pts.X)
            keep = density_filter(pts.obs_xy, pts.obs_mask,
                                  int(sfmd.widths.max()),
                                  int(sfmd.heights.max()),
                                  cell=config.density_cell_size_px)
            pts = pts.select(keep)
            sp.count = len(pts.X)

        first_edgepoint = sfmd.n_points
        with stats.span("append_edge_points"):
            obs_cam, obs_xy = edge_points_to_obs_lists(pts)
            augmented = sfm_io.add_edge_points(sfmd, pts.X, obs_cam,
                                               obs_xy)

        if working_folder:
            with stats.span("write_checkpoints"):
                os.makedirs(working_folder, exist_ok=True)
                sfm_io.write_sfm_data(augmented, os.path.join(
                    working_folder, "before_filtering.json"))
                from edgegraph3d_tpu_torch.plgs.polyline_graph_3d import \
                    assemble_from_edge_points
                plg3d = assemble_from_edge_points(pts, sfmd.n_cameras)
                if config.output_3d_simplify:
                    plg3d = plg3d.simplify(config.output_3d_simplify_tol)
                if config.output_3d_fragment_maxlen is not None:
                    plg3d = plg3d.fragment(
                        config.output_3d_fragment_maxlen)
                plg3d.save(os.path.join(working_folder, "outgraph_3d.npz"))

        if config.ba_steps > 0:
            # optional joint refinement (cameras + points free), judged by
            # the outlier filter below
            with stats.span("joint_ba", config.ba_steps):
                augmented, mse0, mse1 = joint_ba_refine(
                    augmented, config.ba_steps, config.ba_damping,
                    device=dev, mesh=mesh)
            if mse0 is not None:
                stats.metrics["ba_mse_before"] = mse0
                stats.metrics["ba_mse_after"] = mse1

        with stats.span("outlier_filter") as sp:
            filtered = filter_sfm_data(
                augmented, first_edgepoint,
                gn_max_mse=config.filter_gn_max_mse,
                min_views_floor=config.filter_min_views,
                epsilon=config.gn_epsilon, device=dev)
            sp.count = filtered.n_points

        if debug_images and working_folder:
            # the full -i suite (parity: edge_matcher.cpp:89-96,138-143),
            # with the JAX package's arguments, the edge images as
            # rgb_images included
            from edgegraph3d_tpu_torch.utils.drawing import save_debug_images
            with stats.span("debug_images"):
                save_debug_images(
                    filtered, working_folder, stack=stack,
                    first_edgepoint=first_edgepoint,
                    rgb_images=edge_images,
                    groups_stage1=debug.get("groups1"),
                    groups_stage2=debug.get("groups2"),
                    F_table=ctx.F_table.cpu().numpy(),
                    epipolar_refpoints=range(0, min(3, sfmd.n_points)),
                    manager=debug.get("manager"),
                    edge_points=debug.get("edge_points"),
                    P_mats=ctx.P_mats.cpu().numpy(), ctx=ctx)
    if working_folder:
        write_run_manifest(working_folder, config, stats, extra=dict(
            n_views=sfmd.n_cameras, n_refpoints=sfmd.n_points,
            n_edge_points_prefilter=augmented.n_points - first_edgepoint,
            n_edge_points=filtered.n_points - first_edgepoint,
            n_points_out=filtered.n_points, device=str(dev)))
    return filtered


def edge_matching(images_folder: str, edges_folder: str,
                  working_folder: str, sfm_data_file: str,
                  output_json: str,
                  config: EdgeGraphConfig = DEFAULT_CONFIG,
                  max_starting_views: int | None = None,
                  debug_images: bool = False,
                  device="cuda") -> sfm_io.SfMData:
    """File-level entry: read the OpenMVG JSON and the edge images, run
    the pipeline, write the output JSON.  `images_folder` is accepted for
    interface parity (the debug images draw on the edge images, as the
    JAX package's do)."""
    stats = PipelineStats()
    sfmd = sfm_io.read_sfm_data(sfm_data_file)
    edge_images = load_edge_images(edges_folder, sfmd.image_paths)
    out = run_pipeline(sfmd, edge_images, config, working_folder,
                       max_starting_views, stats,
                       debug_images=debug_images, device=device)
    sfm_io.write_sfm_data(out, output_json)
    print(stats.report())
    return out
