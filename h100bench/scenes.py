"""Seeded synthetic scenes: the benchmark's own copy of the port's
generator (edgegraph3d_tpu_torch/core/synthetic.py).

It gives the same arrays as the port's `make_dtu_scale_scene` and
`make_cube_scene` for the same arguments and seed, so that later changes
to the port cannot move the yardstick.  The edge images are rendered with
every segment of every camera at once instead of one segment at a time
(the port's version takes about 12 s for the 49-view scene on a CPU);
the pixels set are the same.  Plain numpy; imports nothing of the port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Scene:
    """Cameras, refpoints with their observations, edge images and the
    ground-truth curves the images were drawn from."""
    K: np.ndarray            # [C,3,3] float64
    R: np.ndarray            # [C,3,3] world -> camera
    t: np.ndarray            # [C,3]
    center: np.ndarray       # [C,3]
    widths: np.ndarray       # [C] int64
    heights: np.ndarray      # [C] int64
    points: np.ndarray       # [P,3] refpoints
    obs_cam: list            # P x int32[k]
    obs_xy: list             # P x float64[k,2]
    edge_images: np.ndarray  # [C,H,W] uint8
    curves: list             # ground-truth curve samples, each [n,3]

    @property
    def n_cameras(self) -> int:
        return int(self.K.shape[0])

    @property
    def P(self) -> np.ndarray:
        Rt = np.concatenate([self.R, self.t[:, :, None]], axis=2)
        return np.einsum("cij,cjk->cik", self.K, Rt)


def look_at_rotation(center, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    fwd = target - center
    fwd = fwd / np.linalg.norm(fwd)
    up = np.asarray(up, dtype=np.float64)
    right = np.cross(fwd, up)
    if np.linalg.norm(right) < 1e-9:
        right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd], axis=0)


def ring_cameras(n_cams, radius=4.0, height=1.5, focal=800.0, width=640,
                 height_px=480, height_variation=0.8) -> dict:
    """Cameras evenly spaced on a ring at staggered heights, all looking
    at the origin."""
    target = np.zeros(3)
    angles = np.linspace(0.0, 2.0 * np.pi, n_cams, endpoint=False)
    heights = height + height_variation * np.sin(np.arange(n_cams) * 2.4)
    centers = np.stack(
        [radius * np.cos(angles), radius * np.sin(angles), heights], axis=1)
    Rs = np.stack([look_at_rotation(c, target) for c in centers])
    ts = -np.einsum("cij,cj->ci", Rs, centers)
    K = np.array([[focal, 0.0, width / 2.0],
                  [0.0, focal, height_px / 2.0],
                  [0.0, 0.0, 1.0]])
    return dict(K=np.tile(K, (n_cams, 1, 1)), R=Rs, t=ts, center=centers,
                widths=np.full(n_cams, width, dtype=np.int64),
                heights=np.full(n_cams, height_px, dtype=np.int64))


def projection_matrices(cams: dict) -> np.ndarray:
    Rt = np.concatenate([cams["R"], cams["t"][:, :, None]], axis=2)
    return np.einsum("cij,cjk->cik", cams["K"], Rt)


def project_points(P, X):
    """[N,3] -> (xy [C,N,2], in front [C,N])."""
    Xh = np.concatenate([X, np.ones((len(X), 1))], axis=1)
    proj = np.einsum("cij,nj->cni", P, Xh)
    z = proj[..., 2]
    xy = proj[..., :2] / np.where(np.abs(z) < 1e-12, 1e-12, z)[..., None]
    return xy, z > 1e-9


def in_image(cams, xy, margin=0.0):
    w = cams["widths"][:, None]
    h = cams["heights"][:, None]
    return ((xy[..., 0] >= margin) & (xy[..., 0] < w - margin)
            & (xy[..., 1] >= margin) & (xy[..., 1] < h - margin))


def curve_points(kind: str, n: int, seed: int = 0) -> np.ndarray:
    t = np.linspace(0.0, 1.0, n)
    if kind == "helix":
        return np.stack([0.8 * np.cos(4 * np.pi * t),
                         0.8 * np.sin(4 * np.pi * t), 1.2 * t - 0.6], axis=1)
    if kind == "line":
        rng = np.random.default_rng(seed)
        a = rng.uniform(-0.9, 0.9, 3)
        b = rng.uniform(-0.9, 0.9, 3)
        return a[None] * (1 - t[:, None]) + b[None] * t[:, None]
    if kind == "circle":
        return np.stack([0.7 * np.cos(2 * np.pi * t),
                         0.7 * np.sin(2 * np.pi * t), np.full(n, 0.2)],
                        axis=1)
    if kind == "parabola":
        return np.stack([1.4 * t - 0.7, np.full(n, -0.3),
                         1.5 * (t - 0.5) ** 2 - 0.2], axis=1)
    raise ValueError(f"unknown curve kind {kind!r}")


def cube_edges(side=1.0, n_per_edge=64) -> list:
    s = side / 2.0
    corners = np.array([[sx, sy, sz] for sx in (-s, s)
                        for sy in (-s, s) for sz in (-s, s)])
    pairs = [(a, b) for a in range(8) for b in range(a + 1, 8)
             if np.sum(np.abs(corners[a] - corners[b]) > 1e-9) == 1]
    t = np.linspace(0.0, 1.0, n_per_edge)[:, None]
    return [corners[a][None] * (1 - t) + corners[b][None] * t
            for a, b in pairs]


def _segment_lengths(d: np.ndarray) -> np.ndarray:
    """|d| per row as np.linalg.norm(row) gives it.  The 1-D norm is a
    dot product whose rounding may differ from x*x + y*y; only a length
    within rounding of a whole number can change its ceil, so those few
    are taken again one by one."""
    n = np.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    near = np.flatnonzero(np.abs(n - np.round(n)) <= 1e-9 * np.maximum(n, 1))
    for i in near:
        n[i] = np.linalg.norm(d[i])
    return n


def render_edge_images(cams: dict, P: np.ndarray, curves: list) -> np.ndarray:
    """Binary edge images [C,H,W] uint8: every segment between two
    consecutive visible samples of a curve, sampled at 2 ceil(|b - a|) + 2
    points from a to b (np.linspace's values) and rounded to pixels."""
    H, W = int(cams["heights"].max()), int(cams["widths"].max())
    C = len(P)
    imgs = np.zeros((C, H, W), dtype=np.uint8)
    a_all, b_all, cam_all = [], [], []
    for curve in curves:
        xy, front = project_points(P, curve)
        ok = front & in_image(cams, xy)
        seg = ok[:, :-1] & ok[:, 1:]                  # [C, n-1]
        c, i = np.nonzero(seg)
        a_all.append(xy[c, i])
        b_all.append(xy[c, i + 1])
        cam_all.append(c)
    a = np.concatenate(a_all)
    b = np.concatenate(b_all)
    cam = np.concatenate(cam_all)
    n = np.ceil(_segment_lengths(b - a)).astype(np.int64) * 2 + 2
    seg_of = np.repeat(np.arange(len(n)), n)
    start = np.cumsum(n) - n
    j = np.arange(len(seg_of)) - start[seg_of]
    step = 1.0 / (n - 1).astype(np.float64)
    s = j.astype(np.float64) * step[seg_of]
    s[j == n[seg_of] - 1] = 1.0
    pts = a[seg_of] * (1 - s[:, None]) + b[seg_of] * s[:, None]
    ij = np.round(pts).astype(np.int64)
    ok = (ij[:, 0] >= 0) & (ij[:, 0] < W) & (ij[:, 1] >= 0) & (ij[:, 1] < H)
    imgs[cam[seg_of][ok], ij[ok, 1], ij[ok, 0]] = 255
    return imgs


def _scene(cams, ref_X, keep_min, curves) -> Scene:
    P = projection_matrices(cams)
    xy, front = project_points(P, ref_X)
    vis = front & in_image(cams, xy, margin=1.0)
    keep = np.flatnonzero(vis.sum(axis=0) >= keep_min)
    return Scene(
        **cams, points=ref_X[keep],
        obs_cam=[np.flatnonzero(vis[:, p]).astype(np.int32) for p in keep],
        obs_xy=[xy[vis[:, p], p] for p in keep],
        edge_images=render_edge_images(cams, P, curves), curves=curves)


def make_dtu_scale_scene(n_cams=49, n_refpoints=6268, width=1600,
                         height_px=1200, focal=2200.0, seed=0,
                         n_extra_curves=8, content_seed=None) -> Scene:
    """The dtu006 shape: ring cameras, the 12 cube edges, a helix, a
    circle, a parabola and `n_extra_curves` chords; refpoints sampled over
    all curve samples, each kept when visible in at least 3 views (the
    port's make_dtu_scale_scene, which draws chords and sample from
    `seed`).  With `content_seed` the chords and the sample come from it,
    so that every seed gives the same curves, images and refpoints, and
    `seed` orders the refpoints (refpoints_permuted)."""
    fixed = content_seed is not None
    base = content_seed if fixed else seed
    rng = np.random.default_rng(base)
    cams = ring_cameras(n_cams, width=width, height_px=height_px,
                        focal=focal)
    curves = cube_edges(1.2, 256)
    curves += [curve_points("helix", 512), curve_points("circle", 384),
               curve_points("parabola", 384)]
    for i in range(n_extra_curves):
        curves.append(curve_points("line", 256, seed=base + 10 + i))
    all_pts = np.concatenate(curves)
    take = rng.choice(len(all_pts), size=min(n_refpoints, len(all_pts)),
                      replace=False)
    scene = _scene(cams, all_pts[np.sort(take)], 3, curves)
    if fixed:
        order = np.random.default_rng([seed, 1]).permutation(
            len(scene.points))
        scene = refpoints_permuted(scene, order)
    return scene


def refpoints_permuted(scene: Scene, order: np.ndarray) -> Scene:
    """The scene with refpoint k taken from refpoint order[k]."""
    return Scene(
        K=scene.K, R=scene.R, t=scene.t, center=scene.center,
        widths=scene.widths, heights=scene.heights,
        points=scene.points[order],
        obs_cam=[scene.obs_cam[i] for i in order],
        obs_xy=[scene.obs_xy[i] for i in order],
        edge_images=scene.edge_images, curves=scene.curves)


def make_cube_scene(n_cams=8, side=1.2, n_refpoints_per_edge=8, seed=0,
                    **cam_kw) -> Scene:
    """The 12 edges of a cube seen by a ring (the port's make_cube_scene)."""
    rng = np.random.default_rng(seed)
    cams = ring_cameras(n_cams, **cam_kw)
    curves = cube_edges(side, 96)
    ref_X = np.concatenate([
        c[np.sort(rng.choice(len(c), min(n_refpoints_per_edge, len(c)),
                             replace=False))] for c in curves])
    return _scene(cams, ref_X, 3, curves)


GENERATORS = {"dtu_scale": make_dtu_scale_scene, "cube": make_cube_scene}


def make(spec: dict, seed: int) -> Scene:
    """A scene from a configuration's `scene` entry: {"generator": name,
    **its arguments}, drawn from `seed`."""
    kw = {k: v for k, v in spec.items() if k != "generator"}
    return GENERATORS[spec["generator"]](seed=seed, **kw)
