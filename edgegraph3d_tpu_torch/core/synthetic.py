"""Synthetic multi-view scenes for tests and benchmarks.

The reference's only integration fixture (example/dtu006) ships edge
images but its `input.json` is stripped from the mirror, so the test
suite builds fully-known synthetic scenes instead: cameras on a ring
looking at the origin, 3D space curves, exact projections, and rendered
binary edge images — giving golden values for every stage.
"""

from __future__ import annotations

import numpy as np

from edgegraph3d_tpu_torch.core.sfm import SfMData


def look_at_rotation(center: np.ndarray, target: np.ndarray,
                     up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """World->camera rotation with +z forward (OpenMVG convention)."""
    fwd = target - center
    fwd = fwd / np.linalg.norm(fwd)
    up = np.asarray(up, dtype=np.float64)
    right = np.cross(fwd, up)
    if np.linalg.norm(right) < 1e-9:
        right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd], axis=0)


def ring_cameras(n_cams: int, radius: float = 4.0, height: float = 1.5,
                 focal: float = 800.0, width: int = 640, height_px: int = 480,
                 target=(0.0, 0.0, 0.0),
                 height_variation: float = 0.8) -> SfMData:
    """Cameras evenly spaced on a ring, all looking at `target`.

    Heights oscillate by `height_variation` so epipolar lines between
    neighboring views are not mutually parallel (a flat ring is an
    epipolar-degenerate rig for horizontal scene curves; real capture
    rigs like DTU's robot arm vary elevation)."""
    target = np.asarray(target, dtype=np.float64)
    angles = np.linspace(0.0, 2.0 * np.pi, n_cams, endpoint=False)
    heights = height + height_variation * np.sin(
        np.arange(n_cams) * 2.4)        # irrational-step stagger
    centers = np.stack(
        [radius * np.cos(angles), radius * np.sin(angles), heights],
        axis=1)
    Rs = np.stack([look_at_rotation(c, target) for c in centers])
    ts = -np.einsum("cij,cj->ci", Rs, centers)
    K = np.array([[focal, 0.0, width / 2.0],
                  [0.0, focal, height_px / 2.0],
                  [0.0, 0.0, 1.0]])
    Ks = np.tile(K, (n_cams, 1, 1))
    return SfMData(
        K=Ks, R=Rs, t=ts, center=centers,
        widths=np.full(n_cams, width, dtype=np.int64),
        heights=np.full(n_cams, height_px, dtype=np.int64),
        image_paths=[f"synthetic_{i:04d}.png" for i in range(n_cams)],
        points=np.zeros((0, 3)), obs_cam=[], obs_xy=[], raw_doc=None,
    )


def project_points(sfmd: SfMData, X: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Project [N,3] world points into every camera.

    Returns (xy [C,N,2], in_front [C,N])."""
    P = sfmd.P
    Xh = np.concatenate([X, np.ones((len(X), 1))], axis=1)
    proj = np.einsum("cij,nj->cni", P, Xh)
    z = proj[..., 2]
    xy = proj[..., :2] / np.where(np.abs(z) < 1e-12, 1e-12, z)[..., None]
    return xy, z > 1e-9


def in_image(sfmd: SfMData, xy: np.ndarray, margin: float = 0.0) -> np.ndarray:
    """[C,N,2] -> [C,N] bool inside image bounds."""
    w = sfmd.widths[:, None]
    h = sfmd.heights[:, None]
    return ((xy[..., 0] >= margin) & (xy[..., 0] < w - margin)
            & (xy[..., 1] >= margin) & (xy[..., 1] < h - margin))


# ----------------------------------------------------------------------
# Space curves
# ----------------------------------------------------------------------

def curve_points(kind: str, n: int, seed: int = 0) -> np.ndarray:
    """Sample [n,3] points along a named space curve inside the unit-ish box."""
    t = np.linspace(0.0, 1.0, n)
    if kind == "helix":
        return np.stack([0.8 * np.cos(4 * np.pi * t),
                         0.8 * np.sin(4 * np.pi * t),
                         1.2 * t - 0.6], axis=1)
    if kind == "line":
        rng = np.random.default_rng(seed)
        a = rng.uniform(-0.9, 0.9, 3)
        b = rng.uniform(-0.9, 0.9, 3)
        return a[None] * (1 - t[:, None]) + b[None] * t[:, None]
    if kind == "circle":
        return np.stack([0.7 * np.cos(2 * np.pi * t),
                         0.7 * np.sin(2 * np.pi * t),
                         np.full(n, 0.2)], axis=1)
    if kind == "parabola":
        return np.stack([1.4 * t - 0.7,
                         np.full(n, -0.3),
                         1.5 * (t - 0.5) ** 2 - 0.2], axis=1)
    raise ValueError(f"unknown curve kind {kind!r}")


def cube_edges(side: float = 1.0, n_per_edge: int = 64) -> list[np.ndarray]:
    """The 12 edges of an axis-aligned cube centered at origin."""
    s = side / 2.0
    corners = np.array([[sx, sy, sz] for sx in (-s, s)
                        for sy in (-s, s) for sz in (-s, s)])
    pairs = [(a, b) for a in range(8) for b in range(a + 1, 8)
             if np.sum(np.abs(corners[a] - corners[b]) > 1e-9) == 1]
    t = np.linspace(0.0, 1.0, n_per_edge)[:, None]
    return [corners[a][None] * (1 - t) + corners[b][None] * t for a, b in pairs]


# ----------------------------------------------------------------------
# Edge-image rendering
# ----------------------------------------------------------------------

def draw_polyline(img: np.ndarray, xy: np.ndarray) -> None:
    """Rasterize a 2D polyline as 1px white pixels (in place).

    Dense sampling along each segment, then rounding — adequate for
    producing the thin binary edge maps the extractor consumes."""
    h, w = img.shape
    for i in range(len(xy) - 1):
        a, b = xy[i], xy[i + 1]
        n = int(np.ceil(np.linalg.norm(b - a))) * 2 + 2
        pts = a[None] * (1 - np.linspace(0, 1, n)[:, None]) + \
            b[None] * np.linspace(0, 1, n)[:, None]
        ij = np.round(pts).astype(np.int64)
        ok = (ij[:, 0] >= 0) & (ij[:, 0] < w) & (ij[:, 1] >= 0) & (ij[:, 1] < h)
        img[ij[ok, 1], ij[ok, 0]] = 255


def render_edge_images(sfmd: SfMData, curves: list[np.ndarray]) -> np.ndarray:
    """Render binary edge images [C,H,W] uint8 from 3D curves."""
    H = int(sfmd.heights.max())
    W = int(sfmd.widths.max())
    imgs = np.zeros((sfmd.n_cameras, H, W), dtype=np.uint8)
    for curve in curves:
        xy, front = project_points(sfmd, curve)
        inb = in_image(sfmd, xy)
        for c in range(sfmd.n_cameras):
            ok = front[c] & inb[c]
            # draw maximal visible runs
            idx = np.flatnonzero(ok)
            if len(idx) < 2:
                continue
            splits = np.flatnonzero(np.diff(idx) > 1)
            for seg in np.split(idx, splits + 1):
                if len(seg) >= 2:
                    draw_polyline(imgs[c], xy[c, seg])
    return imgs


def make_cube_scene(n_cams: int = 8, side: float = 1.2,
                    n_refpoints_per_edge: int = 8, seed: int = 0,
                    **cam_kw):
    """Cube-edge fixture: long straight polylines that cross only at
    corners — the well-conditioned case for chain following."""
    rng = np.random.default_rng(seed)
    sfmd = ring_cameras(n_cams, **cam_kw)
    curves = cube_edges(side, 96)
    ref_X = np.concatenate([
        c[np.sort(rng.choice(len(c), min(n_refpoints_per_edge, len(c)),
                             replace=False))] for c in curves])
    xy, front = project_points(sfmd, ref_X)
    inb = in_image(sfmd, xy, margin=1.0)
    vis = front & inb
    obs_cam, obs_xy, keep = [], [], []
    for p in range(len(ref_X)):
        cams = np.flatnonzero(vis[:, p])
        if len(cams) >= 3:
            obs_cam.append(cams.astype(np.int32))
            obs_xy.append(xy[cams, p])
            keep.append(p)
    sfmd.points = ref_X[keep]
    sfmd.obs_cam = obs_cam
    sfmd.obs_xy = obs_xy
    edge_imgs = render_edge_images(sfmd, curves)
    return sfmd, edge_imgs, curves


def make_dtu_scale_scene(n_cams: int = 49, n_refpoints: int = 6268,
                         width: int = 1600, height_px: int = 1200,
                         focal: float = 2200.0, seed: int = 0,
                         n_extra_curves: int = 8):
    """dtu006-shaped workload: ring cameras at the reference example's
    scale (49 views @1600x1200, 6268 refpoints — example/dtu006/README.md),
    geometry rich enough that every view carries dozens of polylines:
    the 12 cube edges plus helix/circle/parabola plus random chords.
    Refpoints are sampled across ALL curves proportional to sample
    count, each kept when visible in >= 3 views.

    The reference's own input.json is stripped from the mirror
    (.MISSING_LARGE_BLOBS), so this synthetic proxy is the standing
    full-scale fixture; ground-truth curves make quality measurable."""
    rng = np.random.default_rng(seed)
    sfmd = ring_cameras(n_cams, width=width, height_px=height_px,
                        focal=focal)
    curves = cube_edges(1.2, 256)
    curves += [curve_points("helix", 512), curve_points("circle", 384),
               curve_points("parabola", 384)]
    for i in range(n_extra_curves):
        curves.append(curve_points("line", 256, seed=seed + 10 + i))

    all_pts = np.concatenate(curves)
    take = rng.choice(len(all_pts), size=min(n_refpoints, len(all_pts)),
                      replace=False)
    ref_X = all_pts[np.sort(take)]
    xy, front = project_points(sfmd, ref_X)
    inb = in_image(sfmd, xy, margin=1.0)
    vis = front & inb
    n_vis = vis.sum(axis=0)
    keep = np.flatnonzero(n_vis >= 3)
    obs_cam = [np.flatnonzero(vis[:, p]).astype(np.int32) for p in keep]
    obs_xy = [xy[vis[:, p], p] for p in keep]
    sfmd.points = ref_X[keep]
    sfmd.obs_cam = obs_cam
    sfmd.obs_xy = obs_xy
    edge_imgs = render_edge_images(sfmd, curves)
    return sfmd, edge_imgs, curves


def make_scene(
    n_cams: int = 8,
    curves=("helix", "circle", "parabola"),
    n_refpoints_per_curve: int = 24,
    n_curve_samples: int = 400,
    noise_px: float = 0.0,
    seed: int = 0,
    **cam_kw,
) -> tuple[SfMData, np.ndarray, list[np.ndarray]]:
    """Full synthetic fixture.

    Returns (sfmd with refpoints populated, edge_images [C,H,W], curves).
    Refpoints are sampled along the curves; observations are exact
    projections (+ optional pixel noise) in all cameras that see them.
    """
    rng = np.random.default_rng(seed)
    sfmd = ring_cameras(n_cams, **cam_kw)
    curve_list = [curve_points(k, n_curve_samples, seed=seed + i)
                  for i, k in enumerate(curves)]

    ref_X = []
    for c in curve_list:
        take = rng.choice(len(c), size=min(n_refpoints_per_curve, len(c)),
                          replace=False)
        ref_X.append(c[np.sort(take)])
    ref_X = np.concatenate(ref_X, axis=0)

    xy, front = project_points(sfmd, ref_X)
    inb = in_image(sfmd, xy, margin=1.0)
    vis = front & inb
    obs_cam, obs_xy, keep = [], [], []
    for p in range(len(ref_X)):
        cams = np.flatnonzero(vis[:, p])
        if len(cams) < 3:
            continue
        pts2d = xy[cams, p]
        if noise_px > 0:
            pts2d = pts2d + rng.normal(0.0, noise_px, pts2d.shape)
        obs_cam.append(cams.astype(np.int32))
        obs_xy.append(pts2d)
        keep.append(p)
    sfmd.points = ref_X[keep]
    sfmd.obs_cam = obs_cam
    sfmd.obs_xy = obs_xy

    edge_imgs = render_edge_images(sfmd, curve_list)
    return sfmd, edge_imgs, curve_list
