"""The plain reference that decides `correct`.

It judges the edge-points a `run_pipeline` call returned against the
seeded scene the call was given (scenes.Scene: cameras, refpoints, edge
images, ground-truth curves) and nothing else the program made.  The
program's output is an SfMData whose points are the surviving refpoints
followed by the edge-points, each with its observations (view, x, y).
From those observations alone the reference works the numbers out
again, in float64 on the CPU:

- `gap_px`: every output point is triangulated anew from its own
  observations (a linear least-squares start, then Gauss-Newton on the
  reprojection error, the cost the program's outlier filter minimises);
  the number is the widest distance, over the points and their views,
  between the projections of the program's point and the reference's.
- `mse_px2`: the largest reprojection MSE (sum of squared residuals over
  2 n, px^2) of an output point at the program's own coordinates; the
  configuration's GN outlier gate bounds it.
- `min_views`: the fewest observations of an edge-point; the outlier
  filter keeps only edge-points seen by more than `filter_min_views`.
- `unclaimed`: edge-points without a density cell of their own (a cell of
  `density_cell_size_px` px in one of their views that no earlier
  edge-point occupies): the density filter keeps a point only then.
- `edge_points`: how many edge-points the output holds; where the
  traffic runs stages 1-2 ahead of a stage 3 that starts from few views,
  the edge-points that only stages 1-2 find lift it above what stage 3
  finds alone.
- `coverage`: the share of ground-truth curve samples with an edge-point
  near (completeness); `med_dist3d`: the median distance of an
  edge-point to the curves (accuracy).  The repository's quality
  metrics, copied.

Imports torch and numpy only: nothing of the program, nor of JAX.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

#: rows of points triangulated at once
BLOCK = 8192
#: the program decides its GN gate in float32 on projections of about
#: 1,000 px, whose residuals carry about 1e-4 px of rounding; the gate
#: is held with this relative slack
F32_GATE_SLACK = 2.0 ** -10


@dataclass
class Output:
    """What one `run_pipeline` call returned, copied to the host."""
    points: np.ndarray          # [M,3]
    obs_cam: list               # M x int[k]
    obs_xy: list                # M x float[k,2]


def output_of(sfmd) -> Output:
    return Output(points=np.asarray(sfmd.points, np.float64).copy(),
                  obs_cam=[np.asarray(c).copy() for c in sfmd.obs_cam],
                  obs_xy=[np.asarray(x).copy() for x in sfmd.obs_xy])


def first_edge_point(scene, out: Output) -> int:
    """Index of the first edge-point in `out`: the refpoints that survive
    come first, in their input order and with their input observations."""
    j, n_ref = 0, len(scene.obs_xy)
    for i in range(len(out.obs_xy)):
        while j < n_ref and not (
                len(out.obs_xy[i]) == len(scene.obs_xy[j])
                and np.array_equal(out.obs_cam[i], scene.obs_cam[j])
                and np.array_equal(out.obs_xy[i], scene.obs_xy[j])):
            j += 1
        if j == n_ref:
            return i
        j += 1
    return len(out.obs_xy)


def pad_observations(obs_cam, obs_xy):
    """Ragged observations -> (cam [N,O] int64, xy [N,O,2] f64, mask)."""
    n = len(obs_cam)
    O = max([len(c) for c in obs_cam] + [1])
    cam = np.zeros((n, O), np.int64)
    xy = np.zeros((n, O, 2), np.float64)
    mask = np.zeros((n, O), bool)
    for i, (c, p) in enumerate(zip(obs_cam, obs_xy)):
        k = len(c)
        cam[i, :k] = c
        xy[i, :k] = np.asarray(p, np.float64).reshape(k, 2)
        mask[i, :k] = True
    return cam, xy, mask


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest, ties to
    even), as tensor cores round a matmul's operands."""
    i = x.contiguous().view(torch.int32)
    i = (i + (0x0FFF + ((i >> 13) & 1))) & -0x2000
    return i.view(torch.float32)


def _mm(a, b, tf32: bool):
    """a @ b; with `tf32`, TF32's rounding of both operands, the products
    exact and summed in float32, as a TF32 matmul does."""
    if tf32:
        a, b = to_tf32(a), to_tf32(b)
    return a @ b


def _solve3(H, g, tf32=False):
    """Solve H x = g for batches of 3x3 systems by cofactors, in H's type
    (so that a lower precision stays low)."""
    a, b, c = H[:, 0, 0], H[:, 0, 1], H[:, 0, 2]
    d, e, f = H[:, 1, 0], H[:, 1, 1], H[:, 1, 2]
    p, q, r = H[:, 2, 0], H[:, 2, 1], H[:, 2, 2]
    A, B, C = e * r - f * q, f * p - d * r, d * q - e * p
    det = a * A + b * B + c * C
    det = torch.where(det.abs() > 0, det, torch.ones_like(det))
    inv = torch.stack([
        torch.stack([A, c * q - b * r, b * f - c * e], -1),
        torch.stack([B, a * r - c * p, c * d - a * f], -1),
        torch.stack([C, b * p - a * q, a * e - b * d], -1)], -2) / det[:, None, None]
    return _mm(inv, g[..., None], tf32)[..., 0]


def _project(Pc, X, tf32=False):
    """Pc [N,O,3,4], X [N,3] -> (h [N,O,3]) with h = P [X; 1]."""
    Xh = torch.cat([X, torch.ones_like(X[:, :1])], -1)
    return _mm(Pc, Xh[:, None, :, None], tf32)[..., 0]


def triangulate(P, cam, xy, mask, dtype=torch.float64, device="cpu",
                iters: int = 12, tf32: bool = False):
    """Least-squares triangulation of each row's observations: the linear
    solution of x P3 - P1 = 0, y P3 - P2 = 0, then `iters` Gauss-Newton
    steps on the reprojection error.  Every product of vectors runs as a
    matmul in `dtype` on `device`; with `tf32` (float32 only) each as a
    TF32 matmul.  Returns (X [N,3] f64, last step's largest move)."""
    P = torch.as_tensor(P, dtype=dtype, device=device)
    cam = torch.as_tensor(cam, device=device)
    xy = torch.as_tensor(xy, dtype=dtype, device=device)
    m = torch.as_tensor(mask, device=device).to(dtype)
    Pc = P[cam]                                           # [N,O,3,4]
    x, y = xy[..., 0], xy[..., 1]
    # linear start: rows (x P3 - P1), (y P3 - P2) of A [X; 1] = 0
    rows = torch.cat([x[..., None] * Pc[:, :, 2] - Pc[:, :, 0],
                      y[..., None] * Pc[:, :, 2] - Pc[:, :, 1]], 1)
    rows = rows * torch.cat([m, m], 1)[..., None]        # [N,2O,4]
    A, b = rows[..., :3], -rows[..., 3]
    At = A.transpose(1, 2)
    X = _solve3(_mm(At, A, tf32), _mm(At, b[..., None], tf32)[..., 0], tf32)
    move = torch.zeros((), dtype=dtype, device=device)
    for _ in range(iters):
        h = _project(Pc, X, tf32)
        hz = h[..., 2]
        u, v = h[..., 0] / hz, h[..., 1] / hz
        r = torch.cat([(u - x) * m, (v - y) * m], 1)     # [N,2O]
        Ju = (Pc[:, :, 0, :3] - u[..., None] * Pc[:, :, 2, :3]) / hz[..., None]
        Jv = (Pc[:, :, 1, :3] - v[..., None] * Pc[:, :, 2, :3]) / hz[..., None]
        J = torch.cat([Ju, Jv], 1) * torch.cat([m, m], 1)[..., None]
        Jt = J.transpose(1, 2)
        step = _solve3(_mm(Jt, J, tf32), _mm(Jt, r[..., None], tf32)[..., 0],
                       tf32)
        X = X - step
        move = step.abs().max() if len(step) else move
    return X.double().cpu().numpy(), float(move)


def reprojection(P, cam, xy, mask, X):
    """(projections [N,O,2], MSE [N] = sum r^2 / 2n) in f64 on the host."""
    Pc = P[cam]
    h = np.einsum("noij,nj->noi", Pc[..., :3], X) + Pc[..., 3]
    uv = h[..., :2] / h[..., 2:3]
    r2 = ((uv - xy) ** 2).sum(-1) * mask
    return uv, r2.sum(1) / (2 * np.maximum(mask.sum(1), 1))


def quality_metrics(pts: np.ndarray, curves) -> dict:
    """Accuracy and completeness of edge-points against the ground-truth
    curves (the repository's quality metrics): the median distance of an
    edge-point to the nearest curve sample, and the share of curve
    samples with an edge-point within twice the median sample spacing."""
    gt = np.concatenate(curves)
    if len(pts) == 0:
        # no edge-point: no distance, and a held `med_dist3d` fails
        return dict(edge_points=0, med_dist3d=None, coverage=0.0)
    d_pt = np.full(len(pts), np.inf)
    d_gt = np.full(len(gt), np.inf)
    g2 = (gt * gt).sum(1)
    for lo in range(0, len(pts), 2048):
        p = pts[lo:lo + 2048]
        d2 = (p * p).sum(1)[:, None] + g2[None] - 2.0 * p @ gt.T
        d = np.sqrt(np.maximum(d2, 0.0))
        d_pt[lo:lo + 2048] = d.min(axis=1)
        d_gt = np.minimum(d_gt, d.min(axis=0))
    spacing = np.median(np.linalg.norm(np.diff(gt[:200], axis=0), axis=1))
    return dict(edge_points=int(len(pts)), med_dist3d=float(np.median(d_pt)),
                coverage=float((d_gt < 2 * spacing).mean()))


def unclaimed(obs_cam, obs_xy, width: int, height: int, cell: int) -> int:
    """Edge-points none of whose observations lands in a density cell that
    no earlier edge-point occupies.  A cell is floor(x / cell) in the
    coordinates' own precision (float32 where every coordinate is one)."""
    if not obs_cam:
        return 0
    cam, xy, mask = pad_observations(obs_cam, obs_xy)
    if np.array_equal(xy.astype(np.float32).astype(np.float64), xy):
        xy = xy.astype(np.float32)
    GW = int(np.ceil(width / cell)) + 1
    GH = int(np.ceil(height / cell)) + 1
    cx = np.clip((xy[..., 0] / cell).astype(np.int64), 0, GW - 1)
    cy = np.clip((xy[..., 1] / cell).astype(np.int64), 0, GH - 1)
    flat = cam * (GH * GW) + cy * GW + cx
    n = len(cam)
    first = np.full(int(flat.max()) + 1, n, np.int64)
    owner = np.broadcast_to(np.arange(n)[:, None], flat.shape)
    np.minimum.at(first, flat[mask], owner[mask])
    own = (first[flat] == owner) & mask
    return int((~own.any(1)).sum())


def judge_numbers(scene, out: Output, gate: dict, points=None,
                  device="cpu") -> dict:
    """The compared numbers of one output.  `points` replaces the
    program's coordinates (the control puts the reference's there)."""
    X = out.points if points is None else points
    P = scene.P
    cam, xy, mask = pad_observations(out.obs_cam, out.obs_xy)
    n = len(cam)
    gap = mse = 0.0
    move = 0.0
    for lo in range(0, n, BLOCK):
        sl = slice(lo, lo + BLOCK)
        X_ref, mv = triangulate(P, cam[sl], xy[sl], mask[sl])
        move = max(move, mv)
        uv, m2 = reprojection(P, cam[sl], xy[sl], mask[sl], X[sl])
        uv_ref, _ = reprojection(P, cam[sl], xy[sl], mask[sl], X_ref)
        d = np.linalg.norm(uv - uv_ref, axis=-1) * mask[sl]
        gap = max(gap, float(d.max()))
        mse = max(mse, float(m2.max()))
    e0 = first_edge_point(scene, out)
    e_cam, e_xy = out.obs_cam[e0:], out.obs_xy[e0:]
    q = quality_metrics(X[e0:], scene.curves)
    return dict(
        gap_px=gap, mse_px2=mse,
        min_views=min([len(c) for c in e_cam] + [10 ** 6]),
        unclaimed=unclaimed(e_cam, e_xy, int(scene.widths.max()),
                            int(scene.heights.max()),
                            gate["density_cell_size_px"]),
        edge_points=q["edge_points"], coverage=q["coverage"],
        med_dist3d=q["med_dist3d"], ref_last_move=move)


#: the control's arithmetic for each precision a configuration states:
#: the next precision below it (float32 runs with TF32 off)
CONTROL = {"float64": dict(dtype=torch.float32, tf32=False),
           "float32": dict(dtype=torch.float32, tf32=True)}


def control_points(scene, out: Output, device: str,
                   precision: str = "float32") -> np.ndarray:
    """The control: the reference's own points for `out`'s observations,
    computed in the precision below the configuration's on `device`.  For
    float32 that is TF32: cuBLAS keeps these small batched products off
    the tensor cores even with TF32 allowed, so the operands are rounded
    here."""
    cam, xy, mask = pad_observations(out.obs_cam, out.obs_xy)
    X = [triangulate(scene.P, cam[lo:lo + BLOCK], xy[lo:lo + BLOCK],
                     mask[lo:lo + BLOCK], device=device,
                     **CONTROL[precision])[0]
         for lo in range(0, len(cam), BLOCK)]
    return np.concatenate(X) if X else np.zeros((0, 3))


#: how each number is held against its limit
SENSE = dict(gap_px="max", mse_px2="max", min_views="min", unclaimed="max",
             edge_points="min", coverage="min", med_dist3d="max")


def worse(name: str, v, w) -> bool:
    """Whether reading v is worse than reading w (no reading, None, is
    the worst)."""
    if v is None or w is None:
        return w is not None
    return v > w if SENSE[name] == "max" else v < w


def verdict(numbers: dict, limits: dict) -> list:
    """[(name, value, limit, ok)] for every number that has a limit: a
    "max" number passes at or under its limit, a "min" number at or
    above it; a number that has no reading (None) fails."""
    rows = []
    for name, limit in limits.items():
        v = numbers[name]
        ok = v is not None and (v <= limit if SENSE[name] == "max"
                                else v >= limit)
        rows.append((name, v, limit, bool(ok)))
    return rows
