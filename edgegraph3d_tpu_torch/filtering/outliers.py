"""Outlier filtering: batched Gauss-Newton + observation-count threshold.

Port of edgegraph3d_tpu/filtering/outliers.py.  Every 3D point is
re-optimized over all its observations by kernel K3
(ops.triangulation.triangulate_gn, <= 30 f32 GN iterations, accepted at
MSE < gn_max_mse); accepted points take the optimized coordinates, and
edge-points additionally need more than max(3, median_ray_bucket/2 - 1)
observations.

Every function here defaults to device="cuda" and raises without a GPU
(devices.resolve_device); the CPU runs only when asked for.
"""

from __future__ import annotations

import numpy as np
import torch

from edgegraph3d_tpu_torch.core.sfm import SfMData, pack_observations, \
    remove_outliers
from edgegraph3d_tpu_torch.devices import resolve_device
from edgegraph3d_tpu_torch.ops.triangulation import triangulate_gn

INVALID_FORCED_MIN_FILTER = -1


def gauss_newton_filter(sfmd: SfMData, gn_max_mse: float = 2.25,
                        max_iters: int = 30, chunk: int = 65536,
                        epsilon: float = 5e-7, device="cuda"):
    """Re-optimize all points; returns (new_points [N,3], inliers [N])."""
    device = resolve_device(device)
    N = sfmd.n_points
    if N == 0:
        return sfmd.points.copy(), np.zeros(0, dtype=bool)
    packed = pack_observations(sfmd.obs_cam, sfmd.obs_xy, dtype=np.float32)
    P = torch.as_tensor(sfmd.P.astype(np.float32), device=device)
    new_pts = sfmd.points.copy()
    inliers = np.zeros(N, dtype=bool)
    for lo in range(0, N, chunk):
        hi = min(lo + chunk, N)
        X, _, ok = triangulate_gn(
            P,
            torch.as_tensor(np.clip(packed.cam_idx[lo:hi], 0, None),
                            device=device),
            torch.as_tensor(packed.xy[lo:hi], device=device),
            torch.as_tensor(packed.mask[lo:hi], device=device),
            X0=torch.as_tensor(sfmd.points[lo:hi].astype(np.float32),
                               device=device),
            max_iters=max_iters, epsilon=epsilon, accept_mse=gn_max_mse)
        ok = ok.cpu().numpy()
        inliers[lo:hi] = ok
        sel = np.flatnonzero(ok)
        new_pts[lo + sel] = X.cpu().numpy()[sel]
    return new_pts, inliers


def compute_ray_stats(sfmd: SfMData, inliers: np.ndarray):
    """(average_rays, median_ray_bucket) over inlier points (the
    'median' is the bucket index, i.e. n_rays - 1)."""
    counts = np.asarray([len(sfmd.obs_cam[i]) for i in range(sfmd.n_points)])
    sel = counts[np.asarray(inliers, dtype=bool)]
    if len(sel) == 0:
        return 0.0, 0
    avg = float(sel.mean())
    dist = np.bincount(sel - 1, minlength=sfmd.n_cameras)
    half = len(sel) // 2
    cum = np.cumsum(dist)
    median_bucket = int(np.argmax(cum >= half))
    return avg, median_bucket


def compute_inliers(sfmd: SfMData, first_edgepoint: int,
                    gn_max_mse: float = 2.25,
                    forced_min_filter: int = INVALID_FORCED_MIN_FILTER,
                    min_views_floor: int = 3, epsilon: float = 5e-7,
                    device="cuda"):
    """GN inliers plus the edge-point view-count rule.
    Returns (new_points, inliers)."""
    new_pts, inliers = gauss_newton_filter(sfmd, gn_max_mse,
                                           epsilon=epsilon, device=device)
    _, median_bucket = compute_ray_stats(sfmd, inliers)
    view_filter = max(min_views_floor, median_bucket // 2 - 1)
    if forced_min_filter > INVALID_FORCED_MIN_FILTER:
        view_filter = forced_min_filter
    for i in range(first_edgepoint, sfmd.n_points):
        inliers[i] = inliers[i] and len(sfmd.obs_cam[i]) > view_filter
    return new_pts, inliers


def filter_sfm_data(sfmd: SfMData, first_edgepoint: int,
                    gn_max_mse: float = 2.25,
                    forced_min_filter: int = INVALID_FORCED_MIN_FILTER,
                    min_views_floor: int = 3, epsilon: float = 5e-7,
                    device="cuda") -> SfMData:
    """GN + view-count inliers, points updated to optimized coords,
    scene compacted."""
    new_pts, inliers = compute_inliers(sfmd, first_edgepoint, gn_max_mse,
                                       forced_min_filter, min_views_floor,
                                       epsilon, device)
    out = sfmd.copy()
    out.points = new_pts
    return remove_outliers(out, inliers)
