"""Reconstruction quality against ground-truth synthetic curves.

Copied from the repository benchmark's `quality_metrics` (bench.py), so
the port reports the same fields without importing the benchmark (which
imports the JAX package)."""

from __future__ import annotations

import numpy as np


def quality_metrics(out_sfmd, in_sfmd, curves):
    """3D accuracy + completeness of the reconstructed edge-points
    against the ground-truth synthetic curves: median distance of
    edge-points to the nearest curve sample, and `coverage` = fraction
    of curve samples with an edge-point within 2x the median sample
    spacing (`coverage_4x` is the looser 4x variant)."""
    pts = out_sfmd.points[in_sfmd.n_points:]
    gt = np.concatenate(curves)
    if len(pts) == 0:
        return dict(edge_points=0, med_dist3d=float("inf"),
                    coverage=0.0, coverage_4x=0.0)
    # chunked nearest-neighbour (no scipy dependency)
    d_pt = np.full(len(pts), np.inf)
    d_gt = np.full(len(gt), np.inf)
    for lo in range(0, len(pts), 2048):
        d = np.linalg.norm(pts[lo:lo + 2048, None] - gt[None], axis=-1)
        d_pt[lo:lo + 2048] = d.min(axis=1)
        d_gt = np.minimum(d_gt, d.min(axis=0))
    spacing = np.median(np.linalg.norm(np.diff(gt[:200], axis=0), axis=1))
    return dict(edge_points=int(len(pts)),
                med_dist3d=float(np.median(d_pt)),
                coverage=float((d_gt < 2 * spacing).mean()),
                coverage_4x=float((d_gt < 4 * spacing).mean()))
