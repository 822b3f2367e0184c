"""Faults planted under the timed path, to show that the comparison with
the reference catches them (tests/test_h100bench_faults.py, and their
readings at full size in control.py).  Each takes the scene `run_pipeline`
was given and the SfMData it returned, and gives a broken SfMData."""

from __future__ import annotations

import numpy as np

from h100bench.reference import first_edge_point, output_of


def _first_edge_point(scene, out) -> int:
    return first_edge_point(scene, output_of(out))


def _rows(out, keep):
    b = out.copy()
    b.points = out.points[keep]
    b.obs_cam = [out.obs_cam[i] for i in keep]
    b.obs_xy = [out.obs_xy[i] for i in keep]
    return b


def unchanged(scene, out):
    """The pipeline hands back its input: no edge-point is added."""
    return _rows(out, np.arange(_first_edge_point(scene, out)))


def half(scene, out):
    """Half of the edge-points left out (every other one)."""
    e0 = _first_edge_point(scene, out)
    return _rows(out, np.r_[np.arange(e0), np.arange(e0, out.n_points, 2)])


def altered(scene, out):
    """One answer altered where it is produced: the middle edge-point
    moved by 0.01 scene units (about 5 px in a 1600-px view)."""
    e0 = _first_edge_point(scene, out)
    b = out.copy()
    if b.n_points > e0:
        b.points[(e0 + b.n_points) // 2] += 0.01
    return b


FAULTS = dict(unchanged=unchanged, half=half, altered=altered)
