"""2D density filter: one edge-point per 3 px cell per view.

The reference's sequential occupancy-bitmap pass (reference:
src/edgegraph3d/filtering/filtering_close_plgps.cpp:75-124): a point is
kept iff >= 1 of its 2D observations lands in a cell not yet occupied by
an earlier kept point; kept points mark all their cells.

`density_filter` runs that definition in one C++ loop on the host
(native/density.cpp): the points live in host numpy and the pass is
sequential by definition, one byte test per observation.  The tests hold
it against the JAX package's filter (edgegraph3d_tpu/filtering/density.py),
both on its sequential loop and on its parallel claim rounds.
"""

from __future__ import annotations

import ctypes

import numpy as np

from edgegraph3d_tpu_torch import native

_ENTRIES = {np.dtype(np.float32): ("eg3d_density_keep_f32", ctypes.c_float),
            np.dtype(np.float64): ("eg3d_density_keep_f64", ctypes.c_double)}


def density_filter(obs_xy: np.ndarray, obs_mask: np.ndarray,
                   width: int, height: int, cell: int = 3) -> np.ndarray:
    """obs_xy [N,V,2] float32 or float64, obs_mask [N,V] -> keep [N] bool.

    Points are processed in index order (parity: the reference's
    insertion order).  A cell is (x / cell) truncated toward zero in
    obs_xy's own precision and clipped to the grid, as numpy computes it
    for a Python-int `cell`; masked slots never count.  Raises
    TypeError for another dtype, ValueError for a malformed shape or
    grid, RuntimeError when the native library cannot be built or
    loaded."""
    obs_xy = np.ascontiguousarray(obs_xy)
    if obs_xy.dtype not in _ENTRIES:
        raise TypeError(f"density_filter takes float32 or float64 "
                        f"coordinates, not {obs_xy.dtype}")
    if obs_xy.ndim != 3 or obs_xy.shape[2] != 2:
        raise ValueError(f"obs_xy must be [N, V, 2], not {obs_xy.shape}")
    N, V, _ = obs_xy.shape
    mask = np.ascontiguousarray(obs_mask, dtype=bool)
    if mask.shape != (N, V):
        raise ValueError(f"obs_mask {mask.shape} does not match obs_xy "
                         f"{obs_xy.shape}")
    width, height, cell = int(width), int(height), int(cell)
    GW, GH = -(-width // max(cell, 1)) + 1, -(-height // max(cell, 1)) + 1
    # the native pass keeps a cell within its view in 32 bits, and the
    # grid's last cell exact in float32
    if cell < 1 or min(width, height) < 0 or max(GW, GH) > 2 ** 24 or \
            GW * GH >= 2 ** 31:
        raise ValueError(f"bad grid: width {width}, height {height}, "
                         f"cell {cell}")
    keep = np.zeros(N, dtype=bool)
    if N == 0:
        return keep
    entry, ctype = _ENTRIES[obs_xy.dtype]
    getattr(native.get_density_lib(), entry)(
        obs_xy.ctypes.data_as(ctypes.POINTER(ctype)),
        mask.view(np.uint8).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        N, V, width, height, cell,
        keep.view(np.uint8).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return keep
