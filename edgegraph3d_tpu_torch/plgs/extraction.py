"""Edge image -> 2D polyline graph extraction.

One path, three steps (parity: convertEdgeImagePolyLineGraph_optimized;
reference: src/edgegraph3d/io/input/
convert_edge_images_pixel_to_segment.cpp:868-892):

  chains   the C++ pass (native/extraction.cpp): corner-pixel cleanup,
           pixel adjacency, chain tracing and the graph optimization
           (degenerate loops, degree-2 merges, Douglas-Peucker at 1 px,
           close-extreme connection, long-loop splits), in the order of
           PolyLineGraph2DHMapImpl::optimize
           (polyline_graph_2d_hmap_impl.cpp:255-266)
  packing  the chains into the fixed-shape numpy PLG2D
           (`polyline_graph.from_polyline_list`)
  filter   the smooth-length component filter
           (`PLG2D.filter_components_by_smooth_length`)

A failure to build, load or run the C++ library raises RuntimeError.
This differs on purpose from the JAX package, which falls back to its
numpy formulation of the same stages (edgegraph3d_tpu/plgs/extraction.py)
in silence: that formulation's polylines differ (PARITY_EXTRACTION.md),
so a failed build under concurrent first use would change the output
without a word.  The tests hold this module against the JAX package's
`extract_plgs`.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from edgegraph3d_tpu_torch import native
from edgegraph3d_tpu_torch.config import DEFAULT_CONFIG, EdgeGraphConfig
from edgegraph3d_tpu_torch.plgs.polyline_graph import (PLG2D, PLGStack,
                                                 from_polyline_list,
                                                 stack_plgs)


def extract_chains_native(mask: np.ndarray,
                          config: EdgeGraphConfig) -> list[np.ndarray]:
    """Optimized chains of one view from the C++ pass
    (native/extraction.cpp).  Raises RuntimeError when the library
    cannot be built or loaded, or when the call fails."""
    lib = native.get_extraction_lib()
    m = np.ascontiguousarray(mask.astype(np.uint8))
    H, W = m.shape
    max_coords = int(m.sum()) * 2 + 16
    max_chains = max_coords // 2 + 4
    coords = np.empty((max_coords, 2), dtype=np.float32)
    offsets = np.empty(max_chains + 1, dtype=np.int64)
    n_chains = ctypes.c_int64(0)
    n_coords = ctypes.c_int64(0)
    rc = lib.eg3d_extract_chains(
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), H, W,
        ctypes.c_float(config.simplify_tolerance_px),
        ctypes.c_float(config.connect_extremes_max_dist_px),
        config.degenerate_loop_min_coords, config.split_loop_min_len,
        config.loop_check_dist,
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_coords,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        max_chains, ctypes.byref(n_chains), ctypes.byref(n_coords))
    if rc != 0:
        raise RuntimeError(f"native extraction failed: eg3d_extract_chains "
                           f"returned {rc}")
    nc = n_chains.value
    return [coords[offsets[i]:offsets[i + 1]].copy() for i in range(nc)]


def extract_plg(edge_image: np.ndarray,
                config: EdgeGraphConfig = DEFAULT_CONFIG) -> PLG2D:
    """Edge image (uint8 {0,255} or bool, [H,W]) -> optimized PLG2D
    (parity: convertEdgeImagePolyLineGraph_optimized,
    convert_edge_images_pixel_to_segment.cpp:868-892).  Raises
    RuntimeError when the C++ pass cannot be built or run."""
    mask = edge_image > 0 if edge_image.dtype != bool else edge_image
    plg = from_polyline_list(extract_chains_native(mask, config),
                             max_polylines=config.max_polylines_per_view,
                             max_len=config.max_polyline_len)
    return plg.filter_components_by_smooth_length(
        config.top_smooth_length_keep, config.smooth_cos_min)


def extract_plgs(edge_images: np.ndarray,
                 config: EdgeGraphConfig = DEFAULT_CONFIG) -> PLGStack:
    """[V,H,W] edge images -> stacked PLGs (parity:
    convert_edge_images_to_optimized_polyline_graphs,
    convert_edge_images_pixel_to_segment.cpp:885-892).

    Views are extracted in parallel host threads (the C++ call releases
    the GIL) — the equivalent of the reference's OpenMP loop over
    images."""
    from concurrent.futures import ThreadPoolExecutor
    V = edge_images.shape[0]
    with ThreadPoolExecutor(max_workers=min(V, os.cpu_count() or 1)) as ex:
        plgs = list(ex.map(lambda v: extract_plg(edge_images[v], config),
                           range(V)))
    return stack_plgs(plgs, config.max_polylines_per_view,
                      config.max_polyline_len)
