"""What the per-layer metric readers (h100bench/metrics/*.py) share.

A reader's `read(run)` gets the run's record: `scenes`, each scene's
`PipelineStats.to_dict()`; `traces`, the devtrace.SceneTrace of each
traced scene whose trace holds a CUDA-side entry; `root`, the checkout;
`window_s`, the window's wall, and `done`, the scenes completed in it.
It returns a number, or None where it finds nothing to read.
"""

from __future__ import annotations

import glob
import os
import re


def span_mean(run: dict, *names: str):
    """Mean seconds per scene of the sum of the spans `names`, over the
    scenes that logged any of them."""
    vals = [sum(s["timings"].get(n, 0.0) for n in names)
            for s in run["scenes"]
            if any(n in s["timings"] for n in names)]
    return sum(vals) / len(vals) if vals else None


def device_ms_per_scene(run: dict, match) -> float | None:
    """Mean device ms per traced scene of the CUDA-side entries whose
    name `match` accepts (summed: overlapping launches count each)."""
    traces = run["traces"]
    if not traces:
        return None
    total = sum(s for t in traces for n, s in t.device_s.items() if match(n))
    return 1e3 * total / len(traces)


def hand_kernel_names(root: str) -> list:
    """The __global__ functions of the program's CUDA sources (K1-K8)."""
    names = []
    for path in sorted(glob.glob(os.path.join(
            root, "edgegraph3d_tpu_torch", "csrc", "*.cu*"))):
        with open(path) as f:
            names += re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                r"(\w+)\s*\(", f.read())
    return sorted(set(names))
