"""Reduce a torch.profiler trace of one scene to what the per-layer
metrics and the `breakdown` read.

Device time is the union of the CUDA-side intervals (kernels, copies,
memsets): launches that overlap on several streams count once.  The
idle gaps are the parts of the traced window that no device interval
covers, each labelled with the innermost CPU-side operation the trace
shows running at the gap's middle, or `host` where none is (Python or
numpy on the host).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

import numpy as np

#: the record_function range the harness puts around each traced scene
MARK = "h100bench.scene"
#: longest gaps kept per scene, and entries kept in a breakdown list
TOP = 10


@dataclass
class SceneTrace:
    window_s: float = 0.0
    busy_s: float = 0.0
    n_device: int = 0
    device_s: Counter = field(default_factory=Counter)   # name -> seconds
    gaps: list = field(default_factory=list)             # [(label, s)]


def union(start: np.ndarray, end: np.ndarray):
    """Merge intervals -> (block starts, block ends), sorted, disjoint."""
    if len(start) == 0:
        return start, end
    order = np.argsort(start, kind="stable")
    s, e = start[order], end[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.r_[first[1:] - 1, len(s) - 1]
    return s[first], reach[last]


def reduce_events(dev, cpu, window) -> SceneTrace:
    """dev, cpu: [(name, start_ns, end_ns)]; window: (start_ns, end_ns)."""
    w0, w1 = window
    out = SceneTrace(window_s=(w1 - w0) / 1e9, n_device=len(dev))
    if dev:
        ds = np.array([d[1] for d in dev], np.int64)
        de = np.array([d[2] for d in dev], np.int64)
        for (name, _, _), dt in zip(dev, (de - ds) / 1e9):
            out.device_s[name] += float(dt)
        bs, be = union(np.clip(ds, w0, w1), np.clip(de, w0, w1))
        out.busy_s = float((be - bs).sum()) / 1e9
        gs = np.r_[w0, be]
        ge = np.r_[bs, w1]
    else:
        gs, ge = np.array([w0]), np.array([w1])
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    top = np.argsort(ge - gs)[::-1][:TOP]
    if len(top):
        cs = np.array([c[1] for c in cpu], np.int64)
        ce = np.array([c[2] for c in cpu], np.int64)
        for i in top:
            mid = (gs[i] + ge[i]) // 2
            hit = np.flatnonzero((cs <= mid) & (ce >= mid))
            label = ("host" if len(hit) == 0 else
                     cpu[hit[np.argmin(ce[hit] - cs[hit])]][0])
            out.gaps.append((label, float(ge[i] - gs[i]) / 1e9))
    return out


def reduce_profile(prof) -> SceneTrace:
    """One scene's trace (the harness's MARK range inside it)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, cpu, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name, s = e.name(), e.start_ns()
        end = s + e.duration_ns()
        on_device = e.device_type() == cuda
        if name == MARK:
            # the harness's range, on the host's timeline and (no device
            # work) on the device's
            if not on_device:
                window = (s, end)
        elif getattr(e, "is_user_annotation", lambda: False)():
            continue
        elif on_device:
            dev.append((name, s, end))
        else:
            cpu.append((name, s, end))
    if window is None:
        raise RuntimeError(f"trace without its {MARK} range")
    return reduce_events(dev, cpu, window)


def breakdown(traces: list) -> dict:
    """The device operations that took most time and the longest idle
    gaps over the scenes' traces, each at most TOP entries."""
    total = Counter()
    for t in traces:
        total.update(t.device_s)
    gaps = sorted((g for t in traces for g in t.gaps), key=lambda g: -g[1])
    return dict(device_ops=[[n[:160], s] for n, s in total.most_common(TOP)],
                idle_gaps=[[n[:160], s] for n, s in gaps[:TOP]])
