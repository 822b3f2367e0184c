"""Device-time profile of the port's default-stage pipeline on one GPU.

    python3 profile_run.py [--scene full|cube8|both] [--top 12]
                           [--expansion kernel|plain|both]

For each scene of chip_smoke.py (the benchmark's config, the default
stages (1, 2, 3)) it runs `run_pipeline` once to warm up, then, for each
expansion path, once untraced and once under `torch.profiler` (inside
the benchmark's `h100bench.devtrace.MARK` range), and prints: the
untraced and traced walls, the device busy time and idle share as the
benchmark reduces the trace (h100bench/devtrace.py: the union of the
CUDA-side kernel, memcpy and memset intervals, so launches that overlap
count once), the longest idle gaps, each labelled with the innermost
CPU-side operation open across it (the program's `eg3d.<span>` ranges
name the stage), the stage timings of the traced run, and the largest
device items.
`--expansion plain` swaps kernel K7 for its plain version (the per-view
loop around K1 and K3, the path before K7) to measure both in one call;
`both` runs kernel, plain, plain, kernel.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import chip_smoke


def _device_us(evt) -> float:
    """Self device time of one key_averages() entry, in microseconds."""
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else evt.self_cuda_time_total)


@contextlib.contextmanager
def expansion_path(which: str):
    """Run the expansion through kernel K7 ("kernel") or through its
    plain version ("plain")."""
    from edgegraph3d_tpu_torch.matching import expansion
    saved = expansion.expand_chains_compact
    if which == "plain":
        expansion.expand_chains_compact = \
            expansion._expand_chains_compact_plain
    try:
        yield
    finally:
        expansion.expand_chains_compact = saved


def profile_scene(name, scene, max_starting_views, top: int, paths):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from edgegraph3d_tpu_torch.pipeline import PipelineStats, run_pipeline
    from h100bench import devtrace

    sfmd, edges, _ = scene
    cfg = chip_smoke.bench_config()

    def run(stats):
        t0 = time.time()
        out = run_pipeline(sfmd, edges, cfg,
                           max_starting_views=max_starting_views,
                           stats=stats, device="cuda")
        torch.cuda.synchronize()
        return time.time() - t0, out

    run(PipelineStats())
    for which in paths:
        with expansion_path(which):
            untraced, out = run(PipelineStats())
            stats = PipelineStats()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with record_function(devtrace.MARK):
                    wall, _ = run(stats)
        trace = devtrace.reduce_profile(prof)
        print(f"PROFILE {name} expansion={which}: untraced wall "
              f"{untraced:.4f} s, traced wall {wall:.4f} s, device busy "
              f"{trace.busy_s:.4f} s, idle share "
              f"{1 - trace.busy_s / trace.window_s:.4f}, points "
              f"{out.n_points - sfmd.n_points}, spans {len(stats.spans)}",
              flush=True)
        print("idle gaps: " + ", ".join(f"{label} {s:.4f} s"
                                        for label, s in trace.gaps))
        print(json.dumps(stats.to_dict()["timings"]))
        items = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        for e in sorted(items, key=_device_us, reverse=True)[:top]:
            print(f"  {_device_us(e) / 1e3:10.3f} ms {e.count:7d}  "
                  f"{e.key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", choices=("full", "cube8", "both"),
                    default="both")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--expansion", choices=("kernel", "plain", "both"),
                    default="kernel")
    args = ap.parse_args()
    paths = (("kernel", "plain", "plain", "kernel")
             if args.expansion == "both" else (args.expansion,))
    import torch
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA GPU: the profile runs only on the card")
    chip_smoke.log(chip_smoke.card_name())
    from edgegraph3d_tpu_torch import kernels
    kernels.build(verbose=False)
    if args.scene in ("full", "both"):
        profile_scene("full", chip_smoke.full_scene(), None, args.top,
                      paths)
    if args.scene in ("cube8", "both"):
        profile_scene("cube8", chip_smoke.cube8_scene(), 2, args.top,
                      paths)
    return 0


if __name__ == "__main__":
    sys.exit(main())
