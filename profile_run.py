"""Device-time profile of the port's default-stage pipeline on one GPU.

    python3 profile_run.py [--scene full|cube8|both] [--top 12]

For each scene of chip_smoke.py (the benchmark's config, the default
stages (1, 2, 3)) it runs `run_pipeline` once to warm up, then once under
`torch.profiler`, and prints: the traced wall, the device busy time (the
sum of the CUDA-side kernel, memcpy and memset times; CPU-side entries
are left out, so nothing is counted twice), the idle share
1 - busy / wall, the stage timings of the traced run, and the largest
device items.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import chip_smoke


def _device_us(evt) -> float:
    """Self device time of one key_averages() entry, in microseconds."""
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else evt.self_cuda_time_total)


def profile_scene(name, scene, max_starting_views, top: int):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from edgegraph3d_tpu_torch.pipeline import PipelineStats, run_pipeline

    sfmd, edges, _ = scene
    cfg = chip_smoke.bench_config()

    def run(stats):
        run_pipeline(sfmd, edges, cfg, max_starting_views=max_starting_views,
                     stats=stats, device="cuda")
        torch.cuda.synchronize()

    run(PipelineStats())
    stats = PipelineStats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run(stats)
        wall = time.time() - t0
    items = [e for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(_device_us(e) for e in items) / 1e6
    print(f"PROFILE {name}: traced wall {wall:.4f} s, device busy "
          f"{busy:.4f} s, idle share {1 - busy / wall:.4f}", flush=True)
    print(json.dumps(stats.to_dict()["timings"]))
    for e in sorted(items, key=_device_us, reverse=True)[:top]:
        print(f"  {_device_us(e) / 1e3:10.3f} ms {e.count:7d}  "
              f"{e.key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", choices=("full", "cube8", "both"),
                    default="both")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA GPU: the profile runs only on the card")
    chip_smoke.log(chip_smoke.card_name())
    from edgegraph3d_tpu_torch import kernels
    kernels.build(verbose=False)
    if args.scene in ("full", "both"):
        profile_scene("full", chip_smoke.full_scene(), None, args.top)
    if args.scene in ("cube8", "both"):
        profile_scene("cube8", chip_smoke.cube8_scene(), 2, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
