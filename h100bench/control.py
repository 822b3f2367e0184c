"""Readings that the limits of `correct` are set from, for one cell.

    python3 h100bench/control.py --workload <name> --seeds 1 2 3 ...

For each seed it builds the cell's scene, runs it once through the
window's own call (run.Runner) and prints, as one JSON line, the
compared numbers of: the program's output; the control, the reference
put in the program's place in the next precision below the
configuration's (float32 with TF32 matmuls for float32: the points of
the program's output triangulated anew so); and each fault of faults.py
planted in the output.  Needs the card, like run.py.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from h100bench import faults, reference, run, scenes  # noqa: E402


def readings(cell, seeds, device="cuda", fault_seeds=3):
    """One JSON line per seed; the faults are read on the first
    `fault_seeds` seeds."""
    runner = run.Runner(cell, device)
    conf = cell["config"]
    g = conf["guarantees"]
    warmed = False
    for k, seed in enumerate(seeds):
        scene = scenes.make(conf["scene"], seed)
        if not warmed:
            runner(scene)
            warmed = True
        t0 = time.perf_counter()
        out, _ = runner(scene)
        wall = time.perf_counter() - t0
        o = reference.output_of(out)
        rec = dict(seed=seed, wall_s=wall,
                   program=reference.judge_numbers(scene, o, g))
        t0 = time.perf_counter()
        X = reference.control_points(
            scene, o, device, runner.egc.dtype)
        rec["control"] = reference.judge_numbers(scene, o, g, points=X)
        rec["control_s"] = time.perf_counter() - t0
        for name, fault in faults.FAULTS.items():
            if k < fault_seeds:
                rec[name] = reference.judge_numbers(
                    scene, reference.output_of(fault(scene, out)), g)
        print(json.dumps(rec), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    cell = run.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    from edgegraph3d_tpu_torch import kernels
    kernels.build(verbose=False)
    readings(cell, args.seeds, "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
