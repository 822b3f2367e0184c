"""Standalone filter command line, the port's counterpart of
edgegraph3d_tpu/cli/filter.py (same arguments, plus --device).

Usage:
    python -m edgegraph3d_tpu_torch.cli.filter -s <first_edgepoint> \
        [-e <gn_max_mse>] [-f <min_views>] <input.json> <output.json> \
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="filter", description="re-run outlier filtering on a JSON")
    ap.add_argument("-s", dest="first_edgepoint", type=int, required=True,
                    help="id of the first edge-point (earlier ids kept)")
    ap.add_argument("-e", dest="gn_max_mse", type=float, default=2.25,
                    help="Gauss-Newton max reprojection MSE (px^2)")
    ap.add_argument("-f", dest="min_views", type=int, default=-1,
                    help="forced minimum observations per edge-point")
    ap.add_argument("input_json")
    ap.add_argument("output_json")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; raises without a "
                    "GPU) or cpu")
    args = ap.parse_args(argv)

    from edgegraph3d_tpu_torch.core import sfm as sfm_io
    from edgegraph3d_tpu_torch.filtering.outliers import filter_sfm_data
    from edgegraph3d_tpu_torch.pipeline import resolve_device

    dev = resolve_device(args.device)
    sfmd = sfm_io.read_sfm_data(args.input_json)
    n0 = sfmd.n_points
    out = filter_sfm_data(sfmd, args.first_edgepoint,
                          gn_max_mse=args.gn_max_mse,
                          forced_min_filter=args.min_views, device=dev)
    sfm_io.write_sfm_data(out, args.output_json)
    print(f"Filtering... Removed {n0 - out.n_points} points.")
    print(f"Final amount of computed 3D points: {out.n_points}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
