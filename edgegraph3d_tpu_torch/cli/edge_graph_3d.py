"""EdgeGraph3D command line, the port's counterpart of
edgegraph3d_tpu/cli/edge_graph_3d.py (same arguments, plus --device).

Usage:
    python -m edgegraph3d_tpu_torch.cli.edge_graph_3d [-i] \
        <images_folder> <edges_folder> <working_folder> \
        <input_sfm_data.json> <output.json> [--device cuda|cpu]

Runs the default stages (1, 2, 3); `--ba-steps N` adds N joint
bundle-adjustment steps before the final filter (kernel K8 on the card).
`-i` (debug images) is not ported yet and raises NotImplementedError, as
run_pipeline does.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="EdgeGraph3D",
        description="multi-view 3D edge reconstruction (PyTorch / CUDA)")
    ap.add_argument("-i", dest="debug_images", action="store_true",
                    help="output debug images (not ported yet)")
    ap.add_argument("images_folder")
    ap.add_argument("edges_folder")
    ap.add_argument("working_folder")
    ap.add_argument("sfm_data_file")
    ap.add_argument("output_json")
    ap.add_argument("--max-starting-views", type=int, default=None,
                    help="limit starting cams per refpoint (speed knob)")
    ap.add_argument("--simplify-3d", action="store_true",
                    help="simplify the saved 3D graph (tol 0.01)")
    ap.add_argument("--fragment-3d", type=float, default=None,
                    metavar="MAXLEN",
                    help="fragment the saved 3D graph at this arc-length")
    ap.add_argument("--ba-steps", type=int, default=0, metavar="N",
                    help="joint bundle-adjustment steps before the final "
                    "filter")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; raises without a "
                    "GPU) or cpu")
    args = ap.parse_args(argv)

    from edgegraph3d_tpu_torch.config import DEFAULT_CONFIG
    from edgegraph3d_tpu_torch.pipeline import edge_matching
    cfg = DEFAULT_CONFIG.replace(
        output_3d_simplify=args.simplify_3d,
        output_3d_fragment_maxlen=args.fragment_3d,
        ba_steps=args.ba_steps)
    out = edge_matching(args.images_folder, args.edges_folder,
                        args.working_folder, args.sfm_data_file,
                        args.output_json, config=cfg,
                        max_starting_views=args.max_starting_views,
                        debug_images=args.debug_images, device=args.device)
    print(f"Wrote {out.n_points} points to {args.output_json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
