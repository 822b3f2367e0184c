"""Seconds per scene of the PipelineStats root span run_pipeline that
none of its direct children covers: the glue no span names."""

UNIT = "s"
LAYER = "pipeline"
MOVES = "setup_s"
SOURCE = "program_span"

ROOT = "run_pipeline"
#: every span that run_pipeline opens directly (a new one belongs here)
CHILDREN = ("plg_extraction", "context(F+grids)",
            "stage1_similarity_graph", "stage1_sweep",
            "stage2_closeness_graph", "stage2_sweep", "stage3_refpoints",
            "expand_all_views", "chain_extension", "density_filter",
            "append_edge_points", "write_checkpoints", "joint_ba",
            "outlier_filter", "debug_images")


def read(run):
    vals = [s["timings"][ROOT] - sum(s["timings"].get(n, 0.0)
                                     for n in CHILDREN)
            for s in run["scenes"] if ROOT in s["timings"]]
    return sum(vals) / len(vals) if vals else None
