"""Seconds per scene over the traced window: its wall divided by the
scenes completed in it, each ending in `torch.cuda.synchronize()`.  The
wall is the host's clock, so it swings with the host's speed by a tenth
or more from run to run (PERF.md)."""

UNIT = "s"
LAYER = "pipeline"
MOVES = "setup_s"
SOURCE = "host_clock"


def read(run):
    if not run.get("done"):
        return None
    return run["window_s"] / run["done"]
