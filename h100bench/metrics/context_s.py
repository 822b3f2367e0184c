"""Seconds per scene of the PipelineStats span context(F+grids)
(refpoints.build_context: the F table and the per-view grids)."""

from h100bench import readers

UNIT = "s"
LAYER = "context"
MOVES = "setup_s"
SOURCE = "program_span"


def read(run):
    return readers.span_mean(run, "context(F+grids)")
