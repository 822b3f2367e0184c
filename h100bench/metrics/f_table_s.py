"""Seconds per scene of the PipelineStats span f_table: the F table of
refpoints.build_context (exact from the cameras, or fitted from the
refpoints), until it is on the host.  The span lies inside
context(F+grids)."""

from h100bench import readers

UNIT = "s"
LAYER = "context"
MOVES = "setup_s"
SOURCE = "program_span"


def read(run):
    return readers.span_mean(run, "f_table")
