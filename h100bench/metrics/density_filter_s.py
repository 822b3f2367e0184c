"""Seconds per scene of the PipelineStats span density_filter (host)."""

from h100bench import readers

UNIT = "s"
LAYER = "filtering"
MOVES = "setup_s"
SOURCE = "program_span"


def read(run):
    return readers.span_mean(run, "density_filter")
