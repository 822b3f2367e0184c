"""Seconds per scene of the PipelineStats span outlier_filter (GN and
view-count filter)."""

from h100bench import readers

UNIT = "s"
LAYER = "filtering"
MOVES = "setup_s"
SOURCE = "program_span"


def read(run):
    return readers.span_mean(run, "outlier_filter")
