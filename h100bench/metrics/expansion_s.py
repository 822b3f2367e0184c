"""Seconds per scene of the PipelineStats spans expand_all_views and
chain_extension, summed."""

from h100bench import readers

UNIT = "s"
LAYER = "expansion and extension"
MOVES = "setup_s"
SOURCE = "program_span"


def read(run):
    return readers.span_mean(run, "expand_all_views", "chain_extension")
