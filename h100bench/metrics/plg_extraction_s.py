"""Seconds per scene of the PipelineStats span plg_extraction (edge images
to polyline graphs, host C++)."""

from h100bench import readers

UNIT = "s"
LAYER = "PLG extraction"
MOVES = "setup_s"
SOURCE = "program_span"


def read(run):
    return readers.span_mean(run, "plg_extraction")
