"""Seconds per scene of the PipelineStats span group_chains: the host's
grouping of swept points into chains for K7, summed over the stage-3
expansion and every extension round."""

from h100bench import readers

UNIT = "s"
LAYER = "expansion and extension"
MOVES = "setup_s"
SOURCE = "program_span"


def read(run):
    return readers.span_mean(run, "group_chains")
