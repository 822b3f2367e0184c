"""Seconds per scene of the PipelineStats span louvain: host Louvain
inside stage1_communities (its phases and the native local-moving
passes), summed over the full graph's call and the LP community graph's."""

from h100bench import readers

UNIT = "s"
LAYER = "stages 1-2"
MOVES = "setup_s"
SOURCE = "program_span"


def read(run):
    return readers.span_mean(run, "louvain")
