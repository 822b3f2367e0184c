"""Seconds per scene of the PipelineStats span expansion_copies: the
host's staging and upload of each expansion chunk and the read-backs of
its results (the host's wait on K7 included), summed over the stage-3
expansion and every extension round."""

from h100bench import readers

UNIT = "s"
LAYER = "expansion and extension"
MOVES = "setup_s"
SOURCE = "program_span"


def read(run):
    return readers.span_mean(run, "expansion_copies")
