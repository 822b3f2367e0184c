"""Seconds per scene of the PipelineStats span stage3_refpoints (seeding
from refpoints, following, claiming)."""

from h100bench import readers

UNIT = "s"
LAYER = "stage 3"
MOVES = "setup_s"
SOURCE = "program_span"


def read(run):
    return readers.span_mean(run, "stage3_refpoints")
