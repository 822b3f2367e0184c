"""Device ms per scene of the launches of the hand-written CUDA kernels
(K1-K8, matched by the __global__ names of the program's csrc), summed
over their launches from the profiler trace."""

import re

from h100bench import readers

UNIT = "ms"
LAYER = "kernels"
MOVES = "setup_s"
SOURCE = "device_trace"


def read(run):
    names = readers.hand_kernel_names(run["root"])
    if not names:
        return None
    word = re.compile(r"\b(" + "|".join(names) + r")\b")
    return readers.device_ms_per_scene(run, lambda n: bool(word.search(n)))
