"""Share of the traced scenes' wall in which no kernel, copy or memset
ran on the device: 1 - (union of the CUDA-side intervals) / window."""

from h100bench import readers

UNIT = "share"
LAYER = "device"
MOVES = "setup_s"
SOURCE = "device_trace"


def read(run):
    traces = run["traces"]
    window = sum(t.window_s for t in traces)
    if window <= 0:
        return None
    return 1.0 - sum(t.busy_s for t in traces) / window
