"""Share of the traced scenes' longest idle gaps of the device (the ones
devtrace keeps) whose label is a program span (an `eg3d.` profiler
range), by seconds: 0 where every gap reads a torch operation or
`host`."""

UNIT = "share"
LAYER = "device"
MOVES = "setup_s"
SOURCE = "device_trace"


def read(run):
    gaps = [g for t in run["traces"] for g in t.gaps]
    total = sum(s for _, s in gaps)
    if total <= 0:
        return None
    return sum(s for label, s in gaps if label.startswith("eg3d.")) / total
