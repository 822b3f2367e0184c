"""Device ms per scene of host-to-device and device-to-host copies, from
the profiler trace."""

from h100bench import readers

UNIT = "ms"
LAYER = "device"
MOVES = "setup_s"
SOURCE = "device_trace"


def read(run):
    return readers.device_ms_per_scene(
        run, lambda n: n.startswith(("Memcpy HtoD", "Memcpy DtoH")))
