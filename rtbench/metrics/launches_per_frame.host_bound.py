"""Per-layer metric ``launches_per_frame.host_bound``: ``launches_per_frame`` (read as
``launches_per_frame.py`` reads it) in the cells whose rate is
``msamples_per_s.host_bound``."""

NAME = "launches_per_frame.host_bound"
UNIT = "launches/frame"
LAYER = "wavefront loop"
SOURCE = "device_trace"
MOVES = "msamples_per_s.host_bound"
KERNELS = ()


def read(trace):
    return trace.per_frame(trace.launches)
