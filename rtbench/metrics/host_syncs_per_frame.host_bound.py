"""Per-layer metric ``host_syncs_per_frame.host_bound``: ``host_syncs_per_frame`` (read as
``host_syncs_per_frame.py`` reads it) in the cells whose rate is
``msamples_per_s.host_bound``."""

NAME = "host_syncs_per_frame.host_bound"
UNIT = "syncs/frame"
LAYER = "wavefront loop"
SOURCE = "device_trace"
MOVES = "msamples_per_s.host_bound"
KERNELS = ()


def read(trace):
    return trace.per_frame(trace.host_syncs)
