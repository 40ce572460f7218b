"""Per-layer metric ``pool_ms_per_frame.host_bound``: ``pool_ms_per_frame`` (read as
``pool_ms_per_frame.py`` reads it) in the cells whose rate is
``msamples_per_s.host_bound``."""

NAME = "pool_ms_per_frame.host_bound"
UNIT = "ms/frame"
LAYER = "regeneration and retirement"
SOURCE = "device_trace"
MOVES = "msamples_per_s.host_bound"
KERNELS = ("regenerate_kernel", "retire_kernel")


def read(trace):
    return trace.kernel_ms_per_frame(KERNELS)
