"""Per-layer metric ``shade_ms_per_frame.host_bound``: ``shade_ms_per_frame`` (read as
``shade_ms_per_frame.py`` reads it) in the cells whose rate is
``msamples_per_s.host_bound``."""

NAME = "shade_ms_per_frame.host_bound"
UNIT = "ms/frame"
LAYER = "shading"
SOURCE = "device_trace"
MOVES = "msamples_per_s.host_bound"
KERNELS = ("shade_stage_kernel",)


def read(trace):
    return trace.kernel_ms_per_frame(KERNELS)
