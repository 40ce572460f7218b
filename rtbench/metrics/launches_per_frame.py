"""Per-layer metric ``launches_per_frame``: device kernels, copies and sets in
the trace a frame (the launches that ``integrator/wavefront.py``'s loop
drives)."""

NAME = "launches_per_frame"
UNIT = "launches/frame"
LAYER = "wavefront loop"
SOURCE = "device_trace"
MOVES = "msamples_per_s"
KERNELS = ()


def read(trace):
    return trace.per_frame(trace.launches)
