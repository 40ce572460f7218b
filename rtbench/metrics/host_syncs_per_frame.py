"""Per-layer metric ``host_syncs_per_frame``: the CUDA runtime's stream, device
and event synchronize calls in the trace a frame (the wavefront's one read
of its loop control an iteration and the host's other waits)."""

NAME = "host_syncs_per_frame"
UNIT = "syncs/frame"
LAYER = "wavefront loop"
SOURCE = "device_trace"
MOVES = "msamples_per_s"
KERNELS = ()


def read(trace):
    return trace.per_frame(trace.host_syncs)
