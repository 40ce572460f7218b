"""Per-layer metric ``opaque_machine_ms_per_frame``: device ms a frame of the
two-level opaque rounds ``vkrt_opaque_machine`` (``ops/tlas.py``)."""

NAME = "opaque_machine_ms_per_frame"
UNIT = "ms/frame"
LAYER = "two-level traversal"
SOURCE = "device_trace"
MOVES = "msamples_per_s"
KERNELS = ("opaque_machine_kernel",)


def read(trace):
    return trace.kernel_ms_per_frame(KERNELS)
