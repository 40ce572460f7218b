"""Per-layer metric ``alpha_machine_ms_per_frame``: device ms a frame of the
two-level alpha rounds ``vkrt_alpha_machine`` (``ops/tlas.py``)."""

NAME = "alpha_machine_ms_per_frame"
UNIT = "ms/frame"
LAYER = "two-level traversal"
SOURCE = "device_trace"
MOVES = "msamples_per_s"
KERNELS = ("alpha_machine_kernel",)


def read(trace):
    return trace.kernel_ms_per_frame(KERNELS)
