"""Per-layer metric ``alpha_rounds_ms_per_frame``: device ms a frame of the
single-level alpha pass ``vkrt_alpha_rounds`` (``ops/traverse_alpha.py``;
the root prefilter at its ray intake)."""

NAME = "alpha_rounds_ms_per_frame"
UNIT = "ms/frame"
LAYER = "single-level traversal"
SOURCE = "device_trace"
MOVES = "msamples_per_s.host_bound"
KERNELS = ("alpha_rounds_kernel",)


def read(trace):
    return trace.kernel_ms_per_frame(KERNELS)
