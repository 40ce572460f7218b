"""Per-layer metric ``pool_ms_per_frame``: device ms a frame of the pooled
loop's ``vkrt_regenerate`` and ``vkrt_retire`` (``integrator/pool.py``,
``csrc/wavefront.cu``)."""

NAME = "pool_ms_per_frame"
UNIT = "ms/frame"
LAYER = "regeneration and retirement"
SOURCE = "device_trace"
MOVES = "msamples_per_s"
KERNELS = ("regenerate_kernel", "retire_kernel")


def read(trace):
    return trace.kernel_ms_per_frame(KERNELS)
