"""Per-layer metric ``shade_ms_per_frame``: device ms a frame of the fused
shading stage ``vkrt_shade_stage`` (``integrator/shade_fused.py``,
``csrc/shade.cu``)."""

NAME = "shade_ms_per_frame"
UNIT = "ms/frame"
LAYER = "shading"
SOURCE = "device_trace"
MOVES = "msamples_per_s"
KERNELS = ("shade_stage_kernel",)


def read(trace):
    return trace.kernel_ms_per_frame(KERNELS)
