"""Per-layer metric ``ab_ms_per_frame``: device ms a frame of the single-level
closest and any-hit entry ``vkrt_traverse_ab`` (``csrc/traverse.cu``'s
persistent warps, modes a/b from the root; ``ops/traverse_fused.py``,
``ops/traverse_wide.closest_hit_bundle`` / ``any_hit_bundle``)."""

NAME = "ab_ms_per_frame"
UNIT = "ms/frame"
LAYER = "single-level traversal"
SOURCE = "device_trace"
MOVES = "msamples_per_s.host_bound"
KERNELS = ("persistent_traverse_kernel",)


def read(trace):
    return trace.kernel_ms_per_frame(KERNELS)
