"""Per-layer metric ``device_idle_pct.host_bound``: ``device_idle_pct`` (read as
``device_idle_pct.py`` reads it) in the cells whose rate is
``msamples_per_s.host_bound``."""

NAME = "device_idle_pct.host_bound"
UNIT = "%"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "msamples_per_s.host_bound"
KERNELS = ()


def read(trace):
    return 100.0 * (trace.window_s - trace.busy_s) / trace.window_s
