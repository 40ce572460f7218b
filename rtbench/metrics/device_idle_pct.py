"""Per-layer metric ``device_idle_pct``: the share of the traced stretch's wall
time (host clock over whole frames) in which no kernel, copy or set ran on
the device."""

NAME = "device_idle_pct"
UNIT = "%"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "msamples_per_s"
KERNELS = ()


def read(trace):
    return 100.0 * (trace.window_s - trace.busy_s) / trace.window_s
