"""Per-layer metric ``rays_per_frame.host_bound``: ``rays_per_frame`` (read as
``rays_per_frame.py`` reads it) in the cells whose rate is
``msamples_per_s.host_bound``."""

NAME = "rays_per_frame.host_bound"
UNIT = "Mrays/frame"
LAYER = "integrator"
SOURCE = "program_counter"
MOVES = "msamples_per_s.host_bound"
KERNELS = ()


def read(trace):
    return trace.per_frame(trace.rays) * 1e-6
