"""Per-layer metric ``rays_per_frame``: the program's own ray count
(``Renderer.last_rays``: closest-hit and shadow rays) over the traced
frames, in millions a frame."""

NAME = "rays_per_frame"
UNIT = "Mrays/frame"
LAYER = "integrator"
SOURCE = "program_counter"
MOVES = "msamples_per_s"
KERNELS = ()


def read(trace):
    return trace.per_frame(trace.rays) * 1e-6
