"""End-to-end metric ``frame_ms_p95``: the 95th percentile of the window's
frame times, each host clock around ``Renderer.step()`` and
``torch.cuda.synchronize()`` (numpy's linear interpolation, over all frames
of the window)."""

NAME = "frame_ms_p95"
UNIT = "ms"


def read(run):
    import numpy as np

    return float(np.percentile(np.asarray(run.frame_s) * 1e3, 95))
