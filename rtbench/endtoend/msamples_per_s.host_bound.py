"""End-to-end metric ``msamples_per_s.host_bound``: ``msamples_per_s`` in the
cells whose frame the host sets (the device idle for much of it), whose
rate drifts with the host's speed and so holds a bound of its own."""

NAME = "msamples_per_s.host_bound"
UNIT = "Msamples/s"


def read(run):
    return len(run.frame_s) * run.frame_samples * 1e-6 / run.window_s
