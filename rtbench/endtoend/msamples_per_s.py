"""End-to-end metric ``msamples_per_s``: the paths the traffic asks of every
frame of the window (width x height x spp a frame, a fixed amount of work
that no count of the program's enters), in millions, over the window's wall
time (host clock to the last frame's synchronize). The cells whose frame the
device sets."""

NAME = "msamples_per_s"
UNIT = "Msamples/s"


def read(run):
    return len(run.frame_s) * run.frame_samples * 1e-6 / run.window_s
