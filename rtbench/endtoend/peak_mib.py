"""End-to-end metric ``peak_mib``: ``torch.cuda.max_memory_allocated()`` over
set-up and window, in MiB."""

NAME = "peak_mib"
UNIT = "MiB"


def read(run):
    return run.peak_bytes / 2**20
