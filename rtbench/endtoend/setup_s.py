"""End-to-end metric ``setup_s``: process start to the first timed frame
(imports, CUDA initialisation, library loads, the scene and its acceleration
structure, the ``Renderer`` build, the warm-up frames), host clock."""

NAME = "setup_s"
UNIT = "s"


def read(run):
    return run.setup_s
