"""Small cells for the CPU tests: the cell's files with a reduced scene and
image, run on the CPU through the port's plain versions."""

import dataclasses

from rtbench import bench

SMALL = {
    "atrium": {"generator": "procedural.atrium_scene",
               "args": {"bays_x": 2, "bays_z": 2, "column_segments": 16, "column_rows": 12}},
    "bistro": {"generator": "procedural.bistro_scene", "args": {"detail": 0.05, "seed": 9}},
}


def small_cell(config: str, width: int = 48, height: int = 27, pixels: int = 24):
    """The ``<config>.accumulate-1080p-d4`` cell at a test's size."""
    cell = bench.load_cell(f"{config}.accumulate-1080p-d4")
    return dataclasses.replace(
        cell, config=dict(cell.config, scene=SMALL[config]),
        traffic=dict(cell.traffic, width=width, height=height),
        check=dict(cell.check, pixels=pixels))
