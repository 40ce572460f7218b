"""The plain reference against the port's plain CPU path: every path of a
small frame of each configuration, lane for lane."""

import pytest
import torch

from rtbench import bench, scenes
from rtbench.reference import Reference
from rtbench_cells import small_cell


@pytest.mark.parametrize("config,frame", [("atrium", 0), ("atrium", 9), ("bistro", 3)])
def test_reference_paths_equal_the_port_frame(config, frame):
    cell = small_cell(config, width=40, height=24)
    scene = scenes.generate(cell.config["scene"])
    r = bench.build_renderer(scene, cell, 0, "cpu")
    img = r.render_frame(frame).reshape(-1, 3)
    t = cell.traffic
    ref = Reference(scene, cell.config["render"], t["width"], t["height"], t["max_depth"],
                    t["spp"], "cpu")
    pix = torch.arange(t["width"] * t["height"])
    out, rays = ref.paths(pix, torch.full_like(pix, frame))
    assert int(rays) == r.last_rays
    assert torch.equal(out, img)


def test_reference_in_batches_matches_the_running_mean():
    """The check's reference accumulation over frames equals the program's
    after those frames, bit for bit (its running mean in float32)."""
    cell = small_cell("atrium", width=32, height=18, pixels=16)
    scene = scenes.generate(cell.config["scene"])
    seed = 2**31 + 77
    r = bench.build_renderer(scene, cell, seed, "cpu")
    for _ in range(3):
        r.step()
    first = bench.start_frame(seed)
    pixels = bench.check_pixels(seed, 32 * 18, 16)
    accum = r.accum.reshape(-1, 3)[torch.as_tensor(pixels)].numpy()
    ref, _ = bench.reference_accum(scene, cell, pixels, range(first, first + 3), "cpu")
    assert ref.dtype == accum.dtype and (ref == accum).all()
    assert bench.image_gap(accum, ref) == 0.0
