"""The port's progressive Cornell renders against the stored goldens of
``tests/test_golden.py`` (made by the reference, 64x64, depth 3, 1 spp,
32 frames, glTF and Disney), under the reference's own gate: RMSE over the
golden's RMS below 1%. The port renders through ``Renderer.step`` (the
pooled wavefront) on the CPU from its own scene build; the goldens are
read, never written. Measured: 0.0012 (glTF) and 0.0006 (Disney).
"""

import os

import numpy as np
import pytest

from vk_raytrace_torch import render as R
from vk_raytrace_torch.models import procedural
from vk_raytrace_torch.models.schema import PBR_DISNEY, PBR_GLTF, RenderConfig
from test_torch_traverse import one_torch_thread  # noqa: F401 (used below)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _render_cornell(pbr_mode, frames=32):
    geom, mats, lights, cam = procedural.cornell_box()
    scene = R.build_scene(geom, mats, lights, cam)
    cfg = RenderConfig(width=64, height=64, max_depth=3, max_samples=1, hdr_multiplier=0.0,
                       pbr_mode=pbr_mode, firefly_clamp=100.0)
    r = R.Renderer(scene, cfg, device="cpu")
    for _ in range(frames):
        r.step()
    return r.hdr().numpy()


def _rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)))


@pytest.mark.parametrize("name,mode", [
    ("cornell_64_d3_gltf_32f.npy", PBR_GLTF),
    ("cornell_64_d3_disney_32f.npy", PBR_DISNEY),
])
def test_cornell_matches_golden(name, mode):
    golden = np.load(os.path.join(GOLDEN_DIR, name))
    img = _render_cornell(mode)
    assert img.shape == golden.shape and np.isfinite(img).all()
    scale = float(np.sqrt(np.mean(golden**2)))
    assert _rmse(img, golden) / scale < 0.01, (_rmse(img, golden), scale)


def test_rmse_decreases_with_accumulation():
    """More accumulation: closer to the (converged) golden estimate."""
    golden = np.load(os.path.join(GOLDEN_DIR, "cornell_64_d3_gltf_32f.npy"))
    assert _rmse(_render_cornell(PBR_GLTF, frames=16), golden) < _rmse(
        _render_cornell(PBR_GLTF, frames=4), golden)
