"""Render slices at width 32: the small atrium and the small bistro, the
port (CPU, the reference's tables and width-32 trees) against the
reference's ``VKRT_WIDE=32`` renderer, with the thresholds of
``tests/test_torch_render.py``: >= 99% of pixels within rtol 1e-3 / atol
1e-4, ray counts within 0.1%.
"""

import pytest

import numpy as np

from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401 (fixtures)
from test_torch_width32 import SMALL_ATRIUM
from vk_raytrace_tpu import render as ref_render
from vk_raytrace_tpu.models import procedural as ref_proc
from vk_raytrace_tpu.models.schema import PBR_GLTF, RenderConfig as RefConfig
from vk_raytrace_torch import render as port_render
from vk_raytrace_torch.convert import from_reference
from vk_raytrace_torch.models.schema import RenderConfig

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RENDER_CFG = dict(max_depth=4, max_samples=1, pbr_mode=PBR_GLTF, firefly_clamp=10.0,
                  use_sun_sky=True)


def _render_both(ref, packed, cfg, frames=2, first_frame=0):
    """Step the reference renderer and the port's (CPU, the reference's
    tables and width-32 trees) ``frames`` times; (images, ray counts)."""
    scene, acc = from_reference(ref.scene, packed)
    port = port_render.Renderer(
        scene, RenderConfig(**{**cfg, "use_sun_sky": False, "sun_disk": True}), device="cpu",
        packed=acc,
    )
    imgs, rays = [], []
    for r in (ref, port):
        r.frame = first_frame
        rays.append([])
        for _ in range(frames):
            r.step()
            rays[-1].append(r.last_rays)
        imgs.append(np.asarray(r.accum if r is ref else r.accum.numpy()))
    return imgs, rays


def _check_render(imgs, rays, w, h):
    ref_img, img = imgs
    assert np.isfinite(img).all() and img.mean() > 0.0
    share = np.isclose(img, ref_img, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert share >= 0.99, share
    for r, p in zip(*rays):
        assert abs(p - r) <= 1e-3 * r, rays
    assert min(rays[1]) > w * h


def test_render_w32_atrium_matches_reference(monkeypatch):
    monkeypatch.setenv("VKRT_WIDE", "32")
    monkeypatch.setenv("VKRT_FUSED", "1")
    g, m, l, c, a = ref_proc.atrium_scene(**SMALL_ATRIUM)
    cfg = dict(width=64, height=48, **RENDER_CFG)
    ref = ref_render.Renderer(ref_render.build_scene(g, m, l, c, atlas=a), RefConfig(**cfg))
    assert ref.packed.opaque_planar.width == 32 and ref.packed.alpha_planar.width == 32
    _check_render(*_render_both(ref, ref.packed, cfg), 64, 48)


def test_render_w32_bistro_matches_reference(monkeypatch):
    """From frame 1 (jittered), as ``tests/test_torch_bistro.py`` does."""
    monkeypatch.setenv("VKRT_WIDE", "32")
    monkeypatch.setenv("VKRT_FUSED", "1")
    pool, inst, mats, lights, cam, atlas = ref_proc.bistro_scene(detail=0.05)
    cfg = dict(width=64, height=36, hdr_multiplier=1.0, full_mis=False, **RENDER_CFG)
    ref = ref_render.Renderer(
        ref_render.build_instanced_scene(pool, inst, mats, lights, cam, atlas=atlas),
        RefConfig(**cfg),
    )
    assert ref.packed.blas_planar.width == 32
    _check_render(*_render_both(ref, ref.packed, cfg, first_frame=1), 64, 36)
