"""The slice end to end: the port's ``Renderer(device="cpu")`` against the
reference ``Renderer`` on the reduced atrium, 64x48, depth 4, 1 spp, two
frames, the bench configuration (glTF PBR, sun&sky, firefly clamp 10).

Both render the same bytes: the port takes the reference's scene tables,
baked sky and BVH through ``convert.from_reference``; the random streams
are keyed on pixel and frame in both. The reference traverses 8-wide XLA
trees (banners off) where the port traverses 16-wide planar ones, which
changes only exact ties; a rare float32 flip of a Russian-roulette or alpha
branch explains the rest. Hence: at least 99% of pixels within rtol 1e-3 /
atol 1e-4, and ray counts within 0.1%. With banners on, the reference runs
its fused Pallas path (``VKRT_FUSED=1``, interpret mode) so that its alpha
test uses the same candidate rounds as the port.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_traverse import isolated_reference  # noqa: F401 (autouse)
from vk_raytrace_tpu import render as ref_render
from vk_raytrace_tpu.models import procedural as ref_proc
from vk_raytrace_tpu.models.schema import PBR_GLTF, RenderConfig as RefConfig
from vk_raytrace_tpu.models.schema import default_tonemapper as ref_tonemapper
from vk_raytrace_tpu.ops import tonemap as ref_tonemap
from vk_raytrace_torch import render as port_render
from vk_raytrace_torch.convert import from_reference
from vk_raytrace_torch.models import procedural as port_proc
from vk_raytrace_torch.models.schema import RenderConfig, default_tonemapper
from vk_raytrace_torch.ops import tonemap as port_tonemap

SMALL_ATRIUM = dict(bays_x=2, bays_z=2, column_segments=16, column_rows=12)
CFG = dict(width=64, height=48, max_depth=4, max_samples=1, pbr_mode=PBR_GLTF,
           firefly_clamp=10.0, use_sun_sky=True)
FRAMES = 2


def _render_pair(banners: bool):
    g, m, l, c, a = ref_proc.atrium_scene(**SMALL_ATRIUM, with_banners=banners)
    ref = ref_render.Renderer(ref_render.build_scene(g, m, l, c, atlas=a), RefConfig(**CFG))
    ref_rays = []
    for _ in range(FRAMES):
        ref.step()
        ref_rays.append(ref.last_rays)
    scene, bundle = from_reference(ref.scene, ref.packed)
    assert (bundle.alpha_planar is not None) == banners
    # The reference renderer already swapped its sky bake in for use_sun_sky.
    port = port_render.Renderer(
        scene, RenderConfig(**{**CFG, "use_sun_sky": False, "sun_disk": True}),
        device="cpu", packed=bundle,
    )
    port_rays = []
    for _ in range(FRAMES):
        port.step()
        port_rays.append(port.last_rays)
    return np.asarray(ref.accum), ref_rays, port.accum.numpy(), port_rays


def _check(ref_img, ref_rays, img, rays):
    assert np.isfinite(img).all() and img.mean() > 0.0
    share = np.isclose(img, ref_img, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert share >= 0.99, share
    for r, p in zip(ref_rays, rays):
        assert abs(p - r) <= 1e-3 * r, (ref_rays, rays)
    assert min(rays) > CFG["width"] * CFG["height"]


def test_render_matches_reference_without_banners():
    _check(*_render_pair(banners=False))


def test_render_matches_reference_with_banners(monkeypatch):
    monkeypatch.setenv("VKRT_FUSED", "1")
    _check(*_render_pair(banners=True))


def test_jax_free_pipeline_renders_like_reference():
    """The port's own scene build and sky bake: same image up to the env
    alias table (tested separately), so close on average."""
    g, m, l, c, a = ref_proc.atrium_scene(**SMALL_ATRIUM, with_banners=False)
    ref = ref_render.Renderer(ref_render.build_scene(g, m, l, c, atlas=a), RefConfig(**CFG))
    ref.step()
    pg, pm, pl, pc, pa = port_proc.atrium_scene(**SMALL_ATRIUM, with_banners=False)
    port = port_render.Renderer(
        port_render.build_scene(pg, pm, pl, pc, atlas=pa), RenderConfig(**CFG), device="cpu"
    )
    port.step()
    ref_img, img = np.asarray(ref.accum), port.accum.numpy()
    assert np.isfinite(img).all()
    assert abs(img.mean() - ref_img.mean()) <= 0.05 * ref_img.mean()
    assert abs(port.last_rays - ref.last_rays) <= 0.01 * ref.last_rays


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("auto_exposure", [0, 1, 3])
def test_apply_post_matches_reference(mode, auto_exposure):
    rng = np.random.default_rng(21)
    hdr = (rng.random((48, 64, 3)) ** 3 * 4.0).astype(np.float32)
    tm_r = ref_tonemapper()._replace(auto_exposure=np.int32(auto_exposure))
    tm_p = dataclasses.replace(default_tonemapper(), auto_exposure=np.int32(auto_exposure)).to("cpu")
    ref = np.asarray(ref_tonemap.apply_post(hdr, tm_r, mode=mode))
    out = port_tonemap.apply_post(torch.from_numpy(hdr), tm_p, mode=mode).numpy()
    # The dither picks between two 8-bit levels by comparing with a noise
    # value; a float32 ulp can flip a pixel by exactly one level.
    close = np.isclose(out, ref, rtol=1e-5, atol=1e-5)
    assert close.mean() >= 0.999, close.mean()
    np.testing.assert_allclose(out, ref, atol=1.0 / 255.0 + 1e-5)
