"""The port's unrolled integrator (``integrator/path.py::sample_pixels``)
against the reference's, on the Cornell box and the reduced atrium (2x2
bays, banners off, sun&sky baked), glTF and Disney; then ``Renderer.step``
with a debug render mode through the row strips against the reference's
``render_strip_impl``.

Both sides trace the same bytes: the port takes the reference's tables,
baked sky and trees through ``convert.from_reference``; the random streams
are keyed on pixel and frame in both. The reference traverses its 8-wide
XLA trees and the port its 16-wide planar rows, which changes only exact
ties, and XLA on the CPU contracts multiply-adds where torch does not, so
a rare float32 flip of a Russian-roulette, lobe or shadow decision moves a
path. Hence the criterion of ``tests/test_torch_render.py``: at least 99%
of pixels within rtol 1e-3 / atol 1e-4, and ray counts within 0.5% (a
32x24 image traces ~1,600 rays; one flipped shadow ray is 0.06%).
``tests/test_torch_path_debug.py`` holds the first-hit modes and the
heatmap.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401
from vk_raytrace_tpu import render as ref_render
from vk_raytrace_tpu.integrator import camera as ref_camera
from vk_raytrace_tpu.integrator import path as ref_path
from vk_raytrace_tpu.integrator.shade import mat_features as ref_mat_features
from vk_raytrace_tpu.models import procedural as ref_proc
from vk_raytrace_tpu.models.schema import RenderConfig as RefConfig
from vk_raytrace_tpu.ops import rng as ref_rng
from vk_raytrace_torch import render as port_render
from vk_raytrace_torch.convert import from_reference
from vk_raytrace_torch.integrator import camera as port_camera
from vk_raytrace_torch.integrator import path as port_path
from vk_raytrace_torch.integrator.shade import mat_features
from vk_raytrace_torch.models.schema import (
    DEBUG_NONE, DEBUG_NORMAL, DEBUG_RADIANCE, DEBUG_RAYDIR, DEBUG_WEIGHT, PBR_DISNEY, PBR_GLTF,
    RenderConfig,
)
from vk_raytrace_torch.ops import rng as port_rng
from vk_raytrace_torch.ops.traverse_wide import make_alpha_pack

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL_ATRIUM = dict(bays_x=2, bays_z=2, column_segments=16, column_rows=12)
W, H = 32, 24
PIX_RTOL, PIX_ATOL, PIX_SHARE, RAY_REL = 1e-3, 1e-4, 0.99, 5e-3
# Per scene: the config fields of its renders (the atrium's sky is baked, so
# the port and the unrolled reference both see a baked env plus the disk).
SCENE_CFG = {
    "cornell": dict(hdr_multiplier=0.0, firefly_clamp=100.0),
    "atrium": dict(firefly_clamp=10.0, sun_disk=True),
}


def build_pair(name, banners=False):
    """(reference scene, reference packed, port scene, port packed, port
    alpha pack or None, port features) of a test scene."""
    if name == "cornell":
        g, m, l, c = ref_proc.cornell_box()
        scene = ref_render.build_scene(g, m, l, c)
    else:
        g, m, l, c, a = ref_proc.atrium_scene(**SMALL_ATRIUM, with_banners=banners)
        scene = ref_render.build_scene(g, m, l, c, atlas=a)
        scene, _ = ref_render.prepare_sun_sky(scene, RefConfig(use_sun_sky=True))
    packed = ref_render.pack_scene(scene.bvh, scene.geometry)
    pscene, pbundle = from_reference(scene, packed)
    pscene = pscene.to("cpu")
    pack = (make_alpha_pack(pscene.materials, pscene.atlas, pscene.geometry.tri_material)
            if banners else None)
    return scene, packed, pscene, pbundle.to("cpu"), pack, mat_features(pscene.materials)


@pytest.fixture(scope="module")
def pairs():
    return {name: build_pair(name) for name in SCENE_CFG}


def sample_pair(pair, cfg_kw, w=W, h=H, frame=1, has_alpha=False):
    """One sample per pixel of a w x h image through both integrators:
    ``(ref radiance, ref PathState, port radiance, port PathState)``."""
    scene, packed, pscene, pbundle, pack, features = pair
    rcfg, pcfg = RefConfig(width=w, height=h, **cfg_kw), RenderConfig(width=w, height=h, **cfg_kw)
    scene = scene._replace(camera=ref_camera.with_aspect(scene.camera, w, h))
    pix = jnp.arange(w * h, dtype=jnp.uint32)
    seed = ref_rng.tea(pix, jnp.uint32(frame))
    o, d, seed = ref_camera.generate_rays_for_pixels(scene.camera, w, h, pix,
                                                    jnp.asarray(frame, jnp.int32), seed)
    ref_rad, _, ref_st = ref_path.sample_pixels(scene, packed, rcfg, o, d, seed, has_alpha,
                                                features=ref_mat_features(scene.materials))
    pscene = dataclasses.replace(pscene, camera=port_camera.with_aspect(pscene.camera, w, h).to("cpu"))
    ppix = torch.arange(w * h)
    o, d, pseed = port_camera.generate_rays_for_pixels(pscene.camera, w, h, ppix, frame,
                                                       port_rng.tea(ppix, frame))
    rad, _, st = port_path.sample_pixels(pscene, pbundle, pcfg, o, d, pseed, alpha_pack=pack,
                                         features=features)
    return np.asarray(ref_rad), ref_st, rad.numpy(), st


def check_images(ref, out, ref_rays=None, rays=None, share=PIX_SHARE):
    assert np.isfinite(out).all()
    got = float(np.isclose(out, ref, rtol=PIX_RTOL, atol=PIX_ATOL).all(-1).mean())
    assert got >= share, got
    if ref_rays is not None:
        assert abs(rays - ref_rays) <= RAY_REL * ref_rays, (ref_rays, rays)


@pytest.mark.parametrize("pbr", [PBR_GLTF, PBR_DISNEY])
@pytest.mark.parametrize("name", list(SCENE_CFG))
def test_sample_pixels_matches_reference(pairs, name, pbr):
    cfg = dict(SCENE_CFG[name], max_depth=3, pbr_mode=pbr)
    ref, ref_st, out, st = sample_pair(pairs[name], cfg)
    assert out.mean() > 0.0
    check_images(ref, out, int(np.asarray(ref_st.rays).sum()), int(st.rays.sum()))
    np.testing.assert_array_equal(st.seed.numpy(), np.asarray(ref_st.seed).astype(np.int64))


@pytest.mark.parametrize("name,mode,pbr", [
    ("cornell", DEBUG_RADIANCE, PBR_DISNEY),
    ("cornell", DEBUG_WEIGHT, PBR_GLTF),
    ("cornell", DEBUG_RAYDIR, PBR_DISNEY),
    ("atrium", DEBUG_RADIANCE, PBR_GLTF),
    ("atrium", DEBUG_WEIGHT, PBR_DISNEY),
    ("atrium", DEBUG_RAYDIR, PBR_GLTF),
])
def test_last_bounce_debug_modes_match_reference(pairs, name, mode, pbr):
    """The radiance (as without a debug mode), the last bounce's throughput
    and the last ray direction."""
    cfg = dict(SCENE_CFG[name], max_depth=3, pbr_mode=pbr, debug_mode=mode)
    ref, _, out, st = sample_pair(pairs[name], cfg)
    check_images(ref, out)
    if mode != DEBUG_RADIANCE:
        np.testing.assert_array_equal(out, st.debug.numpy())


def test_renderer_step_debug_strips_match_reference(pairs, monkeypatch):
    """``Renderer.step`` with a debug mode renders the frame through row
    strips (here 3 of 8 rows, from a small strip cap) as the reference's
    ``render_strip_impl`` does over the whole image; a second step
    accumulates; ``hdr()`` is the running mean."""
    scene, packed, pscene, pbundle, _, _ = pairs["atrium"]
    cfg = dict(SCENE_CFG["atrium"], width=W, height=H, max_depth=2, max_samples=2,
               pbr_mode=PBR_DISNEY, debug_mode=DEBUG_NORMAL)
    monkeypatch.setattr(port_render, "MAX_RAYS_PER_DISPATCH", 6 * W)
    assert port_render.strip_rows_for(RenderConfig(**cfg)) == 8
    r = port_render.Renderer(pscene, RenderConfig(**cfg), device="cpu", packed=pbundle)
    r.step()
    assert r.last_rays > W * H * 2
    rscene = scene._replace(camera=ref_camera.with_aspect(scene.camera, W, H))
    ref = ref_render.render_strip_impl(
        rscene, packed, RefConfig(**cfg), jnp.asarray(0, jnp.int32), H, jnp.asarray(0, jnp.int32),
        False, features=ref_mat_features(scene.materials))
    check_images(np.asarray(ref), r.hdr().numpy())
    first = r.hdr().clone()
    r.step()
    assert r.frame == 2 and torch.isfinite(r.hdr()).all()
    # Frame 1 jitters the camera rays: the mean moves, within the normals' range.
    assert not torch.equal(r.hdr(), first) and float(r.hdr().min()) >= 0.0
    assert r._run_cfg.debug_mode != DEBUG_NONE


def test_default_config_renders_disney(pairs):
    """``Renderer(scene, RenderConfig(), device)``: the default config is the
    Disney BSDF, the pooled wavefront renders it, and the fused request
    keeps the eager stage (the reference's rule)."""
    _, _, pscene, pbundle, _, _ = pairs["cornell"]
    cfg = RenderConfig(width=W, height=H, max_depth=2, hdr_multiplier=0.0)
    assert cfg.pbr_mode == PBR_DISNEY and RenderConfig().pbr_mode == PBR_DISNEY
    for fused in (False, True):
        r = port_render.Renderer(pscene, cfg, device="cpu", packed=pbundle, fused_shade=fused)
        assert r.stage == "eager"
        r.step()
        img = r.hdr().numpy()
        assert np.isfinite(img).all() and img.mean() > 0.0 and r.last_rays > W * H
