"""The first-hit debug render modes and the step heatmap of the port's
unrolled integrator against the reference (the scenes, the helpers and the
pixel criterion of ``tests/test_torch_path.py``), and the unrolled
integrator against the pooled wavefront on a two-level scene.

The heatmap maps the traversal's node count per path onto the colour ramp.
The port's kernels and twins count every row a ray visits (interior or
leaf, ``ops/traverse_fused.py``), as the reference's planar step kernel
does (one step per node and active lane); the reference's 8-wide XLA trees
count their own nodes. So the heatmap runs the reference's planar path
(``VKRT_FUSED=1``, Pallas interpret mode) on identical rows of the Cornell
box, and the step counts must be equal on every pixel.

The two-level case renders ``DEBUG_RADIANCE`` (the radiance through the
strips) and ``DEBUG_NONE`` (the pooled wavefront) of the port on the small
bistro: both draw a pixel's sample from the same stream (pixel, frame and
sample), so the images meet the pixel criterion and the ray counts agree.
"""

import numpy as np
import pytest

from test_torch_path import SCENE_CFG, build_pair, check_images, sample_pair
from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401
from vk_raytrace_torch import render as port_render
from vk_raytrace_torch.models import procedural as port_proc
from vk_raytrace_torch.models.schema import (
    DEBUG_ALPHA, DEBUG_BASECOLOR, DEBUG_EMISSIVE, DEBUG_HEATMAP, DEBUG_METALLIC, DEBUG_NONE,
    DEBUG_NORMAL, DEBUG_RADIANCE, DEBUG_ROUGHNESS, DEBUG_TANGENT, DEBUG_TEXCOORD, PBR_DISNEY,
    PBR_GLTF, RenderConfig,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FIRST_HIT = (DEBUG_BASECOLOR, DEBUG_NORMAL, DEBUG_METALLIC, DEBUG_EMISSIVE, DEBUG_ALPHA,
             DEBUG_ROUGHNESS, DEBUG_TEXCOORD, DEBUG_TANGENT)


@pytest.fixture(scope="module")
def pairs():
    return {name: build_pair(name) for name in SCENE_CFG}


@pytest.mark.parametrize("mode", FIRST_HIT)
def test_first_hit_modes_match_reference(pairs, mode):
    """Each first-hit state on the textured atrium (depth 2; the first hit's
    state does not depend on the depth), the BSDF alternating."""
    pbr = PBR_DISNEY if mode % 2 else PBR_GLTF
    cfg = dict(SCENE_CFG["atrium"], max_depth=2, pbr_mode=pbr, debug_mode=mode)
    ref, _, out, st = sample_pair(pairs["atrium"], cfg)
    check_images(ref, out)
    np.testing.assert_array_equal(out, st.debug.numpy())
    if mode != DEBUG_EMISSIVE:  # the atrium has no emissive material
        assert (out != 0.0).any()


@pytest.mark.parametrize("mode", [DEBUG_NORMAL, DEBUG_BASECOLOR])
def test_first_hit_modes_on_cornell(pairs, mode):
    cfg = dict(SCENE_CFG["cornell"], max_depth=1, pbr_mode=PBR_DISNEY, debug_mode=mode)
    ref, _, out, _ = sample_pair(pairs["cornell"], cfg)
    check_images(ref, out, share=1.0)


def test_heatmap_matches_reference(pairs, monkeypatch):
    monkeypatch.setenv("VKRT_FUSED", "1")
    cfg = dict(SCENE_CFG["cornell"], max_depth=2, pbr_mode=PBR_GLTF, debug_mode=DEBUG_HEATMAP,
               max_heatmap=16.0)
    ref, ref_st, out, st = sample_pair(pairs["cornell"], cfg, w=16, h=16)
    steps = st.steps.numpy()
    np.testing.assert_array_equal(steps, np.asarray(ref_st.steps))
    # Rays past the open front of the box miss the root box: 0 nodes.
    assert (steps > 0).mean() > 0.5 and len(np.unique(steps)) >= 3
    check_images(ref, out, share=1.0)


def test_unrolled_matches_pooled_on_two_level_scene():
    pool, inst, mats, lights, cam, atlas = port_proc.bistro_scene(detail=0.05)
    scene = port_render.build_instanced_scene(pool, inst, mats, lights, cam, atlas=atlas)
    base = dict(width=32, height=18, max_depth=3, max_samples=1, pbr_mode=PBR_GLTF,
                firefly_clamp=10.0, use_sun_sky=True)
    imgs, rays = {}, {}
    for mode in (DEBUG_NONE, DEBUG_RADIANCE):
        r = port_render.Renderer(scene, RenderConfig(**base, debug_mode=mode), device="cpu")
        r.step()
        imgs[mode], rays[mode] = r.hdr().numpy(), r.last_rays
    assert imgs[DEBUG_NONE].mean() > 0.0
    check_images(imgs[DEBUG_NONE], imgs[DEBUG_RADIANCE], rays[DEBUG_NONE], rays[DEBUG_RADIANCE])
