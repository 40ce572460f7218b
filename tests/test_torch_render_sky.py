"""The CLI's default configuration held against the reference on the CPU:
the reduced atrium (2x2 bays, alpha banners) under sun&sky with the Disney
BSDF (the default ``pbr_mode``), depth 10, through ``Renderer.step`` (the
pooled wavefront, ``render_units_pooled``), under
``tests/test_torch_render.py``'s criterion: at least 99% of pixels within
rtol 1e-3 / atol 1e-4 and the ray counts within 0.1%.

The port takes the reference's tables, baked sky and BVH through
``convert.from_reference``, as ``tests/test_torch_render.py`` does; the
reference runs its fused Pallas path in interpret mode (``VKRT_FUSED=1``)
so that its alpha test uses the same candidate rounds as the port.
"""

import numpy as np
import pytest

from test_torch_render import SMALL_ATRIUM
from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401
from vk_raytrace_tpu import render as ref_render
from vk_raytrace_tpu.models import procedural as ref_proc
from vk_raytrace_tpu.models.schema import PBR_DISNEY, RenderConfig as RefConfig
from vk_raytrace_torch import render as port_render
from vk_raytrace_torch.convert import from_reference
from vk_raytrace_torch.models.schema import RenderConfig

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# The reference CLI's defaults for the atrium with --sun-sky (no HDR file:
# firefly clamp 10, HDR multiplier 1), cut to 48x32 and two frames.
CFG = dict(width=48, height=32, max_depth=10, max_samples=1, pbr_mode=PBR_DISNEY,
           firefly_clamp=10.0, hdr_multiplier=1.0, use_sun_sky=True)
FRAMES = 2


def test_cli_default_disney_sun_sky_matches_reference(monkeypatch):
    monkeypatch.setenv("VKRT_FUSED", "1")
    g, m, l, c, a = ref_proc.atrium_scene(**SMALL_ATRIUM, with_banners=True)
    ref = ref_render.Renderer(ref_render.build_scene(g, m, l, c, atlas=a), RefConfig(**CFG))
    ref_rays = []
    for _ in range(FRAMES):
        ref.step()
        ref_rays.append(ref.last_rays)
    scene, bundle = from_reference(ref.scene, ref.packed)
    assert bundle.alpha_planar is not None
    # The reference renderer already swapped its sky bake in for use_sun_sky.
    port = port_render.Renderer(
        scene, RenderConfig(**{**CFG, "use_sun_sky": False, "sun_disk": True}),
        device="cpu", packed=bundle,
    )
    assert port.stage == "eager"  # Disney shades on the eager stage
    rays = []
    for _ in range(FRAMES):
        port.step()
        rays.append(port.last_rays)
    ref_img, img = np.asarray(ref.accum), port.accum.numpy()
    assert np.isfinite(img).all() and img.mean() > 0.0
    share = np.isclose(img, ref_img, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert share >= 0.99, share
    for r, p in zip(ref_rays, rays):
        assert abs(p - r) <= 1e-3 * r, (ref_rays, rays)
    assert min(rays) > CFG["width"] * CFG["height"]
