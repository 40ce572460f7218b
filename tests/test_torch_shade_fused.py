"""The fused shading stage of the port against the reference.

1. Module: the port's ``shade_bounce_fused`` (its plain torch body on the
   CPU) against the reference's (Pallas interpret mode) on the same hits,
   states and seeds, made with numpy, on the reference's textured helmet
   scene and on the reduced atrium with its baked sky; ``full_mis``,
   ``sun_disk`` and the ray-cone mip LOD both ways. Seeds leaving the stage
   are bit-exact. Masks agree on >= 99.9% of lanes and vectors within
   rtol 1e-4 / atol 1e-5 where they agree: XLA on the CPU contracts
   multiply-adds into FMAs and rewrites some divisions, torch rounds every
   operation, and an ulp can flip a lane's branch.
2. Fused vs unfused inside the port, on the CPU: the reference's own gate
   (``tests/test_shade_fused.py``), max |difference| < 2e-4 on the image.
   The two stages differ only in association order and in pow versus
   exp/log forms.
3. The port's fused renderer against the reference's fused renderer
   (``VKRT_FUSED_SHADE=1``), with the thresholds of
   ``tests/test_torch_render.py``, on jittered frames.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401 (fixtures)
from vk_raytrace_tpu import render as ref_render
from vk_raytrace_tpu.integrator import shade as ref_shade
from vk_raytrace_tpu.integrator import shade_fused as ref_fused
from vk_raytrace_tpu.models import procedural as ref_proc
from vk_raytrace_tpu.models.hdr import build_environment
from vk_raytrace_tpu.models.schema import PBR_GLTF, RenderConfig as RefConfig
from vk_raytrace_torch import render as port_render
from vk_raytrace_torch.convert import from_reference
from vk_raytrace_torch.integrator import shade as port_shade
from vk_raytrace_torch.integrator import shade_fused as port_fused
from vk_raytrace_torch.models import procedural as port_proc
from vk_raytrace_torch.models.schema import RenderConfig
from vk_raytrace_torch.ops.traverse_fused import Hit

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 2048
RTOL, ATOL, MASK_SHARE = 1e-4, 1e-5, 0.999
SMALL_ATRIUM = dict(bays_x=2, bays_z=2, column_segments=16, column_rows=12)
VEC_KEYS = ("new_origin", "new_dir", "radiance", "throughput", "absorption", "nee",
            "light_dir", "light_dist", "rr_pcont", "pdf_b")


class _RefHit(NamedTuple):
    t: object
    tri: object
    u: object
    v: object


def _gradient_env(h=16, w=32):
    y = np.linspace(0.2, 1.5, h)[:, None]
    img = np.broadcast_to(y, (h, w))[..., None] * np.array([1.0, 0.9, 0.7])
    return build_environment(jnp.asarray(img, jnp.float32))


@pytest.fixture(scope="module")
def helmet():
    g, m, l, c, a = ref_proc.helmet_scene(12, 24)
    return ref_render.build_scene(g, m, l, c, atlas=a)._replace(env=_gradient_env())


@pytest.fixture(scope="module")
def atrium():
    g, m, l, c, a = ref_proc.atrium_scene(**SMALL_ATRIUM)
    scene = ref_render.build_scene(g, m, l, c, atlas=a)
    cfg = RefConfig(width=64, height=48, pbr_mode=PBR_GLTF, use_sun_sky=True)
    scene, _ = ref_render.prepare_sun_sky(scene, cfg)
    return scene


def _inputs(scene, seed):
    rng = np.random.default_rng(seed)
    n_tri = len(np.asarray(scene.geometry.indices))
    tri = rng.integers(0, n_tri, N).astype(np.int32)
    tri[rng.random(N) < 0.1] = -1
    w = rng.dirichlet(np.ones(3), N).astype(np.float32)
    d = rng.standard_normal((N, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    f32 = lambda *s, lo=0.0, hi=1.0: rng.uniform(lo, hi, s).astype(np.float32)  # noqa: E731
    return dict(
        tri=tri, u=w[:, 1], v=w[:, 2], t=np.where(tri >= 0, f32(N, lo=0.1, hi=20.0), 1e32).astype(np.float32),
        origin=f32(N, 3, lo=-5.0, hi=5.0), direction=d,
        seed=rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32),
        active=rng.random(N) < 0.9,
        radiance=f32(N, 3), throughput=f32(N, 3, lo=0.05), absorption=f32(N, 3, hi=0.2),
        bsdf_pdf=np.where(rng.random(N) < 0.3, 0.0, f32(N, lo=0.1, hi=4.0)).astype(np.float32),
        tdist=f32(N, lo=0.5, hi=30.0),
    )


CASES = [  # (scene, full_mis, sun_disk, mip)
    ("helmet", True, False, True),
    ("helmet", False, False, False),
    ("helmet", True, True, False),
    ("atrium", True, True, True),
    ("atrium", False, True, True),
    ("atrium", True, False, False),
]


@pytest.mark.parametrize("name,full_mis,sun_disk,mip", CASES)
def test_shade_bounce_fused_matches_reference(request, name, full_mis, sun_disk, mip):
    scene = request.getfixturevalue(name)
    x = _inputs(scene, seed=len(name) * 7 + 2 * full_mis + sun_disk)
    spread = 0.002
    p_sel = 0.5

    jscene = jax.tree.map(jnp.asarray, scene)
    feats = ref_shade.mat_features(scene.materials)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    ref = ref_fused.shade_bounce_fused(
        jscene, feats, full_mis, p_sel, jnp.float32(1.0),
        _RefHit(j["t"], j["tri"], j["u"], j["v"]), j["origin"], j["direction"], j["seed"],
        j["active"], j["radiance"], j["throughput"], j["absorption"], j["bsdf_pdf"],
        sun_disk=sun_disk, mip=(spread, j["tdist"]) if mip else None,
    )

    port_scene, _ = from_reference(scene)
    port_scene = port_scene.to("cpu")
    t = {k: torch.from_numpy(np.array(v)) for k, v in x.items()}
    hit = Hit(t["t"], t["tri"].long(), t["u"], t["v"], torch.zeros(N, dtype=torch.int32))
    out = port_fused.shade_bounce_fused(
        port_scene, port_shade.mat_features(port_scene.materials), full_mis, p_sel, 1.0, hit,
        t["origin"], t["direction"], t["seed"].long() & 0xFFFFFFFF, t["active"],
        t["radiance"], t["throughput"], t["absorption"], t["bsdf_pdf"],
        sun_disk=sun_disk, mip=(spread, t["tdist"]) if mip else None,
    )

    np.testing.assert_array_equal(out["seed"].numpy().astype(np.uint32), np.asarray(ref["seed"]))
    np.testing.assert_array_equal(out["miss"].numpy(), np.asarray(ref["miss"]))
    agree = np.ones(N, bool)
    for k in ("alive", "visible"):
        same = out[k].numpy() == np.asarray(ref[k])
        assert same.mean() >= MASK_SHARE, (k, same.mean())
        agree &= same
    for k in VEC_KEYS:
        a = out[k].numpy().reshape(N, -1)[agree]
        b = np.asarray(ref[k]).reshape(N, -1)[agree]
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=k)
    assert np.asarray(ref["alive"]).mean() > 0.3  # the lanes did shade


def test_shade_plain_dispatch_and_inputs(atrium):
    port_scene, _ = from_reference(atrium)
    port_scene = port_scene.to("cpu")
    feats = port_shade.mat_features(port_scene.materials)
    cfg = RenderConfig(pbr_mode=PBR_GLTF, sun_disk=True)
    assert port_fused.supported(True, cfg, port_scene, feats)
    assert not port_fused.supported(False, cfg, port_scene, feats)
    assert not port_fused.supported(True, RenderConfig(), port_scene, feats)  # Disney
    x = _inputs(atrium, seed=5)
    t = {k: torch.from_numpy(np.array(v)) for k, v in x.items()}
    hit = Hit(t["t"], t["tri"].long(), t["u"], t["v"], torch.zeros(N, dtype=torch.int32))
    ins = port_fused.shade_inputs(
        port_scene, feats, True, 0.5, 1.0, hit, t["origin"], t["direction"],
        t["seed"].long(), None, t["radiance"], t["throughput"], t["absorption"], t["bsdf_pdf"],
        sun_disk=True,
    )
    assert ins.srow.shape == (N, 128) and ins.taps.shape == (N, 16) and ins.aux.shape == (N, 48)
    assert ins.taps.dtype == torch.int32 and ins.aux[:, 16].eq(1.0).all()  # all lanes live
    before = dict(port_fused.LAUNCHES)
    out_vec, alive, visible = port_fused.shade(ins.srow, ins.taps, ins.aux, ins.flags)
    assert port_fused.LAUNCHES == before  # the plain version is no launch
    assert out_vec.shape == (N, 24) and alive.dtype == torch.bool and visible.shape == (N,)
    assert torch.isfinite(out_vec[alive]).all()


def _port_render(scene, cfg, fused, frames=2):
    r = port_render.Renderer(scene, cfg, device="cpu", fused_shade=fused)
    for _ in range(frames):
        r.step()
    return r.accum.numpy(), r.last_rays


@pytest.mark.parametrize("case", ["cornell", "helmet", "helmet_compat"])
def test_fused_matches_unfused(request, case):
    if case == "cornell":
        g, m, l, c = port_proc.cornell_box()
        scene = port_render.build_scene(g, m, l, c)
        cfg = RenderConfig(width=32, height=32, max_depth=2, max_samples=2,
                           hdr_multiplier=0.0, pbr_mode=PBR_GLTF)
    else:
        ref_scene = request.getfixturevalue("helmet")
        if case == "helmet_compat":
            ref_scene = ref_scene._replace(
                env=build_environment(jnp.asarray(np.full((8, 16, 3), 0.6, np.float32))))
        scene, _ = from_reference(ref_scene)
        compat = case == "helmet_compat"
        cfg = RenderConfig(width=32 if compat else 48, height=24 if compat else 32, max_depth=3,
                           max_samples=1, hdr_multiplier=1.0, pbr_mode=PBR_GLTF,
                           firefly_clamp=1e20 if compat else 10.0, full_mis=not compat)
        assert port_fused.supported(True, cfg, scene, port_shade.mat_features(scene.materials))
    a, rays_a = _port_render(scene, cfg, False)
    b, rays_b = _port_render(scene, cfg, True)
    assert np.isfinite(b).all() and b.mean() > 0.0
    assert np.abs(a - b).max() < 2e-4, np.abs(a - b).max()
    assert rays_a == rays_b


def test_fused_renderer_matches_reference_fused(monkeypatch):
    """Cornell at the reference's own parity config, with the thresholds of
    ``tests/test_torch_render.py``. Both renderers start at frame 1: frame 0
    shoots unjittered pixel-centre rays, which land exactly on the shared
    diagonals of the box's quads, where an ulp (XLA's FMA against torch's
    rounding) picks the triangle and so the path; from frame 1 on the rays
    are jittered."""
    monkeypatch.setenv("VKRT_FUSED_SHADE", "1")
    monkeypatch.setenv("VKRT_FUSED", "1")
    g, m, l, c = ref_proc.cornell_box()
    kw = dict(width=32, height=32, max_depth=2, max_samples=2, hdr_multiplier=0.0,
              pbr_mode=PBR_GLTF)
    ref = ref_render.Renderer(ref_render.build_scene(g, m, l, c), RefConfig(**kw))
    ref.frame = 1
    ref_rays = []
    for _ in range(3):
        ref.step()
        ref_rays.append(ref.last_rays)
    scene, bundle = from_reference(ref.scene, ref.packed)
    port = port_render.Renderer(scene, RenderConfig(**kw), device="cpu", packed=bundle,
                                fused_shade=True)
    port.frame = 1
    rays = []
    for _ in range(3):
        port.step()
        rays.append(port.last_rays)
    img, ref_img = port.accum.numpy(), np.asarray(ref.accum)
    assert np.isfinite(img).all() and img.mean() > 0.0
    share = np.isclose(img, ref_img, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert share >= 0.99, share
    for r, p in zip(ref_rays, rays):
        assert abs(p - r) <= 1e-3 * r, (ref_rays, rays)
