"""Shading of the port against the reference on shared random inputs:
shade state, material resolve (footprint taps, mip LOD), glTF BSDF
eval/sample, punctual lights and the sun&sky environment (NEE mixture and
miss radiance), on the reduced atrium with the reference's baked sky.

Tolerance rtol 1e-4 / atol 1e-5: float32 chains of normalize, pow, exp and
trigonometry, rounded per operation by torch and contracted into FMAs by
XLA on the CPU. Random streams (seeds) must be bit-exact. Where a lane
takes a discrete choice from a computed float — a sample's branch, a mip
level rounded from the ray-cone LOD, the texel a uv floors to — an ulp can
flip it for that lane: those comparisons hold on 99% of lanes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_traverse import isolated_reference  # noqa: F401 (autouse)
from vk_raytrace_tpu import render as ref_render
from vk_raytrace_tpu.integrator import shade as ref_shade
from vk_raytrace_tpu.models import procedural as ref_proc
from vk_raytrace_tpu.models.schema import PBR_GLTF, RenderConfig as RefConfig
from vk_raytrace_tpu.ops import bsdf_gltf as ref_bsdf
from vk_raytrace_tpu.ops import env as ref_env
from vk_raytrace_tpu.ops import lights as ref_lights
from vk_raytrace_torch.convert import from_reference
from vk_raytrace_torch.integrator import shade as port_shade
from vk_raytrace_torch.ops import bsdf_gltf as port_bsdf
from vk_raytrace_torch.ops import env as port_env
from vk_raytrace_torch.ops import lights as port_lights

N = 2048
RTOL, ATOL = 1e-4, 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref, frac=1.0):
    out, ref = np.asarray(out), np.asarray(ref)
    if frac >= 1.0:
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
        return
    ok = np.isclose(out, ref, rtol=RTOL, atol=ATOL)
    ok = ok.reshape(len(ok), -1).all(axis=1)
    assert ok.mean() >= frac, ok.mean()


@pytest.fixture(scope="module")
def scenes():
    g, m, l, c, a = ref_proc.atrium_scene(bays_x=2, bays_z=2, column_segments=16, column_rows=12)
    scene = ref_render.build_scene(g, m, l, c, atlas=a)
    cfg = RefConfig(width=64, height=48, pbr_mode=PBR_GLTF, use_sun_sky=True)
    scene, _ = ref_render.prepare_sun_sky(scene, cfg)
    port_scene, _ = from_reference(scene)
    return scene, port_scene.to("cpu")


@pytest.fixture(scope="module")
def hits(scenes):
    scene, _ = scenes
    rng = np.random.default_rng(11)
    tri = rng.integers(0, len(np.asarray(scene.geometry.indices)), N)
    w = rng.dirichlet(np.ones(3), N).astype(np.float32)
    d = rng.standard_normal((N, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    lod = rng.uniform(-14.0, -4.0, N).astype(np.float32)
    return tri, w[:, 1], w[:, 2], d, lod


@pytest.fixture(scope="module")
def states(scenes, hits):
    scene, port = scenes
    tri, u, v, d, lod = hits
    ss_r = ref_shade.get_shade_state(
        scene.geometry, jnp.asarray(tri, jnp.int32), jnp.asarray(u), jnp.asarray(v),
        shade_rows=jnp.asarray(scene.shade_rows),
    )
    ss_p = port_shade.get_shade_state(port.shade_rows, _t(tri), _t(u), _t(v))
    feats = ref_shade.mat_features(scene.materials)
    lod_r = ss_r["uv_density"] + jnp.asarray(lod)
    lod_p = ss_p["uv_density"] + _t(lod)
    st_r = ref_shade.resolve_material(
        ss_r, scene.materials, scene.atlas, jnp.asarray(d), features=feats,
        tap_rows=jnp.asarray(scene.tap_rows), lod=lod_r,
    )
    st_p = port_shade.resolve_material(
        ss_p, port.atlas, _t(d), features=port_shade.mat_features(port.materials),
        tap_rows=port.tap_rows, lod=lod_p,
    )
    return ss_r, ss_p, st_r, st_p


@pytest.mark.parametrize(
    "key", ["position", "normal", "geom_normal", "tangent", "bitangent", "uv", "color", "uv_density"]
)
def test_get_shade_state(states, key):
    ss_r, ss_p, _, _ = states
    _close(ss_p[key].numpy(), ss_r[key])


def test_resolve_material(states):
    _, _, st_r, st_p = states
    for f in ("position", "normal", "ffnormal", "tangent", "bitangent", "tex_coord", "eta"):
        _close(getattr(st_p, f).numpy(), getattr(st_r, f))
    for name in st_p.mat._fields:
        _close(getattr(st_p.mat, name).numpy(), getattr(st_r.mat, name), frac=0.99)
    assert np.asarray(st_r.mat.albedo).std() > 0.01  # textures were sampled


def test_mat_features(scenes):
    scene, port = scenes
    ref = ref_shade.mat_features(scene.materials)
    out = port_shade.mat_features(port.materials)
    assert dataclasses.asdict(out) == dataclasses.asdict(ref)


def test_pbr_eval(states, hits):
    _, _, st_r, st_p = states
    rng = np.random.default_rng(12)
    l = rng.standard_normal((N, 3))
    l = (l / np.linalg.norm(l, axis=1, keepdims=True)).astype(np.float32)
    v = -hits[3]
    f_r, pdf_r = ref_bsdf.pbr_eval(st_r, jnp.asarray(v), st_r.ffnormal, jnp.asarray(l))
    f_p, pdf_p = port_bsdf.pbr_eval(st_p, _t(v), st_p.ffnormal, _t(l))
    _close(f_p.numpy(), f_r, frac=0.99)
    _close(pdf_p.numpy(), pdf_r, frac=0.99)


@pytest.mark.parametrize("combined", [False, True])
def test_pbr_sample(states, hits, combined):
    _, _, st_r, st_p = states
    seed = np.random.default_rng(13).integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    v = -hits[3]
    f_r, l_r, pdf_r, s_r = ref_bsdf.pbr_sample(st_r, jnp.asarray(v), st_r.ffnormal, jnp.asarray(seed), combined=combined)
    f_p, l_p, pdf_p, s_p = port_bsdf.pbr_sample(st_p, _t(v), st_p.ffnormal, _t(seed.astype(np.int64)), combined=combined)
    np.testing.assert_array_equal(s_p.numpy().astype(np.uint32), np.asarray(s_r))
    _close(l_p.numpy(), l_r, frac=0.99)
    _close(f_p.numpy(), f_r, frac=0.99)
    _close(pdf_p.numpy(), pdf_r, frac=0.99)


def test_sample_light(scenes, states):
    scene, port = scenes
    ss_r, ss_p = states[0], states[1]
    n_l = int(scene.n_lights)
    idx = np.random.default_rng(14).integers(0, n_l, N)
    out_r = ref_lights.sample_light(scene.lights, jnp.asarray(idx, jnp.int32), ss_r["position"])
    out_p = port_lights.sample_light(port.lights, _t(idx), ss_p["position"])
    for a, b in zip(out_p, out_r):
        _close(a.numpy(), b)


def test_env_sample_sun_mixture(scenes):
    scene, port = scenes
    seed = np.random.default_rng(15).integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    rad_r, dir_r, pdf_r, s_r = ref_env.env_sample(
        scene.env, scene.sun_sky, False, 1.0, jnp.asarray(seed), sun_disk=True
    )
    rad_p, dir_p, pdf_p, s_p = port_env.env_sample(
        port.env, port.sun_sky, 1.0, _t(seed.astype(np.int64)), sun_disk=True
    )
    np.testing.assert_array_equal(s_p.numpy().astype(np.uint32), np.asarray(s_r))
    _close(dir_p.numpy(), dir_r)
    _close(pdf_p.numpy(), pdf_r, frac=0.99)
    _close(rad_p.numpy(), rad_r, frac=0.99)


def test_env_radiance_and_pdf(scenes, hits):
    scene, port = scenes
    d = hits[3]
    # Half of the directions inside the sun's cone, where the disk adds in.
    axis = np.asarray(scene.sun_sky.sun_direction, np.float64)
    axis /= np.linalg.norm(axis)
    near = axis + 0.002 * np.random.default_rng(16).standard_normal((N // 2, 3))
    d = np.concatenate([d[: N // 2], near / np.linalg.norm(near, axis=1, keepdims=True)]).astype(np.float32)
    e_r = ref_env.env_radiance(scene.env, scene.sun_sky, False, 1.0, jnp.asarray(d), sun_disk=True)
    e_p = port_env.env_radiance(port.env, port.sun_sky, 1.0, _t(d), sun_disk=True)
    _close(e_p.numpy(), e_r, frac=0.99)
    assert np.asarray(e_r)[N // 2:].max() > 10 * np.asarray(e_r)[: N // 2].max()  # the disk
    p_r = ref_env.environment_pdf(scene.env, jnp.asarray(d), scene.sun_sky, True)
    p_p = port_env.environment_pdf(port.env, _t(d), port.sun_sky, True)
    _close(p_p.numpy(), p_r, frac=0.99)


def test_packed_env_tap_matches_plain_tap(scenes):
    """The packed-row env lookup the integrator uses reproduces the plain
    bilinear tap (``sample_env``), which matches the reference's."""
    from vk_raytrace_tpu.ops.texture import sample_env as ref_sample_env
    from vk_raytrace_torch.ops.texture import sample_env

    scene, port = scenes
    uv = np.random.default_rng(17).random((N, 2)).astype(np.float32)
    uv[:16, 1] = 0.0  # the clamped top edge
    plain = sample_env(port.env.image, _t(uv))
    _close(plain.numpy(), ref_sample_env(jnp.asarray(scene.env.image), jnp.asarray(uv)))
    h, w = port.env.image.shape[:2]
    packed = port_env._bilinear_packed(port.env.rows, h, w, _t(uv))
    np.testing.assert_allclose(packed.numpy(), plain.numpy(), rtol=1e-6, atol=1e-7)
