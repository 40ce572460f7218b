"""Width-32 planar rows (1024 B, 16-triangle leaves) of the port against the
reference's ``VKRT_WIDE=32`` builds, kernel (Pallas, interpret mode on the
CPU), alpha rounds, two-level path and renderer; the city scene; and the
child order against the reference's bitonic network.

The reference picks the width from ``VKRT_WIDE`` when it builds; the port
takes ``width=32``. Builds, scenes and sorted keys must be exact. Hits use
the tie-aware compare and tolerances of ``tests/test_torch_traverse.py``
(t rtol 1e-5 / atol 1e-6; a differing triangle only where t ties), the
two-level ones those of ``tests/test_torch_instancing.py``, and the render
slices the thresholds of ``tests/test_torch_render.py``: >= 99% of pixels
within rtol 1e-3 / atol 1e-4, ray counts within 0.1%.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_instancing import _alpha_pass_case, _case, _check_alpha_outcome, _check_alpha_pass
from test_torch_instancing import _check_closest, _port_pool, _sphere_box, _trace
from test_torch_instancing import _rays as _inst_rays
from test_torch_traverse import N_RAYS, _banner_rays, _check_hits, _close_bary, _rays, _t
from test_torch_traverse import isolated_reference  # noqa: F401 (autouse)
from vk_raytrace_tpu import render as ref_render
from vk_raytrace_tpu import runtime as ref_runtime
from vk_raytrace_tpu.models import procedural as ref_proc
from vk_raytrace_tpu.models.schema import PBR_GLTF, RenderConfig as RefConfig
from vk_raytrace_tpu.ops import bvh8 as ref_bvh8
from vk_raytrace_tpu.ops import tlas as ref_tlas
from vk_raytrace_tpu.ops import traverse_fused as ref_tf
from vk_raytrace_tpu.ops import traverse_wide as ref_tw
from vk_raytrace_tpu.ops.traverse import AlphaCtx as RefAlphaCtx
from vk_raytrace_torch import render as port_render
from vk_raytrace_torch import runtime as port_runtime
from vk_raytrace_torch.convert import _conv, from_reference
from vk_raytrace_torch.models import procedural as port_proc
from vk_raytrace_torch.models.instances import InstanceTable
from vk_raytrace_torch.models.schema import RenderConfig
from vk_raytrace_torch.ops import tlas
from vk_raytrace_torch.ops import traverse_fused as port_tf
from vk_raytrace_torch.ops import traverse_wide as port_tw
from vk_raytrace_torch.ops.bvh8 import build_accel_bundle
from vk_raytrace_torch.ops.traverse_wide import make_alpha_pack

SMALL_ATRIUM = dict(bays_x=2, bays_z=2, column_segments=16, column_rows=12)


def _scene(name):
    if name == "atrium":
        return ref_proc.atrium_scene(**SMALL_ATRIUM)
    return ref_proc.city_scene(n_blocks=6)


def _ref_bundle32(geom):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VKRT_WIDE", "32")
        return ref_bvh8.build_accel_bundle(geom)


@pytest.fixture(scope="module", params=["atrium", "city"])
def scene32(request):
    """(reference SceneData, its W=32 bundle, the port's copies on the CPU)."""
    g, m, l, c, *a = _scene(request.param)
    scene = ref_render.build_scene(g, m, l, c, atlas=a[0] if a else None)
    packed = _ref_bundle32(g)
    assert packed.opaque_planar.width == 32 and packed.alpha_planar.width == 32
    port_scene, bundle = from_reference(scene, packed)
    return request.param, scene, packed, port_scene.to("cpu"), bundle.to("cpu")


@pytest.mark.parametrize("name", ["atrium", "city"])
def test_build_bvh32_matches_reference(name):
    """The port's native W=32 rows and stack bounds equal the reference's,
    bit for bit: the whole scene, and the opaque and alpha trees."""
    g = _scene(name)[0]
    args = (np.asarray(g.positions), np.asarray(g.indices), np.asarray(g.uv),
            np.asarray(g.tri_flags))
    ref_rows, ref_depth = ref_runtime.build_planar_rows(*args, width=32)
    rows, depth = port_runtime.build_planar_rows(*args, width=32)
    assert rows.shape == (len(ref_rows), 256) and depth == ref_depth
    assert np.array_equal(rows, ref_rows)
    ref_b = _ref_bundle32(g)
    port_b = build_accel_bundle(g, width=32)
    for f in ("opaque_planar", "alpha_planar"):
        r, p = getattr(ref_b, f), getattr(port_b, f)
        assert (p.width, p.stack_depth) == (32, r.stack_depth), f
        assert np.array_equal(p.rows, np.asarray(r.rows)), f
        assert p.stack_depth <= 128  # the kernel's deepest stack


def test_width_is_16_or_32():
    g = _scene("city")[0]
    with pytest.raises(ValueError):
        port_runtime.build_planar_rows(np.asarray(g.positions), np.asarray(g.indices),
                                       np.asarray(g.uv), np.asarray(g.tri_flags), width=8)


@pytest.mark.parametrize("n_blocks", [6, 24])
def test_city_scene_matches_reference(n_blocks):
    """The port's city: same RNG draws, so every table is byte-identical."""
    ref = ref_proc.city_scene(n_blocks=n_blocks)
    port = port_proc.city_scene(n_blocks=n_blocks)
    for part, p, r in zip(("geometry", "materials", "lights", "camera"), port, ref):
        fields = r._fields if hasattr(r, "_fields") else [f.name for f in dataclasses.fields(r)]
        for f in fields:
            a, b = getattr(r, f), getattr(p, f)
            if a is None:
                assert b is None, f"{part}.{f}"
                continue
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b), f"{part}.{f}"
    assert bool(np.any(np.asarray(port[0].tri_flags) & 2))  # the alpha panels


@pytest.mark.parametrize("mode,cull", [("closest", True), ("any", False),
                                       ("candidate", True), ("candidate", False)])
def test_twin_w32_matches_reference_kernel(scene32, mode, cull):
    name, scene, packed, _, bundle = scene32
    geom = scene.geometry
    rng = np.random.default_rng(31)
    if mode == "closest":
        o, d = _rays(11, geom)
        ref = ref_tf.closest_hit_fused(packed.opaque_planar, jnp.asarray(o), jnp.asarray(d))
        hit = port_tf.closest_hit_fused(bundle.opaque_planar, _t(o), _t(d))
        _check_hits(hit.tri.numpy(), hit.t.numpy(), hit.u.numpy(), hit.v.numpy(),
                    ref.tri, ref.t, ref.u, ref.v)
    elif mode == "any":
        o, d = _rays(12, geom)
        t_max = rng.uniform(0.5, 8.0, N_RAYS).astype(np.float32)
        active = rng.random(N_RAYS) < 0.9
        ref = ref_tf.any_hit_fused(packed.opaque_planar, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(t_max), active=jnp.asarray(active))
        occ = port_tf.any_hit_fused(bundle.opaque_planar, _t(o), _t(d), _t(t_max),
                                    active=_t(active))
        np.testing.assert_array_equal(occ.numpy(), np.asarray(ref))
        assert 0.05 < occ.numpy().mean() < 0.95
    else:
        o, d = _rays(13, geom, toward_alpha=True)
        t_max = np.full(N_RAYS, 1e32, np.float32)
        ref, ref_uvu, ref_uvv = ref_tf._traverse_fused(
            packed.alpha_planar, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
            cull_backface=cull, any_hit_mode=False, active_in=None,
            return_uvt=True, phase_compact=False,
        )
        hit, uvu, uvv = port_tf.candidate_hit_fused(bundle.alpha_planar, _t(o), _t(d),
                                                    _t(t_max), cull=cull)
        _check_hits(hit.tri.numpy(), hit.t.numpy(), hit.u.numpy(), hit.v.numpy(),
                    ref.tri, ref.t, ref.u, ref.v)
        same = hit.tri.numpy() == np.asarray(ref.tri)
        _close_bary(uvu.numpy()[same], np.asarray(ref_uvu)[same])
        _close_bary(uvv.numpy()[same], np.asarray(ref_uvv)[same])


def test_alpha_rounds_w32_match_reference(scene32):
    """Opaque hit, then the alpha rounds in front of it (``closest_hit_bundle``),
    with the same seeds: accept masks and seeds exact."""
    name, scene, packed, port_scene, bundle = scene32
    o, d = _banner_rays(14, scene.geometry)
    seed = np.random.default_rng(15).integers(0, 2**32, N_RAYS, dtype=np.uint64).astype(np.uint32)
    ctx = RefAlphaCtx(materials=scene.materials, atlas=scene.atlas)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VKRT_FUSED", "1")
        ref, ref_seed = ref_tw.closest_hit_bundle(
            packed, jnp.asarray(scene.geometry.tri_material), jnp.asarray(o), jnp.asarray(d),
            seed=jnp.asarray(seed), alpha_ctx=ctx,
        )
    pack = make_alpha_pack(port_scene.materials, port_scene.atlas, port_scene.geometry.tri_material)
    hit, out_seed = port_tw.closest_hit_bundle(bundle, pack, _t(o), _t(d),
                                               _t(seed.astype(np.int64)))
    np.testing.assert_array_equal(out_seed.numpy().astype(np.uint32), np.asarray(ref_seed))
    _check_hits(hit.tri.numpy(), hit.t.numpy(), hit.u.numpy(), hit.v.numpy(),
                ref.tri, ref.t, ref.u, ref.v)
    alpha = (np.asarray(scene.geometry.tri_flags) & 2) != 0
    on_alpha = alpha[np.maximum(hit.tri.numpy(), 0)] & (hit.tri.numpy() >= 0)
    assert on_alpha.any() and (out_seed.numpy().astype(np.uint32) != seed).any()


# ---------------------------------------------------------------------------
# Two-level scenes at width 32
# ---------------------------------------------------------------------------


def _ref_case32(pool, inst, mats, atlas):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VKRT_WIDE", "32")
        case = _case(pool, inst, mats, atlas)
    assert case.acc.blas_planar.width == 32
    return case


@pytest.mark.parametrize("name", ["sphere_box", "bistro"])
def test_instanced_w32_build_matches_reference(name):
    """``build_instanced_accel(width=32)``: every planar table and root
    table equals the reference's ``VKRT_WIDE=32`` build (leaf-ref fixup
    ``(width/2) * base``)."""
    if name == "bistro":
        pool, inst, *_ = ref_proc.bistro_scene(detail=0.05)
    else:
        pool, inst = _sphere_box()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VKRT_WIDE", "32")
        ref = ref_tlas.build_instanced_accel(pool, inst)
    acc = tlas.build_instanced_accel(_port_pool(pool), _conv(InstanceTable, inst), width=32)
    for f in ("blas_planar", "blas_planar_opq", "blas_planar_alp"):
        r, p = getattr(ref, f), getattr(acc, f)
        assert (r is None) == (p is None), f
        if p is not None:
            assert (p.width, p.stack_depth) == (32, r.stack_depth), f
            assert np.array_equal(p.rows, np.asarray(r.rows)), f
    for f in ("mesh_root_planar", "mesh_root_opq", "mesh_root_alp"):
        r, p = getattr(ref, f), getattr(acc, f)
        assert (r is None) == (p is None) and (p is None or np.array_equal(p, np.asarray(r))), f


def test_instanced_w32_hits_equal_w16():
    """The analog of the reference's width-32 instancing gate: a multi-mesh
    pool gives the same hits at both widths."""
    pool, inst = _sphere_box()
    pool, inst = _port_pool(pool), _conv(InstanceTable, inst)
    o, d, _ = _inst_rays(21, 1024, [-6, 2.5, -6], [6, 8, 6])
    target = np.random.default_rng(22).uniform([-4, 0, -3], [4, 1.5, 3], (1024, 3))
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hits = {}
    for w in (16, 32):
        acc = tlas.build_instanced_accel(pool, inst, width=w).to("cpu")
        assert acc.blas_planar.width == w
        hits[w], _ = tlas.closest_hit_instanced(acc, None, torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_array_equal(hits[16].tri.numpy(), hits[32].tri.numpy())
    np.testing.assert_array_equal(hits[16].inst.numpy(), hits[32].inst.numpy())
    np.testing.assert_allclose(hits[16].t.numpy(), hits[32].t.numpy(), rtol=1e-6)
    assert (hits[32].tri.numpy() >= 0).mean() > 0.3


@pytest.mark.parametrize("alpha", [False, True])
def test_bistro_w32_hits_match_reference(alpha):
    """The small bistro at width 32, closest hit through the opaque rounds
    and the alpha machine, against the reference's ``VKRT_WIDE=32`` path
    with the same seeds."""
    pool, inst, mats, _, _, atlas = ref_proc.bistro_scene(detail=0.05)
    case = _ref_case32(pool, inst, mats, atlas)
    o, d, s = _inst_rays(31 + alpha, 320, [-50, 0.5, -10], [50, 8, 10])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VKRT_FUSED", "1")
        rh, rs, ph, ps = _trace(case, o, d, s, alpha, any_hit=False)
    _check_closest(rh, ph)
    np.testing.assert_array_equal(ps, rs)


@pytest.mark.parametrize("scene", ["bistro", "stack0", "stack05"])
@pytest.mark.parametrize("kind", ["closest", "any"])
def test_alpha_pass_w32_matches_reference(scene, kind):
    """The alpha pass alone at width 32 against the reference's
    ``VKRT_WIDE=32`` machine (``tests/test_torch_instancing.py``'s cases:
    the small bistro toward its foliage, the panel stack at the round cap)."""
    port = _check_alpha_pass(*_alpha_pass_case(scene, 32, kind), kind)
    _check_alpha_outcome(scene, port)


# ---------------------------------------------------------------------------
# Render slices at width 32
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# The child order against the reference's bitonic network
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [16, 32])
def test_sort_children_matches_reference_bitonic(width):
    """``sort_children``'s plain version against ``_bitonic`` (Pallas,
    interpret mode) on keys with ties and misses: keys equal; refs equal
    wherever a key is unique in its row (the bitonic network is not stable)."""
    from jax.experimental import pallas as pl

    rng = np.random.default_rng(40 + width)
    b = 256
    keys = rng.standard_normal((b, width)).astype(np.float32)
    ties = rng.random((b, width)) < 0.3
    keys[ties] = np.round(keys[ties])
    keys[rng.random((b, width)) < 0.3] = port_tf.INF
    refs = rng.permutation(b * width).reshape(b, width).astype(np.int32)

    def kern(k_ref, r_ref, ok_ref, or_ref):
        sub = jax.lax.broadcasted_iota(jnp.int32, k_ref.shape, 0)
        k, r = ref_tf._bitonic(k_ref[:], r_ref[:], sub, width)
        ok_ref[:] = k
        or_ref[:] = r

    shape = jax.ShapeDtypeStruct((width, b), jnp.float32)
    ks, rs = pl.pallas_call(kern, out_shape=[shape, shape], interpret=True)(
        jnp.asarray(keys.T), jnp.asarray(refs.T.astype(np.float32)))
    ref_k, ref_r = np.asarray(ks).T, np.asarray(rs).T.astype(np.int32)
    sk, sr, cnt = port_tf.sort_children(torch.from_numpy(keys), torch.from_numpy(refs))
    np.testing.assert_array_equal(sk.numpy(), ref_k)
    # Where a key occurs once in its row, its ref is the reference's.
    once = np.array([[np.count_nonzero(row == k) == 1 for k in row] for row in ref_k])
    assert once.any() and (~once).any()
    np.testing.assert_array_equal(sr.numpy()[once], ref_r[once])
    # Every row's refs are a permutation that carries each key.
    np.testing.assert_array_equal(np.take_along_axis(keys, np.argsort(keys, 1, kind="stable"), 1),
                                  sk.numpy())
    np.testing.assert_array_equal(cnt.numpy(), (keys < port_tf.INF).sum(1))
    for i in range(b):
        assert dict(zip(sr.numpy()[i], sk.numpy()[i])) == dict(zip(refs[i], keys[i]))
