"""Width-32 planar rows (1024 B, 16-triangle leaves) of the port against the
reference's ``VKRT_WIDE=32`` builds: the native builder, the city scene,
the kernel's plain twin (the reference's kernel in Pallas interpret mode on
the CPU), and the child order against the reference's bitonic network.
The alpha rounds, the two-level path and the render slices at width 32 are
in ``tests/test_torch_width32_{alpha,instanced,alpha_pass,render}.py``,
which share this module's scenes.

The reference picks the width from ``VKRT_WIDE`` when it builds; the port
takes ``width=32``. Builds, scenes and sorted keys must be exact. Hits use
the tie-aware compare and tolerances of ``tests/test_torch_traverse.py``
(t rtol 1e-5 / atol 1e-6; a differing triangle only where t ties).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_traverse import N_RAYS, _check_hits, _close_bary, _rays, _t
from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401 (fixtures)
from vk_raytrace_tpu import render as ref_render
from vk_raytrace_tpu import runtime as ref_runtime
from vk_raytrace_tpu.models import procedural as ref_proc
from vk_raytrace_tpu.ops import bvh8 as ref_bvh8
from vk_raytrace_tpu.ops import traverse_fused as ref_tf
from vk_raytrace_torch import runtime as port_runtime
from vk_raytrace_torch.convert import from_reference
from vk_raytrace_torch.models import procedural as port_proc
from vk_raytrace_torch.ops import traverse_fused as port_tf
from vk_raytrace_torch.ops.bvh8 import build_accel_bundle

pytestmark = pytest.mark.usefixtures("one_torch_thread")

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
