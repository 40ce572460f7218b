"""The two-level slice end to end on the bistro street (BASELINE config #5
class): the port's scene build against the reference's, its counts, and
the port's ``Renderer(device="cpu")`` against the reference ``Renderer``.

The render runs ``bistro_scene(detail=0.05)`` at 64x36, depth 4, 1 spp,
glTF PBR, sun&sky, HDR multiplier 1, firefly clamp 10, ``full_mis=False``
(the configuration of ``scripts/baseline_configs.py``, cut in size), two
jittered frames, unfused and fused. Both renderers trace the same bytes
(``convert.from_reference`` of the reference's scene, sky bake and
instanced structure); the reference runs its fused path (``VKRT_FUSED=1``,
``VKRT_FUSED_SHADE=1`` for the fused stage, Pallas in interpret mode). The
thresholds of ``tests/test_torch_render.py``: >= 99% of pixels within rtol
1e-3 / atol 1e-4, ray counts within 0.1%.
"""

import numpy as np
import pytest

from test_torch_traverse import isolated_reference  # noqa: F401 (autouse)
from vk_raytrace_tpu import render as ref_render
from vk_raytrace_tpu.models import procedural as ref_proc
from vk_raytrace_tpu.models.schema import PBR_GLTF, RenderConfig as RefConfig
from vk_raytrace_torch import render as port_render
from vk_raytrace_torch.convert import from_reference
from vk_raytrace_torch.models import procedural as port_proc
from vk_raytrace_torch.models.schema import RenderConfig
from vk_raytrace_torch.ops.tlas import InstancedAccel

CFG = dict(width=64, height=36, max_depth=4, max_samples=1, pbr_mode=PBR_GLTF,
           use_sun_sky=True, hdr_multiplier=1.0, firefly_clamp=10.0, full_mis=False)


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), what


def _fields(x):
    return x._fields if hasattr(x, "_fields") else [f.name for f in x.__dataclass_fields__.values()]


def test_scene_tables_match_reference():
    """The port's bistro: pool, instances, materials, lights, camera, atlas,
    shade rows and tap rows byte-identical to the reference's."""
    ref = ref_proc.bistro_scene(detail=0.05)
    port = port_proc.bistro_scene(detail=0.05)
    for k in ("tri_start", "tri_count", "aabb_min", "aabb_max"):
        _same(getattr(port[0], k), getattr(ref[0], k), k)
    for part, (p, r) in {"geometry": (port[0].geometry, ref[0].geometry), "instances": (port[1], ref[1]),
                         "materials": (port[2], ref[2]), "lights": (port[3], ref[3]),
                         "camera": (port[4], ref[4]), "atlas": (port[5], ref[5])}.items():
        for f in _fields(p):
            if getattr(r, f, None) is not None:
                _same(getattr(p, f), getattr(r, f), f"{part}.{f}")
    rs = ref_render.build_instanced_scene(*ref[:5], atlas=ref[5])
    ps = port_render.build_instanced_scene(*port[:5], atlas=port[5])
    _same(ps.shade_rows, rs.shade_rows, "shade_rows")
    _same(ps.tap_rows, rs.tap_rows, "tap_rows")
    assert isinstance(ps.instances, InstancedAccel)
    _same(ps.instances.blas_planar.rows, rs.instances.blas_planar.rows, "blas rows")


def test_counts_and_dedup():
    """The full scene: >1M instantiated triangles from a pool holding less
    than 60% of them, with alpha-cutout foliage."""
    pool, inst, *_ = port_proc.bistro_scene(detail=1.0)
    total = int(np.asarray(pool.tri_count)[np.asarray(inst.mesh_id)].sum())
    unique = int(pool.geometry.indices.shape[0])
    assert total > 1_000_000, total
    assert unique < 0.6 * total
    assert bool(np.any(np.asarray(pool.geometry.tri_flags) & 2))


def test_baked_equals_instanced_geometry():
    pool, inst, *_ = port_proc.bistro_scene(detail=0.05)
    baked, *_ = port_proc.bistro_scene(detail=0.05, instanced=False)
    ref_baked, *_ = ref_proc.bistro_scene(detail=0.05, instanced=False)
    assert int(np.asarray(pool.tri_count)[np.asarray(inst.mesh_id)].sum()) == len(baked.indices)
    for f in _fields(baked):
        _same(getattr(baked, f), getattr(ref_baked, f), f)


@pytest.mark.parametrize("fused", [False, True])
def test_renderer_matches_reference(monkeypatch, fused):
    """Both renderers start at frame 1 (jittered; frame 0's pixel-centre
    rays land on shared edges, where an ulp picks the triangle)."""
    monkeypatch.setenv("VKRT_FUSED", "1")
    if fused:
        monkeypatch.setenv("VKRT_FUSED_SHADE", "1")
    pool, inst, mats, lights, cam, atlas = ref_proc.bistro_scene(detail=0.05)
    ref = ref_render.Renderer(
        ref_render.build_instanced_scene(pool, inst, mats, lights, cam, atlas=atlas),
        RefConfig(**CFG),
    )
    scene, acc = from_reference(ref.scene, ref.packed)
    assert isinstance(acc, InstancedAccel) and acc.blas_planar_alp is not None
    # The reference renderer already swapped its sky bake in for use_sun_sky.
    port = port_render.Renderer(
        scene, RenderConfig(**{**CFG, "use_sun_sky": False, "sun_disk": True}), device="cpu",
        packed=acc, fused_shade=fused,
    )
    assert port.alpha_pack is not None
    imgs, rays = [], []
    for r in (ref, port):
        r.frame = 1
        rays.append([])
        for _ in range(2):
            r.step()
            rays[-1].append(r.last_rays)
        imgs.append(np.asarray(r.accum if r is ref else r.accum.numpy()))
    ref_img, img = imgs
    assert np.isfinite(img).all() and img.mean() > 0.0
    share = np.isclose(img, ref_img, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert share >= 0.99, share
    for r, p in zip(*rays):
        assert abs(p - r) <= 1e-3 * r, rays
    assert min(rays[1]) > CFG["width"] * CFG["height"]
