"""The port's BVH-free anchor (``integrator/brute.py``): the port's BVH
renders (planar rows, the traversal entries) against the same renders
through the port's ``BruteTracer``, under ``tests/test_anchor.py``'s
criterion (``brute.images_match``: at least 98.5% of pixels within 2% of
the mean, matched-set RMSE under 1%), on the configurations of
``tests/test_anchor.py``; then the port's ``BruteTracer`` hit for hit
against the reference's on the same rays.

Hit for hit: the same triangle wherever the nearest t is not tied (the
reference contracts multiply-adds into FMAs; two triangles of a quad meet
a ray on their shared edge at one t), t within rtol 1e-5 / atol 1e-5, and
u/v as in ``tests/test_torch_traverse.py``: rtol 1e-4 / atol 1e-5 on 98% of
the hits and atol 1e-3 on all (a small sphere triangle's determinant
magnifies the one-ulp difference; 1.5e-5 measured); occlusion equal
wherever the nearest occluder's t is farther than 1e-4 relative from
``t_max``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk_raytrace_tpu.integrator.brute import BruteTracer as RefBrute
from vk_raytrace_tpu.models import procedural as ref_proc
from vk_raytrace_tpu.render import build_scene as ref_build_scene
from vk_raytrace_torch import render as R
from vk_raytrace_torch.integrator import brute
from vk_raytrace_torch.integrator.camera import with_aspect
from vk_raytrace_torch.integrator.shade import mat_features
from vk_raytrace_torch.models import procedural
from vk_raytrace_torch.models.hdr import build_environment
from vk_raytrace_torch.models.schema import PBR_GLTF, RenderConfig
from vk_raytrace_torch.ops.bvh8 import build_accel_bundle
from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _scene(name):
    if name == "cornell":
        g, m, l, c = procedural.cornell_box()
        return R.build_scene(g, m, l, c)
    g, m, l, c = procedural.material_test_grid(n=2)
    return R.build_scene(g, m, l, c, env=build_environment(np.full((8, 16, 3), 0.8, np.float32)))


CASES = {
    "cornell": dict(width=64, height=64, max_depth=4, max_samples=2, pbr_mode=PBR_GLTF,
                    hdr_multiplier=0.0, rr=False),
    # The material grid at the default config: the Disney BSDF.
    "grid": dict(width=48, height=32, max_depth=3, max_samples=1, hdr_multiplier=1.0, rr=False),
    "cornell_compat": dict(width=40, height=40, max_depth=3, max_samples=2, pbr_mode=PBR_GLTF,
                           rr=False, full_mis=False, hdr_multiplier=0.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bvh_render_matches_brute(case):
    scene = _scene(case.split("_")[0])
    cfg = RenderConfig(**CASES[case])
    packed = build_accel_bundle(scene.geometry).to("cpu")
    features = mat_features(scene.materials)
    scene = dataclasses.replace(
        scene, camera=with_aspect(scene.camera, cfg.width, cfg.height)).to("cpu")
    img_bvh = brute.anchor_render(scene, packed, cfg, 2, features).numpy()
    img_brute = brute.anchor_render(scene, packed, cfg, 2, features,
                                    tracer=brute.BruteTracer(scene.geometry)).numpy()
    assert np.isfinite(img_bvh).all() and img_bvh.mean() > 0.0
    ok, share, rmse = brute.images_match(img_bvh, img_brute)
    assert ok, (share, rmse)


def _rays(geom, n, seed):
    """Rays from inside the scene's bounds toward random triangle centroids
    (plus random directions), t_max spread over the scene's size."""
    r = np.random.default_rng(seed)
    pos, idx = np.asarray(geom.positions), np.asarray(geom.indices)
    lo, hi = pos.min(0), pos.max(0)
    o = r.uniform(lo + 0.05 * (hi - lo), hi - 0.05 * (hi - lo), (n, 3))
    target = pos[idx[r.integers(0, len(idx), n)]].mean(1)
    d = np.where((r.random(n) < 0.8)[:, None], target - o, r.standard_normal((n, 3)))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = r.uniform(0.1, 1.5, n) * np.linalg.norm(hi - lo)
    return o.astype(np.float32), d.astype(np.float32), t_max.astype(np.float32)


@pytest.mark.parametrize("name", ["cornell", "grid"])
def test_brute_tracer_matches_reference(name):
    if name == "cornell":
        g, m, l, c = ref_proc.cornell_box()
    else:
        g, m, l, c = ref_proc.material_test_grid(n=2)
    ref_geom = ref_build_scene(g, m, l, c, binary_bvh=False).geometry
    port_geom = _scene(name).geometry.to("cpu")
    o, d, t_max = _rays(g, 256, 3)
    ref = RefBrute(ref_geom)
    port = brute.BruteTracer(port_geom, max_pairs=1 << 16)  # several chunks
    active = np.arange(len(o)) % 7 != 0
    hit_r, _ = ref.closest(jnp.asarray(o), jnp.asarray(d), None, jnp.asarray(active))
    hit_p, _ = port.closest(torch.from_numpy(o), torch.from_numpy(d), None, torch.from_numpy(active))
    tri_r, t_r = np.asarray(hit_r.tri), np.asarray(hit_r.t)
    tri_p, t_p = hit_p.tri.numpy(), hit_p.t.numpy()
    assert (tri_p >= 0).mean() > 0.5 and (tri_p[~active] == -1).all()
    np.testing.assert_allclose(t_p, t_r, rtol=1e-5, atol=1e-5)
    same = tri_p == tri_r
    # A differing triangle only at a tie: both triangles at the same t.
    assert np.allclose(t_p[~same], t_r[~same], rtol=1e-5) and same.mean() > 0.99
    hitm = same & (tri_p >= 0)
    for a, b in ((hit_p.u, hit_r.u), (hit_p.v, hit_r.v)):
        a, b = a.numpy()[hitm], np.asarray(b)[hitm]
        assert np.isclose(a, b, rtol=1e-4, atol=1e-5).mean() >= 0.98
        np.testing.assert_allclose(a, b, atol=1e-3)

    occ_r, _ = ref.occluded(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), None,
                            jnp.asarray(active))
    occ_p, _ = port.occluded(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max),
                             None, torch.from_numpy(active))
    occ_r, occ_p = np.asarray(occ_r), occ_p.numpy()
    # The nearest two-sided hit decides occlusion; ignore rays whose nearest
    # occluder sits within 1e-4 of t_max.
    ok, tt, _, _ = port._intersect(torch.from_numpy(o), torch.from_numpy(d), False)
    t_near = torch.where(ok, tt, brute.INF).amin(1).numpy()
    clear = np.abs(t_near - t_max) > 1e-4 * t_max
    assert occ_p.any() and (~occ_p & active).any()
    np.testing.assert_array_equal(occ_p[clear], occ_r[clear])
