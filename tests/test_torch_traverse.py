"""Traversal modes a/b/c of the port against the reference's Pallas step
kernel (interpret mode on the CPU), on the reduced atrium, 257 rays.

Tolerances: t rtol 1e-5 / atol 1e-6, as in ``tests/test_fused.py``.
``tri`` must be equal wherever the nearest t is not tied; a differing
``tri`` is allowed only where both sides report the same t (two triangles
at one distance: the reference's bitonic child sort is not stable). u/v:
rtol 1e-4 / atol 1e-5 (``tests/test_fused.py``) on 98% of the hits and
atol 1e-3 on all: XLA on the CPU contracts multiply-adds into FMAs while
torch rounds every operation, and a grazing hit (small determinant)
magnifies that one-ulp difference in the barycentric numerators (2.5e-4
observed). The any-hit mask, and the alpha rounds' accept mask and seeds,
must be exact; those rays meet the banners head-on, where the texel a
candidate's uv falls in does not hang on the last ulp.

:func:`isolated_reference` (module-scoped, autouse) is imported by every
port test module that builds reference bundles or renderers: it keeps the
reference's scene cache inside pytest's per-run temp directory and makes
sure the reference's native builder is loaded.
"""

import fcntl
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vk_raytrace_tpu import render as ref_render
from vk_raytrace_tpu.models import procedural as ref_proc
from vk_raytrace_tpu.ops import bvh8 as ref_bvh8
from vk_raytrace_tpu.ops import traverse_alpha as ref_alpha
from vk_raytrace_tpu.ops import traverse_fused as ref_tf
from vk_raytrace_tpu.ops.traverse import AlphaCtx as RefAlphaCtx
from vk_raytrace_torch.convert import from_reference
from vk_raytrace_torch.ops import traverse_alpha as port_alpha
from vk_raytrace_torch.ops import traverse_fused as port_tf
from vk_raytrace_torch.ops.traverse_wide import make_alpha_pack

N_RAYS = 257  # odd: exercises the reference's block padding
RTOL, ATOL = 1e-5, 1e-6


def _load_reference_native(lock_path) -> bool:
    """Load the reference's native library once, under a lock that every
    xdist worker of the run shares. Each process that finds the library
    missing compiles it into the same temporary file, and a process that
    loses that race marks the library unavailable for good; so a failed
    first try resets that mark and tries once more under the lock."""
    from vk_raytrace_tpu import runtime as ref_runtime

    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not ref_runtime.available():
                ref_runtime._lib = None
            return ref_runtime.available()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


@pytest.fixture(scope="module")
def one_torch_thread():
    """The module's torch CPU work on one intra-op thread (modules opt in
    with ``pytestmark = pytest.mark.usefixtures("one_torch_thread")``).
    Tier-1 runs six xdist workers on the machine's cores at once, and
    torch's default of a thread per core makes each parallel op wait for
    descheduled threads: ``tests/test_torch_golden.py`` took 12 s alone and
    420 s beside five other port modules."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def isolated_reference(tmp_path_factory):
    """The reference's scene cache lies in pytest's per-run temp directory
    while a port test module runs, so no entry of the shared
    ``~/.cache/vkrt_scene`` is read; and the reference's native builder is
    loaded, without which the reference falls back without a word to its
    8-wide LBVH, whatever width was asked for. The port's own scene cache
    (``VKRT_TORCH_SCENE_CACHE``) lies beside it. Yields the reference's
    cache directory."""
    base = tmp_path_factory.getbasetemp()
    assert _load_reference_native(base.parent / "vkrt_native_build.lock"), (
        "the reference's native library (vk_raytrace_tpu/runtime/_native.so) did not load: "
        "its accel builds would fall back to the 8-wide LBVH"
    )
    cache = base / "vkrt_scene"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VKRT_SCENE_CACHE", str(cache))
        mp.setenv("VKRT_TORCH_SCENE_CACHE", str(base / "vkrt_torch_scene"))
        yield cache


@pytest.fixture(scope="module")
def atrium():
    g, m, l, c, a = ref_proc.atrium_scene(bays_x=2, bays_z=2, column_segments=16, column_rows=12)
    scene = ref_render.build_scene(g, m, l, c, atlas=a)
    packed = ref_bvh8.build_accel_bundle(g)
    port_scene, bundle = from_reference(scene, packed)
    return scene, packed, port_scene.to("cpu"), bundle.to("cpu")


def _rays(seed, geom, n=N_RAYS, toward_alpha=False):
    """Origins inside the atrium's bounds; directions random, or aimed at
    random alpha-flagged triangles."""
    rng = np.random.default_rng(seed)
    pos = np.asarray(geom.positions)
    lo, hi = pos.min(0), pos.max(0)
    o = rng.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo), (n, 3)).astype(np.float32)
    if toward_alpha:
        ids = np.where(np.asarray(geom.tri_flags) & 2)[0]
        tri = np.asarray(geom.indices)[rng.choice(ids, n)]
        w = rng.dirichlet(np.ones(3), n)
        target = np.einsum("rk,rkc->rc", w, pos[tri])
        d = target - o
    else:
        d = rng.standard_normal((n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def _banner_rays(seed, geom, n=N_RAYS):
    """Rays that meet alpha-flagged triangles head-on: from 1-6 units in
    front of (or behind) a random point of a random banner triangle."""
    rng = np.random.default_rng(seed)
    pos = np.asarray(geom.positions)
    ids = np.where(np.asarray(geom.tri_flags) & 2)[0]
    p = pos[np.asarray(geom.indices)[rng.choice(ids, n)]]
    target = np.einsum("rk,rkc->rc", rng.dirichlet(np.ones(3), n), p)
    nrm = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    side = np.where(rng.random(n) < 0.5, -1.0, 1.0)[:, None]
    o = target + nrm * side * rng.uniform(1.0, 6.0, (n, 1)) + rng.normal(0, 0.3, (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_bary(out, ref):
    ok = np.isclose(out, ref, rtol=1e-4, atol=1e-5)
    assert ok.mean() >= 0.98, ok.mean()
    np.testing.assert_allclose(out, ref, atol=1e-3)


def _check_hits(tri, t, u, v, ref_tri, ref_t, ref_u, ref_v):
    ref_tri, ref_t = np.asarray(ref_tri), np.asarray(ref_t)
    diff = tri != ref_tri
    assert diff.mean() < 0.02, diff.mean()
    np.testing.assert_allclose(t[diff], ref_t[diff], rtol=RTOL, atol=ATOL)  # ties only
    np.testing.assert_allclose(t, ref_t, rtol=RTOL, atol=ATOL)
    same = ~diff & (ref_tri >= 0)
    _close_bary(u[same], np.asarray(ref_u)[same])
    _close_bary(v[same], np.asarray(ref_v)[same])
    assert (ref_tri >= 0).mean() > 0.5  # the rays do hit the scene


def test_closest_hit_matches_reference_kernel(atrium):
    scene, packed, _, bundle = atrium
    o, d = _rays(1, scene.geometry)
    ref = ref_tf.closest_hit_fused(packed.opaque_planar, jnp.asarray(o), jnp.asarray(d))
    hit = port_tf.closest_hit_fused(bundle.opaque_planar, _t(o), _t(d))
    _check_hits(hit.tri.numpy(), hit.t.numpy(), hit.u.numpy(), hit.v.numpy(),
                ref.tri, ref.t, ref.u, ref.v)


def test_plain_twin_marks_the_rows_it_visits(atrium):
    """The twin's record of visited rows, which sets the traversal kernel's
    byte bound in ``chip_smoke.py``: a ray visits each row of the tree at
    most once, so one ray marks as many rows as it takes steps, and a batch
    marks the union of its rays' rows."""
    scene, _, _, bundle = atrium
    planar = bundle.opaque_planar
    n = 8
    o, d = _rays(4, scene.geometry, n=n)
    t_max = torch.full((n,), port_tf.INF)
    union = torch.zeros(planar.rows.shape[0], dtype=torch.int8)
    for i in range(n):
        seen = torch.zeros_like(union)
        out = port_tf._traverse_plain(planar, _t(o[i:i + 1]), _t(d[i:i + 1]), t_max[:1], None,
                                      "closest", True, seen)
        assert int((seen != 0).sum()) == int(out[4][0])
        union = torch.maximum(union, seen)
    seen = torch.zeros_like(union)
    port_tf._traverse_plain(planar, _t(o), _t(d), t_max, None, "closest", True, seen)
    assert torch.equal(seen, union)
    assert int((seen == 1).sum()) > 0 and int((seen == 2).sum()) > 0


def test_any_hit_matches_reference_kernel(atrium):
    scene, packed, _, bundle = atrium
    o, d = _rays(2, scene.geometry)
    t_max = np.random.default_rng(3).uniform(0.5, 8.0, N_RAYS).astype(np.float32)
    active = np.random.default_rng(4).random(N_RAYS) < 0.9
    ref = ref_tf.any_hit_fused(packed.opaque_planar, jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(t_max), active=jnp.asarray(active))
    occ = port_tf.any_hit_fused(bundle.opaque_planar, _t(o), _t(d), _t(t_max), active=_t(active))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(ref))
    assert 0.05 < occ.numpy().mean() < 0.95


@pytest.fixture(scope="module")
def banner_atrium():
    g, m, l, c, a = ref_proc.atrium_scene(bays_x=3, bays_z=2, column_segments=16, column_rows=12)
    scene = ref_render.build_scene(g, m, l, c, atlas=a)
    packed = ref_bvh8.build_accel_bundle(g)
    assert packed.alpha_planar is not None
    port_scene, bundle = from_reference(scene, packed)
    return scene, packed, port_scene.to("cpu"), bundle.to("cpu")


@pytest.mark.parametrize("cull", [True, False])
def test_candidate_mode_matches_reference_kernel(banner_atrium, cull):
    scene, packed, _, bundle = banner_atrium
    o, d = _rays(5, scene.geometry, toward_alpha=True)
    t_max = np.full(N_RAYS, 1e32, np.float32)
    ref, ref_uvu, ref_uvv = ref_tf._traverse_fused(
        packed.alpha_planar, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
        cull_backface=cull, any_hit_mode=False, active_in=None,
        return_uvt=True, phase_compact=False,
    )
    hit, uvu, uvv = port_tf.candidate_hit_fused(bundle.alpha_planar, _t(o), _t(d), _t(t_max), cull=cull)
    _check_hits(hit.tri.numpy(), hit.t.numpy(), hit.u.numpy(), hit.v.numpy(),
                ref.tri, ref.t, ref.u, ref.v)
    same = hit.tri.numpy() == np.asarray(ref.tri)
    _close_bary(uvu.numpy()[same], np.asarray(ref_uvu)[same])
    _close_bary(uvv.numpy()[same], np.asarray(ref_uvv)[same])


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_alpha_rounds_match_reference(banner_atrium, kind):
    scene, packed, port_scene, bundle = banner_atrium
    o, d = _banner_rays(6, scene.geometry)
    rng = np.random.default_rng(7)
    t_limit = rng.uniform(5.0, 30.0, N_RAYS).astype(np.float32)
    seed = rng.integers(0, 2**32, N_RAYS, dtype=np.uint64).astype(np.uint32)
    active = rng.random(N_RAYS) < 0.95
    ctx = RefAlphaCtx(materials=scene.materials, atlas=scene.atlas)
    pack = make_alpha_pack(port_scene.materials, port_scene.atlas, port_scene.geometry.tri_material)
    ref_fn = ref_alpha.closest_hit_alpha if kind == "closest" else ref_alpha.any_hit_alpha
    port_fn = port_alpha.closest_hit_alpha if kind == "closest" else port_alpha.any_hit_alpha
    ref_out, ref_seed = ref_fn(
        packed.alpha_planar, ctx, scene.geometry.tri_material, jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(t_limit), seed=jnp.asarray(seed), active=jnp.asarray(active),
    )
    out, out_seed = port_fn(
        bundle.alpha_planar, pack, _t(o), _t(d), _t(t_limit),
        seed=_t(seed.astype(np.int64)), active=_t(active),
    )
    np.testing.assert_array_equal(out_seed.numpy().astype(np.uint32), np.asarray(ref_seed))
    if kind == "any":
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))
        accepted = out.numpy()
    else:
        accepted = out.tri.numpy() >= 0
        np.testing.assert_array_equal(accepted, np.asarray(ref_out.tri) >= 0)
        np.testing.assert_allclose(out.t.numpy(), np.asarray(ref_out.t), rtol=RTOL, atol=ATOL)
    # Some candidates pass and some are rejected: the test is not vacuous.
    assert 0.05 < accepted.mean() < 0.95
    assert (out_seed.numpy().astype(np.uint32) != seed).any()


@pytest.mark.parametrize("mode,cull", [("closest", False), ("any", True), ("wide", True)])
def test_traverse_rejects_mode_cull_pairs_the_kernel_lacks(atrium, mode, cull):
    """Closest hit always culls and any hit never does, on both devices."""
    _, _, _, bundle = atrium
    o, d = _rays(9, atrium[0].geometry, n=8)
    with pytest.raises(ValueError):
        port_tf.traverse(bundle.opaque_planar, _t(o), _t(d), _t(np.ones(8, np.float32)),
                         mode=mode, cull=cull)


def test_cuda_kernel_matches_twin(atrium):
    """Kernel against the plain twin on the card (skips without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    scene, _, _, bundle = atrium
    o, d = _rays(8, scene.geometry, n=4099)
    t_max = np.full(4099, 1e32, np.float32)
    twin = port_tf.traverse(bundle.opaque_planar, _t(o), _t(d), _t(t_max), mode="closest")
    dev = bundle.to("cuda")
    kern = port_tf.traverse(dev.opaque_planar, _t(o).cuda(), _t(d).cuda(), _t(t_max).cuda(), mode="closest")
    np.testing.assert_array_equal(kern[1].cpu().numpy(), twin[1].numpy())
    np.testing.assert_allclose(kern[0].cpu().numpy(), twin[0].numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(kern[4].cpu().numpy(), twin[4].numpy())


# ---------------------------------------------------------------------------
# The reference's scene cache stays out of the port's tests
# ---------------------------------------------------------------------------


def test_reference_cache_lies_in_the_run_temp_dir(isolated_reference, tmp_path_factory):
    cache = os.environ["VKRT_SCENE_CACHE"]
    assert cache == str(isolated_reference)
    assert isolated_reference.is_relative_to(tmp_path_factory.getbasetemp())
    from vk_raytrace_tpu import runtime as ref_runtime

    assert ref_runtime.available()


def test_planted_shared_cache_entry_is_never_read(isolated_reference, tmp_path, monkeypatch):
    """A width-8 bundle (the reference's LBVH fallback) planted in a fake
    ``~/.cache/vkrt_scene`` under the key of a width-32 build: read where
    the cache is left at its default, never under the fixture."""
    from vk_raytrace_tpu import runtime as ref_runtime
    from vk_raytrace_tpu.utils import cache as ref_cache

    geom = ref_proc.city_scene(n_blocks=6)[0]
    monkeypatch.setenv("VKRT_WIDE", "32")
    # The key of this geometry's width-32 bundle: the one entry a build writes.
    probe = tmp_path / "probe"
    monkeypatch.setenv("VKRT_SCENE_CACHE", str(probe))
    assert ref_bvh8.build_accel_bundle(geom).opaque_planar.width == 32
    (entry,) = os.listdir(probe)
    # The fallback's bundle, as a process without the native library stores it.
    home = tmp_path / "home"
    shared = home / ".cache" / "vkrt_scene"
    with monkeypatch.context() as mp:
        mp.setattr(ref_runtime, "_lib", False)
        poisoned = ref_bvh8._build_accel_bundle_impl(geom)
        mp.setenv("VKRT_SCENE_CACHE", str(shared))
        ref_bvh8._bundle_to_cache(entry[:-len(".npz")], poisoned, ref_cache)
    planted = (shared / entry).read_bytes()
    with np.load(shared / entry) as z:
        assert int(z["planar_width"]) == 8
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.delenv("VKRT_SCENE_CACHE")
    assert ref_bvh8.build_accel_bundle(geom).opaque_planar.width == 8  # the plant bites
    monkeypatch.setenv("VKRT_SCENE_CACHE", str(isolated_reference))
    b = ref_bvh8.build_accel_bundle(geom)
    assert b.opaque_planar.width == 32 and b.alpha_planar.width == 32
    assert (shared / entry).read_bytes() == planted
    assert (isolated_reference / entry).exists()
