"""The port's application layer against the reference: ``Renderer.pick``,
``save_state`` / ``load_state``, ``write_png``, the scene cache
(``utils/cache.py``) and the ``Profiler`` (``utils/profiler.py``).

Pick: the port's renderer takes the reference's tables
(``convert.from_reference``). The reference's ``Renderer.pick`` is
called on a few pixels per scene (it costs about a second a call on the
CPU), among them a hit on an alpha-tested triangle; on 256 pixels its
pick is computed by the same functions it calls, on all the pixels at
once. Triangle, material and instance are equal wherever t is not tied
(a differing triangle must have the same t), t within rtol 1e-5, the
position within 1e-5 and the barycentrics within 1e-3 (XLA on the CPU
contracts multiply-adds into FMAs, torch does not: a ray along a shared
edge may hit on one side only, which is allowed on 1% of the pixels where
the hit's barycentrics put it on the edge). Scenes: the Cornell
box, the 2x2-bay atrium cut (alpha banners, single level) and quirks.glb
loaded two-level (``instancing="auto"``). The reference picks without an
alpha test: on either path every alpha-tested triangle counts as opaque,
and so does the port's.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401
from vk_raytrace_tpu import render as ref_render
from vk_raytrace_tpu.integrator.camera import generate_rays_for_pixels as ref_rays_for_pixels
from vk_raytrace_tpu.models import procedural as ref_proc
from vk_raytrace_tpu.models.gltf import load_gltf as ref_load
from vk_raytrace_tpu.models.schema import RenderConfig as RefConfig
from vk_raytrace_tpu.ops import rng as ref_rng
from vk_raytrace_tpu.ops.tlas import InstancedAccel as RefInstancedAccel
from vk_raytrace_tpu.ops.tlas import closest_hit_instanced as ref_closest_instanced
from vk_raytrace_tpu.ops.traverse_wide import closest_hit_bundle as ref_closest_bundle
from vk_raytrace_tpu.utils import cache as ref_cache
from vk_raytrace_tpu.utils import profiler as ref_profiler
from vk_raytrace_torch import render as R
from vk_raytrace_torch.convert import from_reference
from vk_raytrace_torch.models import procedural
from vk_raytrace_torch.models.schema import PBR_GLTF, RenderConfig
from vk_raytrace_torch.ops import bvh8
from vk_raytrace_torch.utils import cache, png, profiler

pytestmark = pytest.mark.usefixtures("one_torch_thread")

QUIRKS = os.path.join(os.path.dirname(__file__), "assets", "quirks.glb")
PICK_CFG = dict(width=64, height=48, max_depth=2)
N_PICKS = 256


def _pick_scene(name):
    """The reference's renderer of a pick scene and the port's over the
    same tables."""
    if name == "cornell":
        g, m, l, c = ref_proc.cornell_box()
        scene = ref_render.build_scene(g, m, l, c)
    elif name == "atrium":
        g, m, l, c, a = ref_proc.atrium_scene(bays_x=2, bays_z=2, column_segments=16,
                                              column_rows=12)
        scene = ref_render.build_scene(g, m, l, c, atlas=a)
    else:
        (pool, inst), m, l, c, a = ref_load(QUIRKS, instancing="auto")
        scene = ref_render.build_instanced_scene(pool, inst, m, l, c, atlas=a)
    ref = ref_render.Renderer(scene, RefConfig(**PICK_CFG))
    port_scene, packed = from_reference(ref.scene, ref.packed)
    return ref, R.Renderer(port_scene, RenderConfig(**PICK_CFG), device="cpu", packed=packed)


def _ref_picks(ref, xs, ys):
    """The reference's ``Renderer.pick`` on every pixel at once: its ray
    generation and closest-hit calls on a batch (each ray's result does not
    depend on the others)."""
    w, h = ref.cfg.width, ref.cfg.height
    pix = jnp.asarray(ys * w + xs, jnp.uint32)
    o, d, _ = ref_rays_for_pixels(ref.scene.camera, w, h, pix, jnp.asarray(0, jnp.int32),
                                  ref_rng.tea(pix, jnp.uint32(0)))
    if isinstance(ref.packed, RefInstancedAccel):
        hit, _ = ref_closest_instanced(ref.packed, ref.scene.geometry.tri_material, o, d)
    else:
        hit, _ = ref_closest_bundle(ref.packed, ref.scene.geometry.tri_material, o, d)
    return {k: None if v is None else np.asarray(v)
            for k, v in dict(tri=hit.tri, t=hit.t, u=hit.u, v=hit.v, inst=hit.inst).items()}


def _check_pick(port, ref, alpha_flags):
    """One pick of the port against one of the reference (dicts or None)."""
    assert (port is None) == (ref is None)
    if ref is None:
        return False
    np.testing.assert_allclose(port["t"], ref["t"], rtol=1e-5)
    same = port["triangle"] == ref["triangle"] and port.get("instance") == ref.get("instance")
    if not same:  # a tie of t only
        assert port["t"] == ref["t"], (port, ref)
        return False
    assert port["material"] == ref["material"]
    np.testing.assert_allclose(port["position"], ref["position"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port["barycentrics"], ref["barycentrics"], atol=1e-3)
    return bool(alpha_flags[port["triangle"]] & 2)


@pytest.mark.parametrize("name", ["cornell", "atrium", "quirks_auto"])
def test_pick_matches_reference(name):
    ref, port = _pick_scene(name)
    flags = np.asarray(ref.scene.geometry.tri_flags)
    mats = np.asarray(ref.scene.geometry.tri_material)
    rng = np.random.default_rng(11)
    xs = rng.integers(0, PICK_CFG["width"], N_PICKS)
    ys = rng.integers(0, PICK_CFG["height"], N_PICKS)
    batch = _ref_picks(ref, xs, ys)
    picks = [port.pick(int(x), int(y)) for x, y in zip(xs, ys)]
    for one, many in zip(picks, port.pick_many(xs, ys)):  # a batch picks each ray alike
        assert (one is None) == (many is None)
        if one is not None:
            assert one.keys() == many.keys()
            assert all(np.array_equal(one[k], many[k]) for k in one)
    hits = batch["tri"] >= 0
    assert hits.mean() > 0.2
    # A hit on one side only lies on a triangle edge (the reference's FMAs
    # put a barycentric a few ulp below 0 on both triangles of an edge).
    flips = np.where(np.asarray([p is not None for p in picks]) != hits)[0]
    assert len(flips) <= 0.01 * N_PICKS, flips
    for i in flips:
        u, v = picks[i]["barycentrics"] if picks[i] is not None else (batch["u"][i], batch["v"][i])
        assert min(u, v, 1.0 - u - v) < 1e-5, (i, picks[i], u, v)
    hits[flips] = False
    differ, alpha_hit = 0, []
    for i in np.where(hits)[0]:
        p = picks[i]
        np.testing.assert_allclose(p["t"], batch["t"][i], rtol=1e-5)
        inst_same = batch["inst"] is None or p["instance"] == batch["inst"][i]
        if p["triangle"] != batch["tri"][i] or not inst_same:
            assert p["t"] == batch["t"][i], (i, p, batch["t"][i])  # a tie of t only
            differ += 1
            continue
        assert p["material"] == mats[p["triangle"]]
        assert ("instance" in p) == (batch["inst"] is not None)
        np.testing.assert_allclose(p["barycentrics"], (batch["u"][i], batch["v"][i]), atol=1e-3)
        alpha_hit.append(bool(flags[p["triangle"]] & 2))
    assert differ <= 0.02 * hits.sum()
    # The reference's method itself: a few hits, the first alpha-tested one
    # among them where the scene has such triangles, and a miss if any.
    order = list(np.where(hits)[0][:3])
    if any(alpha_hit):
        order.append(np.where(hits)[0][alpha_hit.index(True)])
    order += list(np.where(~hits)[0][:1])
    for i in order:
        _check_pick(picks[i], ref.pick(int(xs[i]), int(ys[i])), flags)
    # Alpha-tested triangles are picked as opaque, both ways: the banners'
    # and quirks' cut-out textures are transparent where they were hit.
    assert any(alpha_hit) == (name != "cornell")


def _cornell_renderer(**kw):
    g, m, l, c = procedural.cornell_box()
    return R.Renderer(R.build_scene(g, m, l, c),
                      RenderConfig(width=32, height=24, max_depth=3, **kw), device="cpu")


def test_resumed_render_equals_straight_run():
    straight = _cornell_renderer()
    for _ in range(4):
        straight.step()
    first = _cornell_renderer()
    first.step()
    first.step()
    state = first.save_state()
    assert state["accum"].dtype == np.float32 and state["frame"] == 2
    resumed = _cornell_renderer()
    resumed.load_state(state)
    assert resumed.accum.device.type == "cpu" and resumed.accum.dtype == torch.float32
    resumed.step()
    resumed.step()
    assert resumed.frame == straight.frame == 4
    assert torch.equal(resumed.accum, straight.accum)
    # A float64 tensor loads as float32; a wrong shape is refused.
    again = _cornell_renderer()
    again.load_state({"accum": torch.from_numpy(state["accum"].astype(np.float64)), "frame": 2})
    assert again.accum.dtype == torch.float32 and torch.equal(again.accum, first.accum)
    with pytest.raises(ValueError, match="shape"):
        again.load_state({"accum": np.zeros((24, 31, 3), np.float32), "frame": 1})


def test_write_png_matches_reference(tmp_path):
    """Values outside [0, 1] and at the rounding edges: the decoded pixels of
    the port's file equal those of the reference's (Pillow's) file."""
    rng = np.random.default_rng(2)
    img = rng.uniform(-0.2, 1.2, (17, 23, 3)).astype(np.float32)
    img[0, :6, 0] = [0.5 / 255, 1.5 / 255, 254.5 / 255, 1.0, 0.0, 0.999]
    ref_render.write_png(str(tmp_path / "ref.png"), img)
    R.write_png(str(tmp_path / "port.png"), torch.from_numpy(img))
    ref_px = np.asarray(Image.open(tmp_path / "ref.png"))
    data = (tmp_path / "port.png").read_bytes()
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")), ref_px)
    np.testing.assert_array_equal(png.decode_rgba(data)[..., :3], ref_px)


def _small_geometry():
    g, *_ = procedural.atrium_scene(bays_x=2, bays_z=2, column_segments=8, column_rows=10)
    return g


def _same_bundle(a, b):
    for x, y in ((a.opaque_planar, b.opaque_planar), (a.alpha_planar, b.alpha_planar)):
        assert (x is None) == (y is None)
        if x is not None:
            assert np.array_equal(x.rows, y.rows) and x.stack_depth == y.stack_depth
            assert x.width == y.width


def test_cache_hit_equals_build(tmp_path, monkeypatch):
    monkeypatch.setenv(cache.ENV, str(tmp_path))
    geom = _small_geometry()
    built = bvh8.build_accel_bundle(geom)
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 1 and files[0].startswith(cache.KEY_PREFIX)

    def no_build(*a, **k):
        raise AssertionError("a cache hit must not build")

    monkeypatch.setattr(bvh8, "_build", no_build)
    _same_bundle(bvh8.build_accel_bundle(geom), built)
    assert built.alpha_planar is not None
    # Another width is another key.
    monkeypatch.undo()
    monkeypatch.setenv(cache.ENV, str(tmp_path))
    w32 = bvh8.build_accel_bundle(geom, width=32)
    assert w32.opaque_planar.width == 32 and len(os.listdir(tmp_path)) == 2


def test_cache_corrupt_entry_is_rebuilt(tmp_path, monkeypatch):
    monkeypatch.setenv(cache.ENV, str(tmp_path))
    geom = _small_geometry()
    built = bvh8.build_accel_bundle(geom)
    (entry,) = os.listdir(tmp_path)
    whole = (tmp_path / entry).read_bytes()
    for bad in (b"not an npz file", whole[:len(whole) // 2]):  # garbage, a cut-off write
        (tmp_path / entry).write_bytes(bad)
        _same_bundle(bvh8.build_accel_bundle(geom), built)
        assert (tmp_path / entry).read_bytes() == whole
    key = entry[:-len(".npz")]
    assert set(cache.load(key)) == {"opaque_rows", "opaque_depth", "alpha_rows", "alpha_depth"}
    # An entry of the wrong row width is dropped and rebuilt as well.
    np.savez(tmp_path / entry, opaque_rows=np.zeros((2, 8), np.float32), opaque_depth=1)
    _same_bundle(bvh8.build_accel_bundle(geom), built)


@pytest.mark.parametrize("source", ["native.cpp", "runtime.py", "bvh8.py"])
def test_builder_digest_hashes_every_builder_source(tmp_path, monkeypatch, source):
    """The cache key's builder digest changes when any source of the build
    changes: the native builder, its binding and the Python side of the
    split (``ops/bvh8.py``), so no entry made by older code is served.
    The sources are copies; no real file is edited."""
    copies = []
    for path in bvh8.DIGEST_SOURCES:
        dst = tmp_path / os.path.basename(path)
        dst.write_bytes(open(path, "rb").read())
        copies.append(str(dst))
    assert [os.path.basename(p) for p in copies] == ["native.cpp", "runtime.py", "bvh8.py"]
    monkeypatch.setattr(bvh8, "DIGEST_SOURCES", tuple(copies))
    bvh8.builder_digest.cache_clear()
    try:
        before = bvh8.builder_digest()
        with open(tmp_path / source, "ab") as f:
            f.write(b"\n")
        bvh8.builder_digest.cache_clear()
        assert bvh8.builder_digest() != before
    finally:
        monkeypatch.undo()
        bvh8.builder_digest.cache_clear()


@pytest.mark.parametrize("off", ["off", "0", ""])
def test_cache_switch_turns_it_off(tmp_path, monkeypatch, off):
    monkeypatch.setenv(cache.ENV, off)
    monkeypatch.setenv("HOME", str(tmp_path))
    geom = _small_geometry()
    bvh8.build_accel_bundle(geom)
    assert cache.cache_dir() is None and not os.listdir(tmp_path)
    cache.save("k", a=np.zeros(3))
    assert cache.load("k") is None


def test_cache_keys_and_directory_are_the_ports(tmp_path, monkeypatch):
    """The default directory is ``~/.cache/vkrt_torch_scene``; the
    reference's variable and directory are never used; a key carries the
    port's prefix, so it never equals the reference's key of the same
    inputs."""
    monkeypatch.delenv(cache.ENV, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("VKRT_SCENE_CACHE", str(tmp_path / "ref_cache"))
    geom = _small_geometry()
    bvh8.build_accel_bundle(geom)
    assert cache.cache_dir() == str(tmp_path / "home" / ".cache" / "vkrt_torch_scene")
    assert len(os.listdir(cache.cache_dir())) == 1
    assert not (tmp_path / "ref_cache").exists()
    assert not (tmp_path / "home" / ".cache" / "vkrt_scene").exists()
    parts = ("accel-v2", geom.positions, geom.indices, "w16")
    key, ref_key = cache.content_key(*parts), ref_cache.content_key(*parts)
    assert key != ref_key and key.startswith(cache.KEY_PREFIX)
    assert not ref_key.startswith(cache.KEY_PREFIX)
    assert cache.content_key(*parts) == key != cache.content_key("accel-v2", geom.positions)


def test_profiler_matches_reference(tmp_path):
    """Fixed durations through ``add``: the same statistics and report; a
    ``trace`` writes a ``torch.profiler`` trace."""
    port, ref = profiler.Profiler(), ref_profiler.Profiler()
    for name, secs in (("render", 0.25), ("render", 0.125), ("tonemap", 0.002),
                       ("render", 0.5), ("mipmap", 1e-4)):
        port.add(name, secs)
        ref.add(name, secs)
    for name in ("render", "tonemap", "mipmap", "absent"):
        assert port.stats(name) == ref.stats(name)
    assert port.report() == ref.report()
    assert port.samples("render") == [0.25, 0.125, 0.5]
    with port.scope("step"):
        pass
    assert port.stats("step")["count"] == 1
    port.reset()
    assert port.report() == "" and port.stats("render") is None
    stats = profiler.device_memory_stats()  # the reference's keys, one entry a card
    assert len(stats) == torch.cuda.device_count()
    assert all(set(m) == {"device", "bytes_in_use", "bytes_limit", "peak_bytes_in_use"}
               for m in stats)
    with profiler.trace(str(tmp_path / "trace")) as where:
        torch.ones(64).cumsum(0)
    assert any(f.endswith(".json") for f in os.listdir(where))


def test_gltf_pbr_pick_on_quirks_bake():
    """quirks.glb baked by the port's own loader: every camera-ray hit of a
    coarse grid names a triangle of that geometry with its material."""
    from vk_raytrace_torch.models.gltf import load_gltf

    g, m, l, c, a = load_gltf(QUIRKS, instancing="bake")
    r = R.Renderer(R.build_scene(g, m, l, c, atlas=a),
                   RenderConfig(**PICK_CFG, pbr_mode=PBR_GLTF), device="cpu")
    picks = [r.pick(x, y) for x in range(0, 64, 8) for y in range(0, 48, 8)]
    hit = [p for p in picks if p is not None]
    assert len(hit) > 4
    for p in hit:
        assert p["material"] == int(g.tri_material[p["triangle"]]) and "instance" not in p
        assert p["t"] > 0.0 and np.isfinite(p["position"]).all()
