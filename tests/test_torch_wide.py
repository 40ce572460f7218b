"""The wide traversal back end (``renderer="wide"``) against the reference's
(``vk_raytrace_tpu/ops/traverse_wide.py``, its XLA body, the default off the
TPU: ``VKRT_FUSED=0``) on the CPU, and its CUDA source run as host C++
against its plain version.

* The native 8-wide rows and stack bounds (``runtime.build_bvh8_rows``,
  ``ops/bvh8.py``) array-equal to the reference's native builder: the
  Cornell box, the city's opaque and alpha subsets, one mesh of the
  instanced sphere/box pool and the concatenated per-mesh table.
* ``closest_hit_wide`` / ``any_hit_wide`` with and without alpha on the
  Cornell box, a MASK checkerboard (opacity a function of the hit point)
  and the city's alpha panels (BLEND), the same trees (``from_reference``):
  ``tri`` equal where t is not tied; t, u and v within rtol 1e-5 / atol
  1e-6 where ``tri`` agrees; steps and seeds equal.
* The bundle routes (opaque tree, then the alpha tree windowed by it)
  against the reference's, and the port's wide back end against its fused
  one on the same rays (``tri`` equal where t is not tied, t within rtol
  1e-5 / atol 1e-6).
* Two levels (``closest_hit_instanced`` / ``any_hit_instanced``,
  ``backend="wide"``) on the small bistro with and without alpha: hit masks
  on >= 99.5% of rays, ``tri`` and ``inst`` equal where t is not tied, t
  within rtol 1e-5, seeds equal (``tests/test_torch_instancing.py``'s
  criterion).
* ``csrc/traverse_wide.cu`` built as host C++ under the stand-in header
  ``tests/cuda_host_shim/cuda_runtime.h`` and bound through the port's own
  wrapper: every output bit for bit equal to ``_traverse_wide_plain``
  (closest and any, with and without alpha, from the root and with per-lane
  roots). The kernel on the card against the same plain version is the
  card test at the end (skips without CUDA).
"""

import os
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_alpha_fused import _checker_atlas, _wall_and_quads
from test_torch_instancing import _case, _foliage_rays
from test_torch_instancing import _rays as _street_rays
from test_torch_traverse import _rays as _scene_rays
from test_torch_traverse import isolated_reference  # noqa: F401 (autouse)
from vk_raytrace_tpu import render as ref_render
from vk_raytrace_tpu import runtime as ref_runtime
from vk_raytrace_tpu.models import procedural as ref_proc
from vk_raytrace_tpu.models.schema import ALPHA_MASK, make_materials
from vk_raytrace_tpu.models.schema import dummy_atlas as ref_dummy_atlas
from vk_raytrace_tpu.ops import bvh8 as ref_bvh8
from vk_raytrace_tpu.ops import tlas as ref_tlas
from vk_raytrace_tpu.ops import traverse_wide as ref_tw
from vk_raytrace_tpu.ops.traverse import AlphaCtx
from vk_raytrace_torch import cuda_build, runtime
from vk_raytrace_torch.convert import _accel, _conv
from vk_raytrace_torch.models import schema as S
from vk_raytrace_torch.ops import bvh8, tlas
from vk_raytrace_torch.ops import traverse_fused as tf
from vk_raytrace_torch.ops import traverse_wide as tw

pytestmark = pytest.mark.usefixtures("one_torch_thread")
from test_torch_traverse import one_torch_thread  # noqa: E402,F401 (fixture)

RTOL, ATOL = 1e-5, 1e-6
N = 384
SHIM = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_host_shim")


@pytest.fixture(autouse=True)
def _wide_reference(monkeypatch):
    """The reference's wide route: its default off the TPU."""
    monkeypatch.setenv("VKRT_FUSED", "0")


class Scene:
    """A single-level scene in both packages: the reference's bundle and
    alpha context, the port's copies (``convert``) and alpha pack."""

    def __init__(self, geom, mats, atlas=None):
        atlas = atlas if atlas is not None else ref_dummy_atlas()
        self.geom = geom
        self.ref = ref_bvh8.build_accel_bundle(geom)
        self.tm = np.asarray(geom.tri_material)
        self.ctx = jax.tree.map(jnp.asarray, AlphaCtx(materials=mats, atlas=atlas))
        self.pack = tw.make_alpha_pack(_conv(S.Materials, mats).to("cpu"),
                                       _conv(S.TextureAtlas, atlas).to("cpu"),
                                       torch.from_numpy(self.tm).long())
        self.bundle = _accel(self.ref).to("cpu")


@pytest.fixture(scope="module")
def cornell():
    g, m, _, _ = ref_proc.cornell_box()
    return Scene(g, m)


@pytest.fixture(scope="module")
def mask():
    mats = make_materials([
        dict(base_color_texture=0, alpha_mode=ALPHA_MASK, alpha_cutoff=0.5, double_sided=1),
        dict(base_color_factor=[0.5, 0.5, 0.5, 1.0], double_sided=1),
    ])
    return Scene(_wall_and_quads([dict(_idx=0, alpha_mode=ALPHA_MASK)], [0.0]), mats,
                 _checker_atlas())


@pytest.fixture(scope="module")
def city():
    g, m, _, _ = ref_proc.city_scene(n_blocks=6)
    return Scene(g, m)


def _t(a):
    return torch.from_numpy(np.array(a))


def _mask_rays(n, seed):
    r = np.random.default_rng(seed)
    o = np.stack([r.uniform(-4.5, 4.5, n), r.uniform(-4.5, 4.5, n), np.full(n, 8.0)], 1)
    d = np.broadcast_to(np.asarray([0, 0, -1.0]), (n, 3)) + r.normal(0, 0.02, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _rays_for(name, sc, seed):
    if name == "mask":
        return _mask_rays(N, seed)
    return _scene_rays(seed, sc.geom, n=N, toward_alpha=name == "city" and seed % 2 == 0)


def _t_max(rng, sc):
    """Shadow-ray lengths from 2% to 80% of the scene's diagonal."""
    pos = np.asarray(sc.geom.positions)
    return (rng.uniform(0.02, 0.8, N) * np.linalg.norm(pos.max(0) - pos.min(0))).astype(np.float32)


def _check(ref_t, ref_tri, ref_u, ref_v, t, tri, u, v):
    """``tri`` equal where the nearest t is not tied (a tie: the two t
    agree); t, u, v within rtol 1e-5 / atol 1e-6 where ``tri`` agrees."""
    ref_t, ref_tri, ref_u, ref_v = (np.asarray(x) for x in (ref_t, ref_tri, ref_u, ref_v))
    t, tri, u, v = (x.numpy() for x in (t, tri, u, v))
    same = tri == ref_tri
    np.testing.assert_allclose(t[~same], ref_t[~same], rtol=RTOL, atol=ATOL)  # ties only
    assert same.mean() > 0.98, same.mean()
    for a, b in ((t, ref_t), (u, ref_u), (v, ref_v)):
        np.testing.assert_allclose(a[same], b[same], rtol=RTOL, atol=ATOL)
    assert (ref_tri >= 0).mean() > 0.3  # the rays do hit the scene


# ---------------------------------------------------------------------------
# The native builder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["cornell", "city"])
def test_native_rows_match_reference(request, name):
    """``bvh8.build_wide`` (the opaque and, for the city, the alpha subset)
    array-equal to the reference bundle's native 8-wide trees, stack bounds
    included."""
    sc = request.getfixturevalue(name)
    opaque, alpha = bvh8.build_wide(sc.geom)
    for port, ref in ((opaque, sc.ref.opaque), (alpha, sc.ref.alpha)):
        if ref is None:
            assert port is None
            continue
        assert np.array_equal(port.rows, np.asarray(ref.rows))
        assert port.stack_depth == ref.stack_depth
    assert (alpha is not None) == (name == "city")


def test_instanced_rows_match_reference():
    """One mesh of the instanced sphere/box pool (pool-global ids), and the
    concatenated per-mesh table with its roots (``tlas.build_wide_blas``)."""
    from test_instancing import _build_both
    from vk_raytrace_tpu.ops.tlas import build_instanced_accel

    pool, inst, _ = _build_both()
    g = pool.geometry
    lo, cnt = int(pool.tri_start[1]), int(pool.tri_count[1])
    args = (np.asarray(g.positions), np.asarray(g.indices)[lo:lo + cnt], np.asarray(g.uv),
            np.asarray(g.tri_flags)[lo:lo + cnt])
    ids = np.arange(lo, lo + cnt, dtype=np.int32)
    assert np.array_equal(runtime.build_bvh8_rows(*args, tri_ids=ids),
                          ref_runtime.build_bvh8_rows(*args, tri_ids=ids))
    ref_acc = build_instanced_accel(pool, inst)
    blas, roots = tlas.build_wide_blas(g, pool.tri_start, pool.tri_count)
    assert np.array_equal(blas.rows, np.asarray(ref_acc.blas.rows))
    assert blas.stack_depth == ref_acc.blas.stack_depth
    assert np.array_equal(roots, np.asarray(ref_acc.mesh_root))


def test_id_ceiling_and_deep_trees_raise():
    """Triangle ids past 2^22 - 1 cannot ride in an f32 lane exactly, and a
    tree whose stack bound passes the kernel's 64 entries is refused (the
    reference would drop pushes)."""
    g, _, _, _ = ref_proc.cornell_box()
    args = (np.asarray(g.positions), np.asarray(g.indices), np.asarray(g.uv),
            np.asarray(g.tri_flags))
    ids = np.full(len(args[1]), 2**22, np.int32)
    with pytest.raises(ValueError, match="exact-f32 ceiling"):
        runtime.build_bvh8_rows(*args, tri_ids=ids)
    rows = runtime.build_bvh8_rows(*args)
    deep = bvh8.WideScene(torch.from_numpy(rows), bvh8.WIDE_STACK_MAX + 1)
    o = torch.zeros(4, 3)
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(4, 3).contiguous()
    with pytest.raises(ValueError, match="stack bound"):
        tw.closest_hit_wide(deep, None, o, d)


# ---------------------------------------------------------------------------
# One tree: closest and any hit against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("name", ["cornell", "mask", "city"])
def test_closest_hit_wide_matches_reference(request, name, alpha):
    sc = request.getfixturevalue(name)
    tree = "alpha" if alpha and sc.ref.alpha is not None else "opaque"
    o, d = _rays_for(name, sc, 3 + alpha)
    seed = np.random.default_rng(4).integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    active = np.random.default_rng(5).random(N) < 0.95
    ref, ref_seed = ref_tw.closest_hit_wide(
        getattr(sc.ref, tree), jnp.asarray(sc.tm), jnp.asarray(o), jnp.asarray(d),
        seed=jnp.asarray(seed), alpha_ctx=sc.ctx if alpha else None, active=jnp.asarray(active))
    hit, out_seed = tw.closest_hit_wide(getattr(sc.bundle, tree), sc.pack if alpha else None,
                                        _t(o), _t(d), seed=_t(seed.astype(np.int64)),
                                        active=_t(active))
    _check(ref.t, ref.tri, ref.u, ref.v, hit.t, hit.tri, hit.u, hit.v)
    np.testing.assert_array_equal(hit.steps.numpy(), np.asarray(ref.steps))
    np.testing.assert_array_equal(out_seed.numpy().astype(np.uint32), np.asarray(ref_seed))
    if alpha and tree == "alpha":
        assert (out_seed.numpy().astype(np.uint32) != seed).any()  # draws happened


@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("name", ["cornell", "mask", "city"])
def test_any_hit_wide_matches_reference(request, name, alpha):
    sc = request.getfixturevalue(name)
    tree = "alpha" if alpha and sc.ref.alpha is not None else "opaque"
    o, d = _rays_for(name, sc, 7 + alpha)
    rng = np.random.default_rng(8)
    seed = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    t_max = _t_max(rng, sc)
    occ_r, seed_r = ref_tw.any_hit_wide(
        getattr(sc.ref, tree), jnp.asarray(sc.tm), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(t_max), seed=jnp.asarray(seed), alpha_ctx=sc.ctx if alpha else None)
    occ, out_seed = tw.any_hit_wide(getattr(sc.bundle, tree), sc.pack if alpha else None, _t(o),
                                    _t(d), _t(t_max), seed=_t(seed.astype(np.int64)))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_r))
    np.testing.assert_array_equal(out_seed.numpy().astype(np.uint32), np.asarray(seed_r))
    assert 0.02 < occ.numpy().mean() < 0.98


@pytest.mark.parametrize("kind", ["closest", "any"])
@pytest.mark.parametrize("name", ["mask", "city"])
def test_bundle_routes_match_reference(request, name, kind):
    """``closest_hit_bundle`` / ``any_hit_bundle`` with ``backend="wide"``:
    the opaque tree, then the alpha tree with its test inline (windowed by
    the opaque t, or for the rays still unoccluded)."""
    sc = request.getfixturevalue(name)
    o, d = _rays_for(name, sc, 11)
    rng = np.random.default_rng(12)
    seed = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    ts = _t(seed.astype(np.int64))
    if kind == "closest":
        ref, ref_seed = ref_tw.closest_hit_bundle(sc.ref, jnp.asarray(sc.tm), jnp.asarray(o),
                                                  jnp.asarray(d), seed=jnp.asarray(seed),
                                                  alpha_ctx=sc.ctx)
        hit, out_seed = tw.closest_hit_bundle(sc.bundle, sc.pack, _t(o), _t(d), ts,
                                              backend="wide")
        _check(ref.t, ref.tri, ref.u, ref.v, hit.t, hit.tri, hit.u, hit.v)
        np.testing.assert_array_equal(hit.steps.numpy(), np.asarray(ref.steps))
    else:
        t_max = _t_max(rng, sc)
        ref, ref_seed = ref_tw.any_hit_bundle(sc.ref, jnp.asarray(sc.tm), jnp.asarray(o),
                                              jnp.asarray(d), jnp.asarray(t_max),
                                              seed=jnp.asarray(seed), alpha_ctx=sc.ctx)
        hit, out_seed = tw.any_hit_bundle(sc.bundle, sc.pack, _t(o), _t(d), _t(t_max), ts,
                                          backend="wide")
        np.testing.assert_array_equal(hit.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out_seed.numpy().astype(np.uint32), np.asarray(ref_seed))


@pytest.mark.parametrize("name", ["cornell", "city"])
def test_wide_matches_fused_on_same_rays(request, name):
    """The port's two back ends on the same rays without alpha: the 8-wide
    and the 16-wide trees visit triangles in other orders, so ``tri`` is
    compared where t is not tied."""
    sc = request.getfixturevalue(name)
    o, d = _rays_for(name, sc, 13)
    seed = torch.zeros(N, dtype=torch.int64)
    wide, _ = tw.closest_hit_bundle(sc.bundle, None, _t(o), _t(d), seed, backend="wide")
    fused, _ = tw.closest_hit_bundle(sc.bundle, None, _t(o), _t(d), seed, backend="fused")
    _check(fused.t, fused.tri, fused.u, fused.v, wide.t, wide.tri, wide.u, wide.v)
    t_max = torch.from_numpy(_t_max(np.random.default_rng(14), sc))
    occ_w, _ = tw.any_hit_bundle(sc.bundle, None, _t(o), _t(d), t_max, seed, backend="wide")
    occ_f, _ = tw.any_hit_bundle(sc.bundle, None, _t(o), _t(d), t_max, seed, backend="fused")
    assert (occ_w == occ_f).float().mean() >= 0.995


def test_unknown_backend_and_missing_tables_raise(cornell):
    o, d = _rays_for("cornell", cornell, 1)
    seed = torch.zeros(N, dtype=torch.int64)
    with pytest.raises(ValueError, match="no traversal back end 'rtx'"):
        tw.closest_hit_bundle(cornell.bundle, None, _t(o), _t(d), seed, backend="rtx")
    planar_only = tw.AccelBundle(cornell.bundle.opaque_planar, cornell.bundle.alpha_planar)
    with pytest.raises(ValueError, match="8-wide tables"):
        tw.closest_hit_bundle(planar_only, None, _t(o), _t(d), seed, backend="wide")
    built = bvh8.with_wide(planar_only, _conv(S.Geometry, cornell.geom))
    assert torch.equal(built.opaque.rows, torch.as_tensor(cornell.bundle.opaque.rows))


# ---------------------------------------------------------------------------
# Two levels
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bistro():
    pool, inst, mats, _, _, atlas = ref_proc.bistro_scene(detail=0.05)
    return _case(pool, inst, mats, atlas), pool, inst


def _two_level(case, o, d, seed, alpha, any_hit, t_max=None):
    jo, jd, js = jnp.asarray(o), jnp.asarray(d), jnp.asarray(seed)
    to, td, ts = _t(o), _t(d), _t(seed.astype(np.int64))
    ctx, pack = (case.ctx, case.pack) if alpha else (None, None)
    tm = jnp.asarray(case.tri_material)
    if any_hit:
        rh, rs = ref_tlas.any_hit_instanced(case.ref_acc, tm, jo, jd, jnp.asarray(t_max), seed=js,
                                            alpha_ctx=ctx)
        ph, ps = tlas.any_hit_instanced(case.acc, pack, to, td, _t(t_max), seed=ts,
                                        backend="wide")
    else:
        rh, rs = ref_tlas.closest_hit_instanced(case.ref_acc, tm, jo, jd, seed=js, alpha_ctx=ctx)
        ph, ps = tlas.closest_hit_instanced(case.acc, pack, to, td, seed=ts, backend="wide")
    return rh, np.asarray(rs), ph, ps.numpy().astype(np.uint32)


@pytest.mark.parametrize("alpha", [False, True])
def test_two_level_closest_matches_reference(bistro, alpha):
    from test_torch_instancing import _check_closest

    case, pool, inst = bistro
    if alpha:  # half the rays toward the foliage, where the test decides
        o1, d1, s = _street_rays(21, N // 2, [-50, 0.5, -10], [50, 8, 10])
        o2, d2 = _foliage_rays(case, pool, inst, 22, N // 2)
        o, d = np.concatenate([o1, o2]), np.concatenate([d1, d2])
        s = np.concatenate([s, s])
    else:
        o, d, s = _street_rays(23, N, [-50, 0.5, -10], [50, 8, 10])
    rh, rs, ph, ps = _two_level(case, o, d, s, alpha, any_hit=False)
    _check_closest(rh, ph)
    np.testing.assert_array_equal(ps, rs)
    if alpha:
        assert (ps != s).any()


@pytest.mark.parametrize("alpha", [False, True])
def test_two_level_any_matches_reference(bistro, alpha):
    case, pool, inst = bistro
    o, d = _foliage_rays(case, pool, inst, 24 + alpha, N)
    s = np.random.default_rng(25).integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    t_max = np.random.default_rng(26).uniform(1.0, 40.0, N).astype(np.float32)
    rh, rs, ph, ps = _two_level(case, o, d, s, alpha, any_hit=True, t_max=t_max)
    assert (np.asarray(rh) == ph.numpy()).mean() >= 0.995
    assert 0.05 < ph.numpy().mean() < 0.95
    np.testing.assert_array_equal(ps, rs)


def test_two_level_wide_matches_fused(bistro):
    """The port's two back ends over the instances without alpha: the same
    nearest hits (``tri`` and ``inst`` where t is not tied)."""
    case, _, _ = bistro
    o, d, _ = _street_rays(27, N, [-50, 0.5, -10], [50, 8, 10])
    w, _ = tlas.closest_hit_instanced(case.acc, None, _t(o), _t(d), backend="wide")
    f, _ = tlas.closest_hit_instanced(case.acc, None, _t(o), _t(d), backend="fused")
    hit = (w.t < 1e30) & (f.t < 1e30)
    assert ((w.t < 1e30) == (f.t < 1e30)).float().mean() >= 0.995
    np.testing.assert_allclose(w.t[hit].numpy(), f.t[hit].numpy(), rtol=RTOL, atol=ATOL)
    differ = hit & ((w.tri != f.tri) | (w.inst != f.inst))
    np.testing.assert_allclose(w.t[differ].numpy(), f.t[differ].numpy(), rtol=RTOL, atol=ATOL)
    assert differ.float().mean() < 0.01


# ---------------------------------------------------------------------------
# The CUDA source as host C++, and the kernel on the card
# ---------------------------------------------------------------------------


# (library, shared stack entries): the card's layout, and one that sends
# every stack entry past the second to the spill.
HOST_BUILDS = (("shared", None), ("spill", 2))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """``csrc/traverse_wide.cu`` built as host C++ under the shim, once per
    entry of :data:`HOST_BUILDS` (its launches and dynamic shared memory
    rewritten for the stand-in header)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source as host C++")
    out = tmp_path_factory.mktemp("traverse_wide_host")
    cpp = out / "traverse_wide_host.cpp"
    with open(os.path.join(cuda_build.CSRC, "traverse_wide.cu")) as f:
        src = f.read().replace("extern __shared__ float smem[];",
                               "float* smem = vkrt_dynamic_shared;")
        cpp.write_text(re.sub(r"([A-Za-z_]\w*(?:<[^<>;()]*>)?)<<<(.*?)>>>\(",
                              r"vkrt_launch(\1, \2)(", src, flags=re.S))
    libs = {}
    for name, shared in HOST_BUILDS:
        lib = out / f"libtraverse_wide_{name}.so"
        cmd = ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
               f"-I{SHIM}", f"-I{cuda_build.CSRC}", "-o", str(lib), str(cpp)]
        if shared is not None:
            cmd.insert(-3, f"-DVKRT_SHARED_STACK={shared}")
        res = subprocess.run(cmd, capture_output=True, text=True)
        assert res.returncode == 0, res.stderr
        libs[name] = str(lib)
    return libs


@pytest.fixture
def host_wide(host_lib, monkeypatch):
    """Point the wrappers at a host library: ``use(name)`` loads it (the
    wrappers' argtypes, resident threads and scratch as on the card)."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: _Stream())
    monkeypatch.setattr(tw, "_lib", None)
    monkeypatch.setattr(tw, "_GRID", tf.PersistentGrid())

    def use(name):
        monkeypatch.setattr(tw, "build", lambda verbose=False: host_lib[name])
        tw._lib = None
        tw._GRID.clear()

    return use


class _Stream:
    cuda_stream = 0


def _same_bits(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("case", ["opaque", "alpha", "roots"])
def test_host_kernel_matches_plain(host_wide, city, bistro, case, any_hit):
    """Every output (t, tri, u, v, steps, seed) bit for bit; the launch
    counted once."""
    _host_case(host_wide, city, bistro, case, any_hit, "shared")


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("case", ["opaque", "alpha", "roots"])
def test_host_kernel_spill_matches_plain(host_wide, city, bistro, case, any_hit):
    """The same with two stack entries a thread in shared memory, so that
    deeper entries go through the global spill (which the rays reach)."""
    _host_case(host_wide, city, bistro, case, any_hit, "spill")


def _host_case(host_wide, city, bistro, case, any_hit, build):
    host_wide(build)
    rng = np.random.default_rng(31 + any_hit)
    root0 = None
    pack = None
    if case == "roots":
        bcase, _, inst = bistro
        wide = bcase.acc.blas
        n = 512
        o = torch.from_numpy(rng.uniform(-3, 3, (n, 3)).astype(np.float32))
        d = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
        d = d / d.norm(dim=1, keepdim=True)
        mesh = rng.integers(0, len(np.asarray(bcase.acc.mesh_root)), n)
        root0 = torch.from_numpy(np.asarray(bcase.acc.mesh_root)[mesh].astype(np.int32))
        pack = bcase.pack
    else:
        wide = getattr(city.bundle, case)
        n = N
        o, d = (torch.from_numpy(x) for x in _rays_for("city", city, 0 if case == "alpha" else 1))
        pack = city.pack if case == "alpha" else None
    t_max = (torch.from_numpy(rng.uniform(0.5, 30.0, n).astype(np.float32)) if any_hit
             else torch.full((n,), tf.INF))
    seed = torch.from_numpy(rng.integers(0, 2**32, n).astype(np.int64))
    active = torch.from_numpy(rng.random(n) < 0.9)
    plain = tw._traverse_wide_plain(wide, pack, o, d, t_max, seed, active, any_hit, root0=root0)
    before = tf.LAUNCHES["traverse_wide"]
    kern = tw._traverse_wide_cuda(wide, pack, o, d, t_max, seed, active, any_hit, root0)
    assert tf.LAUNCHES["traverse_wide"] == before + 1
    for name, a, b in zip(("t", "tri", "u", "v", "steps", "seed"), plain, kern):
        assert _same_bits(a, b), name
    assert (plain[1] >= 0).any()
    if pack is not None:
        assert not torch.equal(plain[5], seed)
    if build == "spill" and case != "alpha":  # the city's alpha tree reaches two entries
        assert tw.stack_reached("cpu") > 2  # the spill ran


def test_card_kernel_matches_plain(city):
    """On the card: the kernel against its plain version on the same CUDA
    tensors, every output bit for bit (skips without CUDA)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    wide = city.bundle.alpha.to(dev)
    pack = tw.AlphaPack(city.pack.rows.to(dev), city.pack.alpha_plane.to(dev),
                        city.pack.atlas_width)
    o, d = (torch.from_numpy(x).to(dev) for x in _rays_for("city", city, 0))
    seed = torch.arange(N, dtype=torch.int64, device=dev) * 2654435761 % 2**32
    for any_hit in (False, True):
        t_max = torch.full((N,), 20.0 if any_hit else tf.INF, device=dev)
        plain = tw._traverse_wide_plain(wide, pack, o, d, t_max, seed, None, any_hit)
        kern = tw.traverse_wide(wide, pack, o, d, t_max, seed, None, any_hit)
        for name, a, b in zip(("t", "tri", "u", "v", "steps", "seed"), plain, kern):
            assert _same_bits(a, b), name
