"""Two-level scenes of any size and of any alpha mix (``ops/tlas.py``): the
chunked candidate scan above 512 instances, the round machines' instance
table in global memory, and the instance-level split.

* The scan against the dense (R, I) entry table, inside the port's own
  round loops (the opaque loop over the opaque subsets and the full table,
  the alpha loop), closest and any hit: every output bit for bit, on the
  small plaza (601 instances; the scan is forced on and off by the loops'
  ``scan=`` keyword).
* The port against the reference on the reference's 9^3 = 729-box grid
  (``tests/test_instancing.py``), where both take their scan on their own:
  ``tri`` and ``inst`` equal wherever t is not tied, t within rtol 1e-5;
  the any-hit occlusion equal on every ray.
* The small plaza (601 instances: trunks, alpha-MASK foliage, the ground)
  through ``Renderer`` against the reference at 16x12, depth 2, under
  ``tests/test_torch_render.py``'s criterion (99% of pixels within rtol
  1e-3 / atol 1e-4, ray counts within 0.1%).
* The instance-level split (a pool whose triangles are all alpha-tested,
  so without subset tables: the alpha machine alone over the full tables)
  against the reference's on the three-panel
  scene with an alpha-tested backstop: exact at alpha 1, alpha 0 and MASK;
  at alpha 0.5 the mean hit distance against the exact expectation (the
  reference tests its candidates in another order, so a lane's seed and
  draw differ). An all-opaque pool given a pack equals the pass without.
* The round machines (``csrc/traverse.cu``) compiled as host C++ under the
  stand-in header of ``tests/test_torch_traverse_host.py``: the shared-
  memory table (201 instances) and the global one (601) bit for bit against
  the chunked loop, both machines, both kinds; and a shared-memory table
  padded past 512 with masked instances, which takes the global path and
  gives the same bits.
"""

import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_instancing import _case
from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401
from test_torch_traverse_host import SHIM, _host_source, _Stream
from vk_raytrace_tpu import render as ref_render
from vk_raytrace_tpu.models.gltf import load_gltf as ref_load
from vk_raytrace_tpu.models.instances import InstancedSceneBuilder as RefBuilder
from vk_raytrace_tpu.models.procedural import _box
from vk_raytrace_tpu.models.schema import (
    ALPHA_BLEND, ALPHA_MASK, PBR_GLTF, RenderConfig as RefConfig, dummy_atlas, make_materials,
)
from vk_raytrace_tpu.ops import tlas as ref_tlas
from vk_raytrace_torch import cuda_build
from vk_raytrace_torch import render as port_render
from vk_raytrace_torch.convert import from_reference
from vk_raytrace_torch.models.gltf import load_gltf
from vk_raytrace_torch.models.schema import RenderConfig
from vk_raytrace_torch.ops import tlas
from vk_raytrace_torch.ops import traverse_fused as tf
from vk_raytrace_torch.ops.traverse_wide import make_alpha_pack

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# 15 x 20 trees of two nodes each and the ground: 601 instances.
SMALL_PLAZA = dict(nx=15, nz=20, trunk_segments=6, trunk_rings=2, cards=4)
N = 256


def _plaza(tmp_path_factory, name, **kw):
    path = str(tmp_path_factory.mktemp("plaza") / f"{name}.gltf")
    chip_smoke.write_plaza(path, **{**SMALL_PLAZA, **kw})
    return path


def _accel_and_pack(path):
    (pool, inst), mats, lights, cam, atlas = load_gltf(path, instancing="auto")
    scene = port_render.build_instanced_scene(pool, inst, mats, lights, cam, atlas=atlas)
    acc = scene.instances.to("cpu")
    pack = make_alpha_pack(scene.materials.to("cpu"), scene.atlas.to("cpu"),
                           torch.as_tensor(np.asarray(pool.geometry.tri_material)).long())
    return pool, inst, acc, pack


@pytest.fixture(scope="module")
def plaza(tmp_path_factory):
    """The small plaza's accel and alpha pack, and rays: half from above the
    grid toward random triangles of random instances, half level through the
    trees (many instance boxes a ray)."""
    pool, inst, acc, pack = _accel_and_pack(_plaza(tmp_path_factory, "plaza"))
    assert acc.inst.aabb_min.shape[0] == 601 > tlas._DENSE_I_MAX
    assert acc.blas_planar_opq is not None and acc.blas_planar_alp is not None
    rng = np.random.default_rng(5)
    origins = np.concatenate([rng.uniform([-25, 4, -32], [25, 12, 32], (N // 2, 3)),
                              rng.uniform([-25, 0.5, -32], [25, 3.5, 32], (N // 2, 3))])
    o, d = chip_smoke.rays_toward_instances(rng, pool, inst,
                                            rng.integers(0, len(inst.mesh_id), N), origins, "cpu")
    d[N // 2:, 1] *= 0.05  # nearly level
    d = d / d.norm(dim=1, keepdim=True)
    seed = torch.tensor(rng.integers(0, 2**32, N), dtype=torch.int64)
    act = torch.tensor(rng.random(N) < 0.95)
    t_max = torch.tensor(rng.uniform(2.0, 40.0, N), dtype=torch.float32)
    return acc, pack, o, d.contiguous(), seed, act, t_max


def _same_bits(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.parametrize("kind", ["closest", "any"])
@pytest.mark.parametrize("loop", ["opaque_opq", "opaque_full", "alpha"])
def test_scan_equals_dense(plaza, loop, kind):
    acc, pack, o, d, seed, act, t_max = plaza
    any_hit = kind == "any"
    t_in = t_max if any_hit else torch.full((N,), tf.INF)
    rounds = [torch.zeros(N, dtype=torch.int32) for _ in range(2)]
    if loop == "alpha":
        args = (acc, pack, o, d, t_in, seed, act, any_hit, not any_hit)
        runs = [tlas._alpha_rounds(*args, scan=scan, rounds=n) for scan, n in zip((False, True),
                                                                                  rounds)]
    else:
        planar, roots, view, mask = tlas._subset(acc, loop.split("_")[1])
        args = (planar, roots, view, o, d, t_in, act, mask, not any_hit, any_hit)
        runs = [tlas._two_level_pass(*args, scan=scan, rounds=n) for scan, n in zip((False, True),
                                                                                    rounds)]
    for k, (a, b) in enumerate(zip(*runs)):
        assert _same_bits(a, b), f"output {k} of the scan differs from the dense table's"
    assert torch.equal(*rounds)
    hit = (runs[0][1] >= 0).float().mean()
    assert 0.05 < hit < 1.0, hit
    assert int(rounds[0].max()) >= 3  # some rays run several rounds


def test_scan_candidate_matches_next_candidate_sequence(plaza):
    """The scan by itself, a chunk boundary inside the table (601 = 4 x 128
    + 89), against ``_next_candidate`` over ``_instance_slab``, round after
    round until every ray has run out of instances."""
    acc, _, o, d, _, _, _ = plaza
    t_max = torch.full((N,), tf.INF)
    _, _, view, mask = tlas._subset(acc, "opq")
    entry = tlas._instance_slab(view, o, d, t_max, mask)
    last_t = torch.full((N,), tlas._NEG)
    last_id = torch.full((N,), -1, dtype=torch.int64)
    rounds = 0
    while True:
        nt, nid = tlas._next_candidate(entry, last_t, last_id)
        st, sid = tlas._scan_candidate(view, o, d, t_max, last_t, last_id, mask)
        assert torch.equal(sid, nid) and torch.equal(st[nid >= 0], nt[nid >= 0]), rounds
        live = nid >= 0
        if not bool(live.any()):
            break
        last_t, last_id = torch.where(live, nt, last_t), torch.where(live, nid, last_id)
        rounds += 1
    assert rounds > 5


def _grid_729():
    bv, bi = _box([0, 0, 0], [0.8, 0.8, 0.8])
    b = RefBuilder()
    mid = b.add_mesh(bv, bi, 0)
    for ix in range(9):
        for iy in range(9):
            for iz in range(9):
                m = np.eye(4)
                m[:3, 3] = [ix * 2.0, iy * 2.0, iz * 2.0]
                b.add_instance(mid, m)
    return b.build()


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_grid_729_matches_reference(kind):
    """The reference's 729-box grid: the rays along +x through each row of
    boxes (the reference's own case) and rays from around and inside the
    grid in random directions."""
    pool, inst = _grid_729()
    case = _case(pool, inst, make_materials([dict()]), dummy_atlas())
    assert case.acc.inst.aabb_min.shape[0] == 729 > ref_tlas._DENSE_I_MAX
    ys, zs = np.meshgrid(np.arange(9), np.arange(9))
    o_axis = np.stack([np.full(81, -5.0), ys.ravel() * 2.0, zs.ravel() * 2.0], 1)
    rng = np.random.default_rng(29)
    o_rand = rng.uniform(-3.0, 19.0, (175, 3))
    o = np.concatenate([o_axis, o_rand]).astype(np.float32)
    d = np.concatenate([np.tile([[1.0, 0.0, 0.0]], (81, 1)),
                        rng.standard_normal((175, 3))]).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = jnp.asarray(case.tri_material)
    if kind == "closest":
        rh, _ = ref_tlas.closest_hit_instanced(case.ref_acc, tm, jnp.asarray(o), jnp.asarray(d))
        ph, _ = tlas.closest_hit_instanced(case.acc, None, torch.from_numpy(o),
                                           torch.from_numpy(d))
        rt, pt = np.asarray(rh.t), ph.t.numpy()
        np.testing.assert_array_equal(rt < 1e30, pt < 1e30)
        hit = pt < 1e30
        np.testing.assert_allclose(pt[hit], rt[hit], rtol=1e-5)
        differ = hit & ((np.asarray(rh.tri) != ph.tri.numpy()) | (np.asarray(rh.inst) != ph.inst.numpy()))
        np.testing.assert_array_equal(pt[differ], rt[differ])  # only where t is tied
        assert differ.mean() < 0.02
        np.testing.assert_allclose(pt[:81], 5.0 - 0.4, rtol=1e-5)
        np.testing.assert_array_equal(ph.inst.numpy()[:81], ys.ravel() * 9 + zs.ravel())
        assert hit.mean() > 0.5
    else:
        t_max = rng.uniform(0.5, 6.0, len(o)).astype(np.float32)
        ro, _ = ref_tlas.any_hit_instanced(case.ref_acc, tm, jnp.asarray(o), jnp.asarray(d),
                                           jnp.asarray(t_max))
        po, _ = tlas.any_hit_instanced(case.acc, None, torch.from_numpy(o), torch.from_numpy(d),
                                       torch.from_numpy(t_max))
        np.testing.assert_array_equal(po.numpy(), np.asarray(ro))
        assert 0.1 < po.numpy().mean() < 0.95


def test_plaza_render_matches_reference(tmp_path_factory, monkeypatch):
    """The small plaza loaded by both packages' loaders, rendered by both
    renderers from the reference's tables (``convert.from_reference``), the
    reference on its fused path (Pallas in interpret mode, the split whose
    alpha machine the port runs), 16x12, depth 2, 2 frames, sun&sky."""
    monkeypatch.setenv("VKRT_FUSED", "1")
    path = _plaza(tmp_path_factory, "render")
    (pool, inst), mats, lights, cam, atlas = ref_load(path, instancing="auto")
    assert len(inst.mesh_id) == 601
    cfg = dict(width=16, height=12, max_depth=2, max_samples=1, pbr_mode=PBR_GLTF,
               firefly_clamp=10.0, use_sun_sky=True)
    ref = ref_render.Renderer(
        ref_render.build_instanced_scene(pool, inst, mats, lights, cam, atlas=atlas),
        RefConfig(**cfg))
    scene, acc = from_reference(ref.scene, ref.packed)
    assert isinstance(acc, tlas.InstancedAccel) and acc.blas_planar_alp is not None
    port = port_render.Renderer(scene, RenderConfig(**{**cfg, "use_sun_sky": False,
                                                       "sun_disk": True}),
                                device="cpu", packed=acc)
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
    for a, b in zip(*rays):
        assert abs(b - a) <= 1e-3 * a, rays
    assert min(rays[1]) > cfg["width"] * cfg["height"]


# ---------------------------------------------------------------------------
# The instance-level split: an all-alpha pool, and an all-opaque pool
# ---------------------------------------------------------------------------


def _all_alpha_panels(mode, alpha):
    """The reference's three panels (instances of one quad at z = 2, 4, 6)
    over a backstop at z = 0, every triangle alpha-tested: the backstop is
    MASK with alpha 1 (it always passes), the panels ``mode`` at ``alpha``."""
    quad = np.asarray([[0, 1, 2], [0, 2, 3]])
    b = RefBuilder()
    m_bs = b.add_mesh(np.asarray([[-10, -10, 0], [10, -10, 0], [10, 10, 0], [-10, 10, 0]], float),
                      quad, 0, alpha_mode=ALPHA_MASK)
    m_p = b.add_mesh(np.asarray([[-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]], float), quad, 1,
                     alpha_mode=mode)
    b.add_instance(m_bs, np.eye(4))
    for z in (2.0, 4.0, 6.0):
        m = np.eye(4)
        m[2, 3] = z
        b.add_instance(m_p, m)
    pool, inst = b.build()
    assert (np.asarray(pool.geometry.tri_flags) & 2).all()
    mats = make_materials([
        dict(base_color_factor=[0.5, 0.5, 0.5, 1.0], alpha_mode=ALPHA_MASK),
        dict(base_color_factor=[1.0, 1.0, 1.0, alpha], alpha_mode=mode),
    ])
    case = _case(pool, inst, mats, dummy_atlas())
    assert case.acc.blas_planar_opq is None and case.ref_acc.blas_planar_opq is None
    return case


def _down_rays(n, seed):
    g = np.random.default_rng(seed)
    o = np.stack([g.uniform(-1.5, 1.5, n), g.uniform(-1.5, 1.5, n), np.full(n, 10.0)], -1)
    d = np.tile([[0.0, 0.0, -1.0]], (n, 1))
    s = g.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return o.astype(np.float32), d.astype(np.float32), s


@pytest.mark.parametrize("panels,want_t", [
    ((ALPHA_BLEND, 1.0), 4.0),    # every panel passes: the nearest, at t = 4
    ((ALPHA_BLEND, 0.0), 10.0),   # every panel rejects: the backstop
    ((ALPHA_MASK, 0.7), 4.0),     # above the cutoff: opaque
    ((ALPHA_MASK, 0.3), 10.0),    # below: cut out
], ids=["blend1", "blend0", "mask_pass", "mask_cut"])
def test_instance_level_split_matches_reference(panels, want_t):
    case = _all_alpha_panels(*panels)
    o, d, s = _down_rays(64, 7)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    ts = torch.from_numpy(s.astype(np.int64))
    tm = jnp.asarray(case.tri_material)
    rh, _ = ref_tlas.closest_hit_instanced(case.ref_acc, tm, jnp.asarray(o), jnp.asarray(d),
                                           seed=jnp.asarray(s), alpha_ctx=case.ctx)
    ph, _ = tlas.closest_hit_instanced(case.acc, case.pack, to, td, seed=ts)
    np.testing.assert_array_equal(ph.tri.numpy(), np.asarray(rh.tri))
    np.testing.assert_array_equal(ph.inst.numpy(), np.asarray(rh.inst))
    np.testing.assert_array_equal(ph.t.numpy(), np.asarray(rh.t))
    np.testing.assert_allclose(ph.t.numpy(), want_t, rtol=1e-6)
    # Occlusion short of the backstop: the panels occlude exactly when they pass.
    t_max = np.full(64, 9.0, np.float32)
    ro, _ = ref_tlas.any_hit_instanced(case.ref_acc, tm, jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(t_max), seed=jnp.asarray(s), alpha_ctx=case.ctx)
    po, _ = tlas.any_hit_instanced(case.acc, case.pack, to, td, torch.from_numpy(t_max), seed=ts)
    np.testing.assert_array_equal(po.numpy(), np.asarray(ro))
    assert bool(po.all()) == (want_t == 4.0) and bool(po.any()) == (want_t == 4.0)


def test_instance_level_split_distribution():
    """Alpha 0.5 through three panels: the nearest accepted surface is at
    t = 4, 6, 8 or the backstop's 10 with probabilities 1/2, 1/4, 1/8, 1/8;
    the port's empirical mean and each share against the exact values, and
    the reference's mean on the same rays (its own seeds' draws)."""
    case = _all_alpha_panels(ALPHA_BLEND, 0.5)
    n = 4096
    o, d, s = _down_rays(n, 3)
    ph, _ = tlas.closest_hit_instanced(case.acc, case.pack, torch.from_numpy(o),
                                       torch.from_numpy(d), seed=torch.from_numpy(s.astype(np.int64)))
    rh, _ = ref_tlas.closest_hit_instanced(case.ref_acc, jnp.asarray(case.tri_material),
                                           jnp.asarray(o), jnp.asarray(d), seed=jnp.asarray(s),
                                           alpha_ctx=case.ctx)
    expect = 0.5 * 4 + 0.25 * 6 + 0.125 * 8 + 0.125 * 10
    t = ph.t.numpy()
    assert abs(t.mean() - expect) < 0.12, t.mean()
    assert abs(np.asarray(rh.t).mean() - expect) < 0.12
    for z, p in ((4.0, 0.5), (6.0, 0.25), (8.0, 0.125), (10.0, 0.125)):
        share = np.isclose(t, z).mean()
        assert abs(share - p) < 0.03, (z, share)


def test_all_opaque_pool_with_pack_equals_no_pack():
    """A pool without alpha triangles given an alpha pack: no subsets and no
    alpha instance, so the pass without a pack, lane for lane (the
    reference's split would add an alpha pass over no instance)."""
    quad = np.asarray([[0, 1, 2], [0, 2, 3]])
    b = RefBuilder()
    m = b.add_mesh(np.asarray([[-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]], float), quad, 0)
    for z in (2.0, 4.0, 6.0):
        x = np.eye(4)
        x[2, 3] = z
        b.add_instance(m, x)
    pool, inst = b.build()
    case = _case(pool, inst, make_materials([dict()]), dummy_atlas())
    assert case.acc.blas_planar_opq is None and not case.acc._any_alpha()
    o, d, s = _down_rays(64, 11)
    args = (torch.from_numpy(o), torch.from_numpy(d))
    ts = torch.from_numpy(s.astype(np.int64))
    with_pack = tlas.closest_hit_instanced(case.acc, case.pack, *args, seed=ts)
    without = tlas.closest_hit_instanced(case.acc, None, *args, seed=ts)
    for a, b_ in zip((*with_pack[0], with_pack[1]), (*without[0], without[1])):
        assert torch.equal(a, b_)
    t_max = torch.full((64,), 5.0)
    assert torch.equal(tlas.any_hit_instanced(case.acc, case.pack, *args, t_max, seed=ts)[0],
                       tlas.any_hit_instanced(case.acc, None, *args, t_max, seed=ts)[0])


# ---------------------------------------------------------------------------
# The machines as host C++: the shared and the global instance table
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source as host C++")
    out = tmp_path_factory.mktemp("machines_host")
    cpp = out / "traverse_host.cpp"
    with open(os.path.join(cuda_build.CSRC, "traverse.cu")) as f:
        cpp.write_text(_host_source(f.read()))
    lib = out / "libw16.so"
    res = subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                          "-DVKRT_WIDTH=16", f"-I{SHIM}", f"-I{cuda_build.CSRC}", "-o",
                          str(lib), str(cpp)],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    return str(lib)


@pytest.fixture
def host_machines(host_lib, monkeypatch):
    """The wrappers' CUDA dispatch pointed at the host library: CPU tensors
    go through ``_opaque_machine_cuda`` / ``_alpha_machine_cuda``."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: _Stream())
    monkeypatch.setattr(tf, "_libs", {})
    monkeypatch.setattr(tf, "build", lambda width, verbose=False: host_lib)


@pytest.fixture(scope="module")
def small_grove(tmp_path_factory):
    """10 x 10 trees and the ground: 201 instances, a shared-memory table."""
    pool, inst, acc, pack = _accel_and_pack(_plaza(tmp_path_factory, "grove", nx=10, nz=10))
    assert acc.inst.aabb_min.shape[0] == 201
    return acc, pack


def _machine_runs(acc, pack, o, d, seed, act, t_max, which, kind):
    any_hit = kind == "any"
    t_in = t_max[:o.shape[0]] if any_hit else torch.full((o.shape[0],), tf.INF)
    if which == "alpha":
        args = (acc, pack, o, d, t_in, seed, act, any_hit, not any_hit)
        return tlas._alpha_machine_cuda(*args, "alp"), tlas._alpha_rounds(*args)
    planar, roots, view, mask = tlas._subset(acc, "opq")
    kern = tlas._opaque_machine_cuda(acc, "opq", o, d, t_in, act, any_hit)
    return kern, tlas._two_level_pass(planar, roots, view, o, d, t_in, act, mask, not any_hit,
                                      any_hit)


@pytest.mark.parametrize("kind", ["closest", "any"])
@pytest.mark.parametrize("which", ["opaque", "alpha"])
@pytest.mark.parametrize("table", ["shared", "global", "padded"])
def test_host_machines_match_chunked_loop(host_machines, plaza, small_grove, table, which, kind):
    """Each machine on the host: the 601-instance plaza (the global table)
    against the chunked loop, the 201-instance grove (the shared table)
    against the dense loop, and the grove's table padded with 400 masked
    instances (root -1: the global table) against the grove unpadded; every
    output bit for bit."""
    acc, pack, o, d, seed, act, t_max = plaza
    key = tf.launch_key(f"{which}_machine", 16)
    if table != "global":
        acc, pack = small_grove
        acc = acc.to("cpu")  # a copy: its own machine tables
    if table == "padded":
        sub = "alp" if which == "alpha" else "opq"
        box, w2o, root = tlas._machine_tables(acc, sub)
        pad = 400
        acc._machine[sub] = (torch.cat([box, box[:1].expand(pad, 6)]).contiguous(),
                             torch.cat([w2o, w2o[:1].expand(pad, 12)]).contiguous(),
                             torch.cat([root, torch.full((pad,), -1, dtype=torch.int32)]))
        assert acc._machine[sub][2].shape[0] > tlas._DENSE_I_MAX
    before = tf.LAUNCHES[key]
    kern, loop = _machine_runs(acc, pack, o, d, seed, act, t_max, which, kind)
    assert tf.LAUNCHES[key] == before + 1
    if table == "padded":
        loop = _machine_runs(small_grove[0].to("cpu"), pack, o, d, seed, act, t_max, which,
                             kind)[0]
    for k, (a, b) in enumerate(zip(kern, loop)):
        assert _same_bits(a.to(b.dtype), b), f"output {k} differs"
    assert (loop[1] >= 0).any()
