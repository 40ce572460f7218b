"""Two-level instancing of the port against the reference (``ops/tlas.py``,
``models/instances.py``, the instanced shade state and fused shading).

The reference runs its fused path (``VKRT_FUSED=1``, Pallas in interpret
mode), the one whose per-lane-root traversal and alpha machine the port
ports; both get the same bytes through ``convert.from_reference``, and rays,
seeds and states made with numpy from a seed. Scenes: the reference's
instanced sphere/box scene (``tests/test_instancing.py``), its three-panel
alpha scene, and ``bistro_scene(detail=0.05)``.

Tolerances: hit masks agree on >= 99.5% of rays (an ulp of the instance
transform can flip a grazing ray), ``tri`` and ``inst`` are equal wherever
the nearest t is not tied, t within rtol 1e-5. The panel cases are exact,
as in the reference's own gates: alpha 1 stops at the first panel (t = 4),
alpha 0 reaches the backstop (t = 10), a mixed mesh's opaque triangle
blocks. Seeds leaving the alpha machine are bit-identical. The alpha pass
alone runs in ``tests/test_torch_instancing_alpha.py``, the instanced
shading in ``tests/test_torch_instancing_shade.py`` and the small bistro's
closest and any hits in ``tests/test_torch_instancing_bistro.py`` (split by
subject so that tier-1's workers share them); their helpers stay here.
"""

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401 (fixtures)
from vk_raytrace_tpu.models import procedural as ref_proc
from vk_raytrace_tpu.models.instances import InstancedSceneBuilder as RefBuilder
from vk_raytrace_tpu.models.schema import ALPHA_BLEND, dummy_atlas, make_materials
from vk_raytrace_tpu.ops import tlas as ref_tlas
from vk_raytrace_tpu.ops.traverse import AlphaCtx
from vk_raytrace_torch.convert import _accel, _conv
from vk_raytrace_torch.models import schema as S
from vk_raytrace_torch.models.instances import InstanceTable, MeshPool
from vk_raytrace_torch.ops import tlas
from vk_raytrace_torch.ops.traverse_wide import make_alpha_pack

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL_T, MASK_SHARE = 1e-5, 0.995
N = 320


@pytest.fixture(autouse=True)
def _fused_reference(monkeypatch):
    monkeypatch.setenv("VKRT_FUSED", "1")


def _port_pool(pool) -> MeshPool:
    return MeshPool(
        geometry=_conv(S.Geometry, pool.geometry),
        tri_start=np.asarray(pool.tri_start), tri_count=np.asarray(pool.tri_count),
        aabb_min=np.asarray(pool.aabb_min), aabb_max=np.asarray(pool.aabb_max),
    )


def _sphere_box():
    """The reference's instanced sphere/box scene (six rotated, scaled and
    moved instances of two meshes)."""
    sv, si, sn, suv = ref_proc._uv_sphere(8, 16)
    bv, bi = ref_proc._box([0, 0, 0], [1.2, 1.2, 1.2])
    rng = np.random.default_rng(3)
    b = RefBuilder()
    m_sphere = b.add_mesh(sv, si, 0, normals=sn, uv=suv)
    m_box = b.add_mesh(bv, bi, 1)
    for i in range(6):
        th = rng.uniform(0, 2 * np.pi)
        c, s = np.cos(th), np.sin(th)
        m = np.eye(4)
        m[:3, :3] = rng.uniform(0.5, 1.6) * np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        m[:3, 3] = [(i % 3 - 1) * 3.0, rng.uniform(0.0, 1.0), (i // 3 - 0.5) * 3.0]
        b.add_instance(m_sphere if i % 2 == 0 else m_box, m)
    return b.build()


def _panels(alpha, mixed=False):
    """The reference's alpha gate: a backstop at z=0 and three BLEND panels
    (instances of one quad) at z = 2, 4, 6; ``mixed`` makes the panel mesh's
    second triangle opaque."""
    quad = np.asarray([[0, 1, 2], [0, 2, 3]])
    b = RefBuilder()
    m_bs = b.add_mesh(np.asarray([[-10, -10, 0], [10, -10, 0], [10, 10, 0], [-10, 10, 0]], float),
                      quad, 0)
    m_p = b.add_mesh(np.asarray([[-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]], float), quad, 1,
                     alpha_mode=ALPHA_BLEND)
    b.add_instance(m_bs, np.eye(4))
    for z in (2.0, 4.0, 6.0):
        m = np.eye(4)
        m[2, 3] = z
        b.add_instance(m_p, m)
    pool, inst = b.build()
    if mixed:
        flags = np.asarray(pool.geometry.tri_flags).copy()
        flags[int(pool.tri_start[m_p]) + 1] &= ~2
        pool = pool._replace(geometry=pool.geometry._replace(tri_flags=flags))
    mats = make_materials([
        dict(base_color_factor=[0.5, 0.5, 0.5, 1.0]),
        dict(base_color_factor=[1.0, 1.0, 1.0, alpha], alpha_mode=ALPHA_BLEND),
    ])
    return pool, inst, mats, dummy_atlas()


class _Case(NamedTuple):
    ref_acc: object
    acc: object
    tri_material: np.ndarray
    ctx: object      # the reference's AlphaCtx
    pack: object     # the port's AlphaPack


def _case(pool, inst, mats, atlas) -> _Case:
    ref_acc = ref_tlas.build_instanced_accel(pool, inst)
    acc = _accel(ref_acc)
    tm = np.asarray(pool.geometry.tri_material)
    pack = make_alpha_pack(_conv(S.Materials, mats).to("cpu"), _conv(S.TextureAtlas, atlas).to("cpu"),
                           torch.from_numpy(tm).long())
    ctx = jax.tree.map(jnp.asarray, AlphaCtx(materials=mats, atlas=atlas))
    return _Case(ref_acc, acc.to("cpu"), tm, ctx, pack)


def _rays(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    s = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return o, d, s


@pytest.fixture(scope="module")
def sphere_box():
    pool, inst = _sphere_box()
    mats = make_materials([dict(), dict()])
    return _case(pool, inst, mats, dummy_atlas())


def _trace(case, o, d, seed, alpha, any_hit, t_max=None):
    """(ref hit or mask, ref seed, port hit or mask, port seed)."""
    jo, jd, js = jnp.asarray(o), jnp.asarray(d), jnp.asarray(seed)
    to, td, ts = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(seed.astype(np.int64))
    ctx = case.ctx if alpha else None
    pack = case.pack if alpha else None
    tm = jnp.asarray(case.tri_material)
    if any_hit:
        rh, rs = ref_tlas.any_hit_instanced(case.ref_acc, tm, jo, jd, jnp.asarray(t_max), seed=js,
                                            alpha_ctx=ctx)
        ph, ps = tlas.any_hit_instanced(case.acc, pack, to, td, torch.from_numpy(t_max), seed=ts)
    else:
        rh, rs = ref_tlas.closest_hit_instanced(case.ref_acc, tm, jo, jd, seed=js, alpha_ctx=ctx)
        ph, ps = tlas.closest_hit_instanced(case.acc, pack, to, td, seed=ts)
    return rh, np.asarray(rs), ph, ps.numpy().astype(np.uint32)


def _check_closest(rh, ph):
    rt, pt = np.asarray(rh.t), ph.t.numpy()
    r_hit, p_hit = rt < 1e30, pt < 1e30
    assert (r_hit == p_hit).mean() >= MASK_SHARE
    both = r_hit & p_hit
    np.testing.assert_allclose(pt[both], rt[both], rtol=RTOL_T)
    # A differing triangle or instance only where both report the same t.
    differ = both & ((np.asarray(rh.tri) != ph.tri.numpy()) | (np.asarray(rh.inst) != ph.inst.numpy()))
    np.testing.assert_array_equal(pt[differ], rt[differ])
    assert differ.mean() < 0.01
    assert both.mean() > 0.3  # the rays do hit the scene


def test_sphere_box_matches_reference(sphere_box):
    o, _, s = _rays(0, N, [-6, 2.5, -6], [6, 8, 6])
    # aimed at the instances' region
    target = np.random.default_rng(1).uniform([-4, 0, -3], [4, 1.5, 3], (N, 3))
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rh, _, ph, _ = _trace(sphere_box, o, d, s, False, any_hit=False)
    _check_closest(rh, ph)
    t_max = np.full(N, 4.0, np.float32)
    rm, _, pm, _ = _trace(sphere_box, o, d, s, False, any_hit=True, t_max=t_max)
    assert (np.asarray(rm) == pm.numpy()).mean() >= MASK_SHARE


def _panel_rays(n):
    g = np.random.default_rng(7)
    o = np.stack([g.uniform(-1.5, 1.5, n), g.uniform(-1.5, 1.5, n), np.full(n, 10.0)], -1)
    d = np.tile(np.asarray([[0, 0, -1.0]]), (n, 1))
    return o.astype(np.float32), d.astype(np.float32), np.arange(n, dtype=np.uint32)


@pytest.mark.parametrize("alpha,mixed,want", [(1.0, False, {4.0}), (0.0, False, {10.0}),
                                              (0.0, True, {4.0, 10.0}), (0.5, False, None)])
def test_panels_match_reference(alpha, mixed, want):
    case = _case(*_panels(alpha, mixed))
    o, d, s = _panel_rays(64)
    rh, rs, ph, ps = _trace(case, o, d, s, True, any_hit=False)
    t = ph.t.numpy()
    if want is not None:
        assert set(np.round(t, 3)) == want  # every ray ends where it must
    if mixed:
        assert bool(case.acc.inst_opaque[1]) and bool(case.acc.inst_alpha[1])
        assert int(case.acc.mesh_root_alp[0]) == -1  # the backstop has no alpha subset
    np.testing.assert_array_equal(ph.tri.numpy(), np.asarray(rh.tri))
    np.testing.assert_array_equal(ph.inst.numpy(), np.asarray(rh.inst))
    np.testing.assert_allclose(t, np.asarray(rh.t), rtol=1e-6)
    np.testing.assert_array_equal(ps, rs)  # seeds leaving the alpha machine
    if not mixed and alpha != 0.5:
        # Shadow windows short of the backstop: alpha-1 panels occlude,
        # alpha-0 panels never do (the reference's own any-hit gate).
        occ, _ = tlas.any_hit_instanced(case.acc, case.pack, torch.from_numpy(o),
                                        torch.from_numpy(d), torch.full((64,), 9.0),
                                        seed=torch.from_numpy(s.astype(np.int64)))
        assert bool(occ.all()) == (alpha == 1.0) and bool(occ.any()) == (alpha == 1.0)


# ---------------------------------------------------------------------------
# The alpha pass alone: the round loop against the reference's machine
# ---------------------------------------------------------------------------

STACK_PANELS = 33  # alpha-0 panels: 2 rounds each, so 66 rounds > _A_MAX_ROUNDS


def _panel_stack(alpha):
    """A backstop at z=0, an alpha-1 panel at z=1 and, above it,
    ``STACK_PANELS`` BLEND panels of opacity ``alpha``. A ray straight down
    needs two rounds for each panel it does not accept (the reject, then the
    instance found empty), so with ``alpha`` 0 it meets the 64-round cap
    before the alpha-1 panel."""
    quad = np.asarray([[0, 1, 2], [0, 2, 3]])
    b = RefBuilder()
    m_bs = b.add_mesh(np.asarray([[-10, -10, 0], [10, -10, 0], [10, 10, 0], [-10, 10, 0]], float),
                      quad, 0)
    panel = np.asarray([[-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]], float)
    m_stop = b.add_mesh(panel, quad, 1, alpha_mode=ALPHA_BLEND)
    m_p = b.add_mesh(panel, quad, 2, alpha_mode=ALPHA_BLEND)
    b.add_instance(m_bs, np.eye(4))
    for k, mesh in enumerate([m_stop] + [m_p] * STACK_PANELS):
        m = np.eye(4)
        m[2, 3] = 1.0 + 0.2 * k
        b.add_instance(mesh, m)
    pool, inst = b.build()
    mats = make_materials([
        dict(base_color_factor=[0.5, 0.5, 0.5, 1.0]),
        dict(base_color_factor=[1.0, 1.0, 1.0, 1.0], alpha_mode=ALPHA_BLEND),
        dict(base_color_factor=[1.0, 1.0, 1.0, alpha], alpha_mode=ALPHA_BLEND),
    ])
    return pool, inst, mats, dummy_atlas()


def _foliage_rays(case, pool, inst, seed, n):
    """World rays from the small bistro's street toward random points of its
    alpha-carrying instances."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-50, 0.5, -10], [50, 8, 10], (n, 3))
    pick = rng.choice(np.nonzero(np.asarray(case.acc.inst_alpha))[0], n)
    mesh = np.asarray(inst.mesh_id)[pick]
    tri = np.asarray(pool.tri_start)[mesh] + (rng.random(n) * np.asarray(pool.tri_count)[mesh]).astype(int)
    p = np.einsum("rk,rkc->rc", rng.dirichlet(np.ones(3), n),
                  np.asarray(pool.geometry.positions)[np.asarray(pool.geometry.indices)[tri]])
    m = np.asarray(inst.object_to_world)[pick]
    d = np.einsum("rij,rj->ri", m[:, :, :3], p) + m[:, :, 3] - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _alpha_pass_case(scene, width, kind):
    """(case, origin, direction, t_max, seed, active) for the alpha pass
    alone: the small bistro's rays toward its foliage, or the panel stack's
    rays straight down (opacity 0, 64-round cap, or 0.5)."""
    rng = np.random.default_rng(60 + width + (kind == "any"))
    if scene == "bistro":
        pool, inst, mats, _, _, atlas = ref_proc.bistro_scene(detail=0.05)
        n = 128
    else:
        pool, inst, mats, atlas = _panel_stack(0.0 if scene == "stack0" else 0.5)
        n = 32
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VKRT_WIDE", str(width))
        case = _case(pool, inst, mats, atlas)
    assert case.acc.blas_planar_alp.width == width
    if scene == "bistro":
        o, d = _foliage_rays(case, pool, inst, 70 + width, n)
    else:
        o = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.5, 1.5, n), np.full(n, 10.0)], -1)
        d = np.tile(np.asarray([[0, 0, -1.0]]), (n, 1))
    if scene != "bistro":  # past the backstop: every panel lies in the window
        t_max = np.full(n, 20.0, np.float32)
    else:
        t_max = (rng.uniform(1.0, 60.0, n) if kind == "any" else np.full(n, 1e32)).astype(np.float32)
    seed = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    act = rng.random(n) < 0.95
    return case, o.astype(np.float32), d.astype(np.float32), t_max, seed, act


def _check_alpha_pass(case, o, d, t_max, seed, act, kind):
    """The port's plain alpha pass (the round loop) against the reference's
    ``_two_level_alpha_pass`` (Pallas in interpret mode), called directly
    with the same seeds: seeds and accept masks exact, ``tri`` and ``inst``
    equal wherever t is not tied, t within rtol 1e-5, u/v within 1e-3 (a
    grazing hit magnifies the reference's FMA contraction, as in
    ``tests/test_torch_traverse.py``). Returns the port's outputs."""
    from vk_raytrace_tpu.ops.traverse_wide import make_alpha_pack as ref_make_alpha_pack

    any_hit = kind == "any"
    ref_acc = jax.tree.map(jnp.asarray, case.ref_acc)
    ref = ref_tlas._two_level_alpha_pass(
        ref_acc, ref_make_alpha_pack(case.ctx, jnp.asarray(case.tri_material)), jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(t_max), jnp.asarray(seed), jnp.asarray(act), any_hit,
        not any_hit,
    )
    port = tlas._two_level_alpha_pass(
        case.acc, case.pack, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max),
        torch.from_numpy(seed.astype(np.int64)), torch.from_numpy(act), any_hit, not any_hit,
    )
    rt, rtri, ru, rv, ri, rs = (np.asarray(x) for x in ref[:6])
    pt, ptri, pu, pv, pi, ps = (x.numpy() for x in port[:6])
    np.testing.assert_array_equal(ps.astype(np.uint32), rs)
    np.testing.assert_array_equal(ptri >= 0, rtri >= 0)
    np.testing.assert_allclose(pt, rt, rtol=RTOL_T)
    differ = (ptri != rtri) | (pi != ri)
    np.testing.assert_array_equal(pt[differ], rt[differ])  # a tie of t only
    assert differ.mean() < 0.01
    same = ~differ & (ptri >= 0)
    np.testing.assert_allclose(pu[same], ru[same], atol=1e-3)
    np.testing.assert_allclose(pv[same], rv[same], atol=1e-3)
    return port


def _check_alpha_outcome(scene, port):
    """What each ray set must show: bistro rays both pass and fail their
    tests; the opacity-0 stack ends every live ray at the round cap, short
    of the alpha-1 panel below it; the opacity-0.5 stack accepts most rays."""
    tri, steps = port[1].numpy(), port[6].numpy()
    if scene == "bistro":
        assert 0.05 < (tri >= 0).mean() < 0.95
    elif scene == "stack0":
        assert (tri < 0).all() and (steps >= tlas._A_MAX_ROUNDS).sum() >= 0.9 * len(tri)
    else:
        assert (tri >= 0).mean() > 0.8


@pytest.mark.parametrize("name", ["sphere_box", "panels", "bistro"])
def test_build_matches_reference_bytes(name):
    """The port's own build: every planar table, root table, mask and
    subset box byte-identical to the reference's."""
    if name == "bistro":
        pool, inst, *_ = ref_proc.bistro_scene(detail=0.05)
    elif name == "panels":
        pool, inst, *_ = _panels(0.5, mixed=True)
    else:
        pool, inst = _sphere_box()
    ref = ref_tlas.build_instanced_accel(pool, inst)
    acc = tlas.build_instanced_accel(_port_pool(pool), _conv(InstanceTable, inst))
    for f in ("blas_planar", "blas_planar_opq", "blas_planar_alp"):
        r, p = getattr(ref, f), getattr(acc, f)
        assert (r is None) == (p is None), f
        if p is not None:
            assert p.rows.dtype == np.float32 and np.array_equal(p.rows, np.asarray(r.rows)), f
            assert (p.stack_depth, p.width) == (r.stack_depth, r.width), f
    for f in ("mesh_root_planar", "mesh_root_opq", "mesh_root_alp", "inst_alpha", "inst_opaque",
              "inst_aabb_opq_min", "inst_aabb_opq_max", "inst_aabb_alp_min", "inst_aabb_alp_max"):
        r, p = getattr(ref, f), getattr(acc, f)
        assert (r is None) == (p is None), f
        if p is not None:
            assert np.asarray(p).dtype == np.asarray(r).dtype and np.array_equal(p, np.asarray(r)), f


def test_root_guards():
    """The build refuses a leaf row as a mesh root, the root masks must
    cover every clamped root, and the two cases the port once refused run:
    a pool without subset tables given a pack (the instance-level split)
    and a table of more than 512 instances (the chunked scan)."""
    pool, inst, *_ = _panels(0.5, mixed=True)
    acc = tlas.build_instanced_accel(_port_pool(pool), _conv(InstanceTable, inst))
    # The backstop mesh has no alpha triangle: its alpha root is -1 and the
    # alpha mask must leave its instance out.
    bad = dataclasses.replace(acc, inst_alpha=np.ones_like(acc.inst_alpha))
    with pytest.raises(AssertionError):
        bad.check_root_masks()
    leaf = int(np.nonzero(~tlas._classify_interior_planar(acc.blas_planar.rows, 16))[0][0])
    with pytest.raises(AssertionError):
        tlas._assert_interior_roots(acc.blas_planar.rows, [leaf], 16)
    tlas._assert_interior_roots(acc.blas_planar.rows, acc.mesh_root_planar, 16)
    dev = acc.to("cpu")
    o, d, _ = _panel_rays(4)
    pack = make_alpha_pack(
        _conv(S.Materials, make_materials([dict(), dict()])).to("cpu"),
        _conv(S.TextureAtlas, dummy_atlas()).to("cpu"), None,
    )
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    # No subset tables: the same scene with every triangle alpha-tested, and
    # materials that pass every test, so the alpha machine over the full
    # tables finds the hits of the pass without a pack.
    flags = np.asarray(pool.geometry.tri_flags) | 2
    all_alpha = tlas.build_instanced_accel(
        _port_pool(pool._replace(geometry=pool.geometry._replace(tri_flags=flags))),
        _conv(InstanceTable, inst)).to("cpu")
    assert all_alpha.blas_planar_opq is None and all_alpha._any_alpha()
    hit, _ = tlas.closest_hit_instanced(all_alpha, pack, o, d)
    want, _ = tlas.closest_hit_instanced(all_alpha, None, o, d)
    assert bool((hit.tri >= 0).all())
    for k in ("t", "tri", "inst"):
        assert torch.equal(getattr(hit, k), getattr(want, k)), k
    # Each instance 200 times (800 > 512): the scan takes the first copy of
    # each box, so the hits are the table's own.
    many = dataclasses.replace(dev.inst, **{
        f.name: torch.cat([getattr(dev.inst, f.name)] * 200)
        for f in dataclasses.fields(dev.inst)})
    assert many.aabb_min.shape[0] == 800 > tlas._DENSE_I_MAX
    want, _ = tlas.closest_hit_instanced(dev, None, o, d)
    got, _ = tlas.closest_hit_instanced(dataclasses.replace(dev, inst=many), None, o, d)
    for k in ("t", "tri", "u", "v", "inst"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
