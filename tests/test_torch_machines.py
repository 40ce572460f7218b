"""The round machines' plain versions and their contracts on the CPU.

On the card three kernels each run a loop of traversal rounds in one launch
(``csrc/traverse.cu``): ``vkrt_alpha_rounds`` (the single-level alpha rounds,
``ops/traverse_alpha.py``), ``vkrt_opaque_machine`` and ``vkrt_alpha_machine``
(the two-level opaque and alpha rounds, ``ops/tlas.py``). The kernels run
only on the card (``tests/test_torch_cuda.py`` holds them against these
loops); here the loops, which are their plain versions, are held against the
reference on small scenes of their own:

* the (cull, any_hit) pairs of the two-level passes: a pair the kernels lack
  raises on CPU tensors, before the device dispatch; the two they have match
  the reference's passes on the reference's three-panel scene with a mixed
  panel mesh (``tests/test_torch_instancing.py``): hit masks, ``tri`` and
  ``inst`` exact, t within rtol 1e-5, seeds bit-identical;
* the per-ray round cap that ``vkrt_alpha_rounds`` relies on: rays straight
  down a single-level stack of 30 rejecting alpha panels stop after 24
  rounds, as the reference's, with ``tri`` and seeds exact, each capped
  seed its input advanced by exactly 24 PCG steps;
* the null pack (no stochastic test): every candidate accepted, no seed
  moves, as in the reference;
* the opaque machine's instance table: a scan of it in the kernel's
  ``next_instance`` order enumerates the same (entry t, instance) sequence
  as the round loop's ``_next_candidate(_instance_slab(...))`` on the small
  bistro, exact on ids and entry t (the same float32 operations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_instancing import _case, _check_alpha_pass, _panels
from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401 (fixtures)
from vk_raytrace_tpu.models.builder import GeometryBuilder
from vk_raytrace_tpu.models.schema import ALPHA_BLEND, dummy_atlas, make_materials
from vk_raytrace_tpu.ops import bvh8 as ref_bvh8
from vk_raytrace_tpu.ops import tlas as ref_tlas
from vk_raytrace_tpu.ops import traverse_alpha as ref_alpha
from vk_raytrace_tpu.ops.traverse import AlphaCtx
from vk_raytrace_torch import render as R
from vk_raytrace_torch.convert import _accel, _conv
from vk_raytrace_torch.models import procedural
from vk_raytrace_torch.models import schema as S
from vk_raytrace_torch.ops import tlas
from vk_raytrace_torch.ops import traverse_alpha as port_alpha
from vk_raytrace_torch.ops import traverse_fused as tf
from vk_raytrace_torch.ops.traverse_wide import make_alpha_pack

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL_T = 1e-5
N_PANEL_RAYS = 48

# ---------------------------------------------------------------------------
# The (cull, any_hit) pairs of the two-level passes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def panels():
    """The three-panel scene, opacity 0.5, the panel mesh's second triangle
    opaque (so the opaque pass meets the panels too), and rays straight
    down from z = 10: (case, origin, direction, t_max, seed, active)."""
    case = _case(*_panels(0.5, mixed=True))
    g = np.random.default_rng(80)
    n = N_PANEL_RAYS
    o = np.stack([g.uniform(-1.5, 1.5, n), g.uniform(-1.5, 1.5, n), np.full(n, 10.0)], -1)
    d = np.tile(np.asarray([[0, 0, -1.0]]), (n, 1))
    seed = g.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    act = g.random(n) < 0.9
    return (case, o.astype(np.float32), d.astype(np.float32), np.full(n, 20.0, np.float32),
            seed, act)


@pytest.mark.parametrize("which", ["opaque", "alpha"])
@pytest.mark.parametrize("cull,any_hit", [(True, True), (False, False)])
def test_two_level_passes_refuse_pairs_their_kernels_lack(panels, which, cull, any_hit):
    """Closest hit without culling and any hit with it: the kernels lack
    both, so the passes raise on CPU tensors too, before the dispatch."""
    case, o, d, t_max, seed, act = panels
    to, td, tm, ta = (torch.from_numpy(x) for x in (o, d, t_max, act))
    with pytest.raises(ValueError, match="closest hit with culling or any hit without"):
        if which == "opaque":
            tlas._two_level_opaque_pass(case.acc, "opq", to, td, tm, ta, cull, any_hit)
        else:
            tlas._two_level_alpha_pass(case.acc, case.pack, to, td, tm,
                                       torch.from_numpy(seed.astype(np.int64)), ta, any_hit, cull)


@pytest.mark.parametrize("which", ["opaque", "alpha"])
@pytest.mark.parametrize("kind", ["closest", "any"])
def test_two_level_passes_match_reference(panels, which, kind):
    """The pairs the kernels have, through the passes' CPU dispatch (the
    round loops), against the reference's passes called directly."""
    case, o, d, t_max, seed, act = panels
    if which == "alpha":
        port = _check_alpha_pass(case, o, d, t_max, seed, act, kind)
        assert 0.05 < (port[1].numpy() >= 0).mean() < 0.95
        return
    any_hit = kind == "any"
    ra = jax.tree.map(jnp.asarray, case.ref_acc)
    opq_view = ra._replace(
        blas_planar=ra.blas_planar_opq, mesh_root_planar=jnp.maximum(ra.mesh_root_opq, 0),
        inst=ra.inst._replace(aabb_min=ra.inst_aabb_opq_min, aabb_max=ra.inst_aabb_opq_max),
    )
    ref = ref_tlas._two_level_pass(
        opq_view, jnp.asarray(case.tri_material), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(t_max), jnp.asarray(seed), None, not any_hit, any_hit, jnp.asarray(act),
        ra.inst_opaque, True,
    )
    port = tlas._two_level_opaque_pass(case.acc, "opq", *(torch.from_numpy(x) for x in (
        o, d, t_max, act)), not any_hit, any_hit)
    rt, rtri, ri = (np.asarray(ref[k]) for k in (0, 1, 4))
    pt, ptri, pi = (port[k].numpy() for k in (0, 1, 4))
    np.testing.assert_array_equal(ptri, rtri)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(pt, rt, rtol=RTOL_T)
    # Rays on the panels' opaque triangles stop there, the rest on the
    # backstop (closest) or at the first opaque surface (any).
    assert 0.1 < (ptri >= 0).mean() and (pi[ptri >= 0] > 0).any()


# ---------------------------------------------------------------------------
# The single-level alpha rounds: the per-ray cap and the null pack
# ---------------------------------------------------------------------------

STACK = 30          # opacity-0 panels above the alpha-1 panel: more than 24
CAP = port_alpha._MAX_ROUNDS


def _quad(z):
    return np.asarray([[-2, -2, z], [2, -2, z], [2, 2, z], [-2, 2, z]], float)


@pytest.fixture(scope="module")
def stack():
    """A single-level scene: an opaque backstop at z = 0, an alpha-1 BLEND
    panel at z = 1 and ``STACK`` opacity-0 BLEND panels above it, 0.2
    apart; rays straight down from z = 10 with the backstop's distance as
    their window. A ray rejects one panel per round, so it meets the cap
    before the alpha-1 panel. Returns (reference tables, port tables,
    origin, direction, t_limit, seed, active)."""
    quad = np.asarray([[0, 1, 2], [0, 2, 3]])
    b = GeometryBuilder()
    b.add_mesh(np.asarray([[-10, -10, 0], [10, -10, 0], [10, 10, 0], [-10, 10, 0]], float), quad, 0)
    b.add_mesh(_quad(1.0), quad, 1, alpha_mode=ALPHA_BLEND)
    for k in range(STACK):
        b.add_mesh(_quad(1.2 + 0.2 * k), quad, 2, alpha_mode=ALPHA_BLEND)
    geom = b.build()
    mats = make_materials([
        dict(base_color_factor=[0.5, 0.5, 0.5, 1.0]),
        dict(base_color_factor=[1.0, 1.0, 1.0, 1.0], alpha_mode=ALPHA_BLEND),
        dict(base_color_factor=[1.0, 1.0, 1.0, 0.0], alpha_mode=ALPHA_BLEND),
    ])
    atlas = dummy_atlas()
    packed = ref_bvh8.build_accel_bundle(geom)
    ctx = jax.tree.map(jnp.asarray, AlphaCtx(materials=mats, atlas=atlas))
    tm = np.asarray(geom.tri_material)
    pack = make_alpha_pack(_conv(S.Materials, mats).to("cpu"), _conv(S.TextureAtlas, atlas).to("cpu"),
                           torch.from_numpy(tm).long())
    g = np.random.default_rng(81)
    n = 40
    o = np.stack([g.uniform(-1.5, 1.5, n), g.uniform(-1.5, 1.5, n), np.full(n, 10.0)], -1)
    d = np.tile(np.asarray([[0, 0, -1.0]]), (n, 1))
    seed = g.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    act = g.random(n) < 0.9
    return ((packed.alpha_planar, ctx, tm), (_accel(packed).to("cpu").alpha_planar, pack),
            o.astype(np.float32), d.astype(np.float32), np.full(n, 10.0, np.float32), seed, act)


def _pcg_steps(seed, k):
    """``seed`` (uint32) advanced by ``k`` PCG state steps (``ops/rng.py``)."""
    s = seed.astype(np.uint64)
    for _ in range(k):
        s = (s * 747796405 + 2891336453) & 0xFFFFFFFF
    return s.astype(np.uint32)


def _both_rounds(stack, kind, with_pack):
    (r_planar, ctx, tm), (p_planar, pack), o, d, t_lim, seed, act = stack
    ref_fn = ref_alpha.closest_hit_alpha if kind == "closest" else ref_alpha.any_hit_alpha
    port_fn = port_alpha.closest_hit_alpha if kind == "closest" else port_alpha.any_hit_alpha
    ref_out, ref_seed = ref_fn(r_planar, ctx if with_pack else None, jnp.asarray(tm),
                               jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_lim),
                               seed=jnp.asarray(seed), active=jnp.asarray(act))
    out, out_seed = port_fn(p_planar, pack if with_pack else None, *(torch.from_numpy(x) for x in (
        o, d, t_lim)), seed=torch.from_numpy(seed.astype(np.int64)), active=torch.from_numpy(act))
    return ref_out, np.asarray(ref_seed), out, out_seed.numpy().astype(np.uint32)


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_alpha_rounds_cap_each_ray_at_24(stack, kind):
    """Every active ray rejects 24 panels and stops: nothing accepted, and
    its seed moved by exactly 24 PCG steps, as in the reference; inactive
    rays keep their seeds. The cap is each ray's own count, since a ray
    that is live stays live until it ends."""
    *_, seed, act = stack
    ref_out, ref_seed, out, out_seed = _both_rounds(stack, kind, True)
    np.testing.assert_array_equal(out_seed, ref_seed)
    if kind == "closest":
        np.testing.assert_array_equal(out.tri.numpy(), np.asarray(ref_out.tri))
        accepted = out.tri.numpy() >= 0
    else:
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))
        accepted = out.numpy()
    assert not accepted.any()
    np.testing.assert_array_equal(out_seed[act], _pcg_steps(seed[act], CAP))
    np.testing.assert_array_equal(out_seed[~act], seed[~act])
    if kind == "closest":
        np.testing.assert_array_equal(out.steps.numpy()[~act], 0)


def test_alpha_rounds_cap_decides_the_stack(stack, monkeypatch):
    """With the cap raised past the stack every active ray reaches the
    alpha-1 panel (t = 9): the cap, not the scene, ends the rays above."""
    (_, _, _), (p_planar, pack), o, d, t_lim, seed, act = stack
    monkeypatch.setattr(port_alpha, "_MAX_ROUNDS", STACK + 2)
    hit, out_seed = port_alpha.closest_hit_alpha(
        p_planar, pack, *(torch.from_numpy(x) for x in (o, d, t_lim)),
        seed=torch.from_numpy(seed.astype(np.int64)), active=torch.from_numpy(act))
    np.testing.assert_array_equal(hit.tri.numpy() >= 0, act)
    np.testing.assert_allclose(hit.t.numpy()[act], 9.0)
    np.testing.assert_array_equal(out_seed.numpy()[act].astype(np.uint32),
                                  _pcg_steps(seed[act], STACK + 1))


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_alpha_rounds_null_pack_accepts_every_candidate(stack, kind):
    """Without an alpha pack (the wavefront's ``use_any_hit`` off) every
    candidate passes: the top panel (z = 7.0, t = 3) for every active ray,
    and no seed moves; as in the reference."""
    *_, seed, act = stack
    ref_out, ref_seed, out, out_seed = _both_rounds(stack, kind, False)
    np.testing.assert_array_equal(out_seed, seed)
    np.testing.assert_array_equal(ref_seed, seed)
    if kind == "any":
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))
        np.testing.assert_array_equal(out.numpy(), act)
        return
    np.testing.assert_array_equal(out.tri.numpy(), np.asarray(ref_out.tri))
    np.testing.assert_allclose(out.t.numpy(), np.asarray(ref_out.t), rtol=RTOL_T)
    np.testing.assert_allclose(out.t.numpy()[act], 10.0 - (1.2 + 0.2 * (STACK - 1)), rtol=1e-6)


# ---------------------------------------------------------------------------
# The opaque machine's instance table
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_bistro():
    """The small bistro's instances and rays: half from the street in
    random directions, half along its two rows of trees, which cross up to
    seven instance boxes; windows 2 to 80 long."""
    pool, inst, m, l, c, a = procedural.bistro_scene(detail=0.05)
    acc = R.build_instanced_scene(pool, inst, m, l, c, atlas=a).instances.to("cpu")
    g = np.random.default_rng(82)
    n, h = 512, 256
    o = g.uniform([-50, 0.5, -10], [50, 8, 10], (n, 3))
    o[:h, 1] = g.uniform(0.5, 2.5, h)
    o[:h, 2] = np.where(g.random(h) < 0.5, -10.3, 10.4)
    d = g.standard_normal((n, 3))
    d[:h] = np.stack([np.sign(d[:h, 0]), 0.02 * d[:h, 1], 0.02 * d[:h, 2]], -1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (acc, torch.tensor(o, dtype=torch.float32), torch.tensor(d, dtype=torch.float32),
            torch.tensor(g.uniform(2.0, 80.0, n), dtype=torch.float32))


def _scan_next(box, root, origin, direction, tmax0, t_best, last_t, last_id):
    """The kernel's ``next_instance`` as a torch scan over the instance
    table in id order: the slab test of each box, kept where the ray enters
    it before ``tmax0`` and ``t_best`` and after ``(last_t, last_id)``, the
    smallest entry t winning with ties to the lowest id (a strict ``<``)."""
    inv = tf.inv_dir(direction)
    best = torch.full_like(tmax0, tf.INF)
    nid = torch.full(tmax0.shape, -1, dtype=torch.int64)
    for i in range(box.shape[0]):
        if int(root[i]) < 0:
            continue
        lo = (box[i, 0:3] - origin) * inv
        hi = (box[i, 3:6] - origin) * inv
        tn = torch.amax(torch.minimum(lo, hi), dim=-1)
        tfar = torch.amin(torch.maximum(lo, hi), dim=-1)
        hit = (tn <= tfar) & (tfar >= 0.0) & (tn < tmax0) & (tn < t_best)
        after = (tn > last_t) | ((tn == last_t) & (i > last_id))
        take = hit & after & (tn < best)
        best = torch.where(take, tn, best)
        nid = torch.where(take, i, nid)
    return best, nid


@pytest.mark.parametrize("subset", ["opaque", "full"])
def test_opaque_machine_tables_enumerate_the_candidates(small_bistro, subset):
    """The machine kernels' instance table for the opaque subset (roots -1
    outside ``inst_opaque``) and for the full table (every instance), built
    once per accel, scanned in ``next_instance``'s order, gives the round
    loop's candidate sequence: each ray's instances in (entry t, id) order
    until none is left, with the window end and, in a second pass, a nearer
    best hit."""
    acc, o, d, t_max = small_bistro
    which = "opq" if subset == "opaque" else "full"
    _, roots, view, mask = tlas._subset(acc, which)
    box, w2o, root = tables = tlas._machine_tables(acc, which)
    assert tlas._machine_tables(acc, which) is tables  # kept on the accel
    assert which not in acc.to("cpu")._machine  # a copy builds its own
    assert box.shape == (view.aabb_min.shape[0], 6) and root.dtype == torch.int32
    assert torch.equal(w2o, view.world_to_object.reshape(-1, 12).float())
    want_root = torch.as_tensor(roots)[view.mesh_id.long()]
    if mask is not None:
        assert torch.equal(root < 0, ~mask.bool())
        want_root = torch.where(mask.bool(), want_root, -1)
    assert torch.equal(root.long(), want_root.long())
    entry0 = tlas._instance_slab(view, o, d, t_max, mask)
    counts = []
    for t_best in (t_max, t_max * 0.3):
        entry = torch.where(entry0 < t_best[:, None], entry0, tf.INF)
        last_t = torch.full_like(t_max, tlas._NEG)
        last_id = torch.full(t_max.shape, -1, dtype=torch.int64)
        rounds = 0
        while True:
            nt, nid = tlas._next_candidate(entry, last_t, last_id)
            st, sid = _scan_next(box, root, o, d, t_max, t_best, last_t, last_id)
            assert torch.equal(sid, nid), rounds
            assert torch.equal(st[nid >= 0], nt[nid >= 0]), rounds
            live = nid >= 0
            if not bool(live.any()):
                break
            last_t = torch.where(live, nt, last_t)
            last_id = torch.where(live, nid, last_id)
            rounds += 1
        counts.append(rounds)
    assert counts[0] >= 3 and counts[1] >= 1  # rays cross several instance boxes
