"""The per-round traversal entry (``vkrt_traverse`` in ``csrc/traverse.cu``:
mode c from the root, with culling and without, and modes a, b and c from
per-lane roots; persistent warps on the shared node loops, the stack in
shared memory with its exact spill) run on the CPU: the CUDA source
compiled as host C++ under ``tests/cuda_host_shim`` (the ``host_libs``
builds of ``tests/test_torch_traverse_host.py``: widths 16 and 32, and
width 16 with two shared stack entries, so the spill runs), bound through
the port's own wrapper ``traverse_fused._traverse_cuda`` and held against
the plain twin ``_traverse_plain`` bit for bit in t, tri, u, v and steps,
and in mode c uvu and uvv:

* mode c from the root on rays toward the 2x2-bay atrium's banners, culling
  on and off, ``active`` absent, about half and none;
* modes a, b and c (both culls) with roots at ``chip_smoke.first_candidates``
  of the bistro at ``detail=0.05`` (the rays' first instance candidates in
  their object space), ``active`` absent, about half and none;
* the NaN set (``chip_smoke.prefilter_rays("nan", ...)``): mode c from the
  root, and every mode from root row 0 (no union-box test);
* the round loops that drive the entry on the card
  (``traverse_alpha._rounds_core``, ``tlas._two_level_pass``,
  ``tlas._alpha_rounds``) with ``trav=`` the host kernel, against the same
  loops on the twin, output for output, with their round counts;
* zero rays, the refusals, and the scratch reused by a second call (and
  shared with the a/b entry) giving the same bits.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_traverse import one_torch_thread  # noqa: F401
from test_torch_traverse_host import BUILDS, _need_rays, _rays, _same_bits
from test_torch_traverse_host import (  # noqa: F401
    atrium, atrium_bundles, banners, host_kernel, host_libs)
from vk_raytrace_torch import render as R
from vk_raytrace_torch.models import procedural
from vk_raytrace_torch.ops import tlas
from vk_raytrace_torch.ops import traverse_alpha as ta
from vk_raytrace_torch.ops import traverse_fused as tf
from vk_raytrace_torch.ops.traverse_wide import make_alpha_pack

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OUT = ("t", "tri", "u", "v", "steps", "uvu", "uvv")
WIDTH = {b[0]: b[1] for b in BUILDS}
N_BISTRO = 1024
# The (mode, cull) pairs of the per-round kernels with roots.
ROOT_PAIRS = (("closest", True), ("any", False), ("candidate", True), ("candidate", False))


def _check(planar, o, d, t_max, active, mode, cull, root0=None, what=""):
    """One launch of the per-round entry against the twin: every output bit
    for bit, one launch counted under its key. Returns both."""
    key = tf.launch_key(mode if root0 is None else f"{mode}_roots", planar.width)
    before = tf.LAUNCHES[key]
    kern = tf._traverse_cuda(planar, o, d, t_max, active, mode, cull, root0)
    assert tf.LAUNCHES[key] == before + 1, what
    twin = tf._traverse_plain(planar, o, d, t_max, active, mode, cull, root0=root0)
    for k, name in enumerate(OUT):
        if twin[k] is None:
            assert kern[k] is None, f"{what}: {name}"
        else:
            assert _same_bits(kern[k], twin[k]), f"{what}: {name} differs from the twin"
    return kern, twin


@pytest.mark.parametrize("cull", [True, False], ids=["cull", "no_cull"])
@pytest.mark.parametrize("name", [b[0] for b in BUILDS])
def test_host_candidate_from_root_matches_twin(host_kernel, banners, name, cull):
    """Mode c from the alpha tree's root on rays toward the banners (windows
    1 to 40), with ``active`` absent, about half and none: bit for bit;
    the deepest stack within the tree's bound (past the two shared entries
    in the spill build); a second call on the reused scratch gives the same
    bits."""
    planars, _, (o, d, t_lim, _, _) = banners
    width = WIDTH[name]
    planar = planars[width]
    host_kernel(name)
    rng = np.random.default_rng(5 + width + int(cull))
    for kind in chip_smoke.PREFILTER_ACTIVE:
        act = chip_smoke.prefilter_active(kind, o.shape[0], rng)
        what = f"{name} cull={cull} active {kind}"
        kern, twin = _check(planar, o, d, t_lim, act, "candidate", cull, what=what)
        if kind == "none":
            assert (kern[1] == -1).all() and (kern[4] == 0).all(), what
            continue
        assert 0.05 < float((twin[1] >= 0).float().mean()) < 0.99, what
        deepest = tf.stack_reached(width, "cpu")
        assert 0 < deepest <= planar.stack_depth, what
        if name.endswith("spill"):
            assert deepest > 2, what
        again = tf._traverse_cuda(planar, o, d, t_lim, act, "candidate", cull)
        assert all(_same_bits(a, b) for a, b in zip(kern, again)), what


@pytest.fixture(scope="module")
def bistro():
    """The bistro at ``detail=0.05`` at both widths with its alpha pack,
    and world rays from its street, half toward its alpha instances' triangles,
    half toward any instance's, windows 2 to 60, 95% active, a seed each."""
    pool, inst, mats, lights, cam, atlas = procedural.bistro_scene(detail=0.05)
    accs = {}
    for w in tf.WIDTHS:
        scene = R.build_instanced_scene(pool, inst, mats, lights, cam, atlas=atlas, width=w)
        accs[w] = scene.instances.to("cpu")
    pack = make_alpha_pack(scene.materials.to("cpu"), scene.atlas.to("cpu"),
                           torch.as_tensor(np.asarray(pool.geometry.tri_material)).long())
    rng = np.random.default_rng(21)
    n = N_BISTRO
    alpha = np.nonzero(np.asarray(accs[16].inst_alpha))[0]
    pick = np.concatenate([rng.choice(alpha, n // 2), rng.integers(0, len(inst.mesh_id), n // 2)])
    o, d = chip_smoke.rays_toward_instances(rng, pool, inst, pick,
                                            rng.uniform([-50, 0.5, -10], [50, 8, 10], (n, 3)),
                                            "cpu")
    return (accs, pack, o, d, torch.tensor(rng.integers(0, 2**32, n), dtype=torch.int64),
            torch.tensor(rng.random(n) < 0.95),
            torch.tensor(rng.uniform(2.0, 60.0, n), dtype=torch.float32))


@pytest.mark.parametrize("pair", ROOT_PAIRS, ids=["closest", "any", "candidate", "candidate_nc"])
@pytest.mark.parametrize("name", [b[0] for b in BUILDS])
def test_host_roots_match_twin(host_kernel, bistro, name, pair):
    """Modes a/b over the opaque-subset tables and c over the alpha-subset
    ones, from each ray's first instance candidate's BLAS root (windows INF
    for closest and candidate, 2 to 60 for any), ``active`` absent, about
    half and none: bit for bit."""
    mode, cull = pair
    accs, _, o, d, _, _, t_win = bistro
    width = WIDTH[name]
    acc = accs[width]
    subset = "alp" if mode == "candidate" else "opq"
    t_max = t_win if mode == "any" else torch.full_like(t_win, tf.INF)
    oo, dd, tm, root0, share = chip_smoke.first_candidates(acc, subset, o, d, t_max, N_BISTRO)
    assert share > 0.1
    planar = getattr(acc, f"blas_planar_{subset}")
    host_kernel(name)
    rng = np.random.default_rng(31 + width)
    for kind in chip_smoke.PREFILTER_ACTIVE:
        act = chip_smoke.prefilter_active(kind, N_BISTRO, rng)
        what = f"{name} {mode} cull={cull} active {kind}"
        kern, twin = _check(planar, oo, dd, tm, act, mode, cull, root0, what)
        if kind == "none":
            assert (kern[1] == -1).all() and (kern[4] == 0).all(), what
        else:
            assert (twin[1] >= 0).any() and (twin[4] > 1).any(), what
            assert 0 < tf.stack_reached(width, "cpu") <= planar.stack_depth, what


@pytest.mark.parametrize("name", ["w16", "w32"])
def test_host_nan_rays_match_twin(host_kernel, atrium_bundles, name):
    """``chip_smoke.prefilter_rays``' NaN set (NaN, +-inf, +-3e38 in the
    origin, the direction or the window): mode c from the alpha tree's root
    (a NaN plane distance at the root is a miss in both), and every mode
    from root row 0 of the opaque and alpha trees (no union-box test: NaN
    rays visit the root and take no child): bit for bit."""
    width = WIDTH[name]
    bundle = atrium_bundles[1][width]
    host_kernel(name)
    rng = np.random.default_rng(61 + width)
    o, d, t_max = chip_smoke.prefilter_rays("nan", bundle.alpha_planar, 2001, rng)
    for cull in (True, False):
        kern, _ = _check(bundle.alpha_planar, o, d, t_max, None, "candidate", cull,
                         what=f"{name} nan cull={cull}")
        assert (kern[4] > 0).any() and (kern[4] == 0).any()
    zero = torch.zeros(o.shape[0], dtype=torch.int32)
    for mode, cull in ROOT_PAIRS:
        planar = bundle.alpha_planar if mode == "candidate" else bundle.opaque_planar
        kern, _ = _check(planar, o, d, t_max, None, mode, cull, zero,
                         what=f"{name} nan roots {mode} cull={cull}")
        assert (kern[4] >= 1).all()


def _host_trav(planar, o, d, tm, active, mode, cull, root0=None):
    return tf._traverse_cuda(planar, o, d, tm, active, mode, cull, root0)


def _plain_trav(planar, o, d, tm, active, mode, cull, root0=None):
    return tf._traverse_plain(planar, o, d, tm, active, mode, cull, root0=root0)


def _same_loops(what, n, run, key):
    """``run(trav, rounds)`` over ``n`` rays on the host kernel and on the
    twin: every output and the round counts equal bit for bit; the kernel
    launched once a round of the loop."""
    rk, rp = torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32)
    before = tf.LAUNCHES[key]
    kern = run(_host_trav, rk)
    launches = tf.LAUNCHES[key] - before
    plain = run(_plain_trav, rp)
    assert torch.equal(rk, rp), f"{what}: round counts differ"
    assert 0 < launches == int(rp.max()), f"{what}: {launches} launches"
    for k, (a, b) in enumerate(zip(kern, plain)):
        assert _same_bits(a, b), f"{what}: output {k} differs from the loop on the twin"
    return plain


@pytest.mark.parametrize("kind", ["closest", "any"])
@pytest.mark.parametrize("name", [b[0] for b in BUILDS])
def test_host_single_level_rounds_loop(host_kernel, banners, name, kind):
    """``traverse_alpha._rounds_core`` (the single-level candidate rounds,
    mode c from the root each round) with the host kernel against the loop
    on the twin, with the alpha pack: outputs, seeds and rounds equal."""
    planars, pack, rays = banners
    planar = planars[WIDTH[name]]
    host_kernel(name)
    args = _need_rays(planar, rays)
    cull = kind == "closest"
    plain = _same_loops(f"{name} rounds {kind}", args[0].shape[0],
                        lambda trav, rounds: ta._rounds_core(planar, pack, *args, cull, trav=trav,
                                                             rounds=rounds),
                        tf.launch_key("candidate", planar.width))
    assert (plain[1] >= 0).any()


@pytest.mark.parametrize("kind", ["closest", "any"])
@pytest.mark.parametrize("name", [b[0] for b in BUILDS])
def test_host_two_level_loops(host_kernel, bistro, name, kind):
    """``tlas._two_level_pass`` over the opaque subsets (modes a/b with
    roots each round) and ``tlas._alpha_rounds`` over the alpha subsets
    (mode c with roots, the stochastic test) with the host kernel against
    the same loops on the twin: outputs, seeds and rounds equal."""
    accs, pack, o, d, seed, act, t_win = bistro
    width = WIDTH[name]
    acc = accs[width]
    host_kernel(name)
    any_hit = kind == "any"
    t_max = t_win if any_hit else torch.full_like(t_win, tf.INF)
    planar, roots, inst, mask = tlas._subset(acc, "opq")
    plain = _same_loops(f"{name} opaque {kind}", N_BISTRO,
                        lambda trav, rounds: tlas._two_level_pass(
                            planar, roots, inst, o, d, t_max, act, mask, not any_hit, any_hit,
                            trav=trav, rounds=rounds),
                        tf.launch_key(f"{kind}_roots", width))
    assert (plain[1] >= 0).any()
    plain = _same_loops(f"{name} alpha {kind}", N_BISTRO,
                        lambda trav, rounds: tlas._alpha_rounds(
                            acc, pack, o, d, t_max, seed, act, any_hit, not any_hit, trav=trav,
                            rounds=rounds),
                        tf.launch_key("candidate_roots", width))
    assert (plain[1] >= 0).any()


def test_host_round_zero_rays_and_refusals(host_kernel, atrium, bistro):
    """No ray: no launch and empty outputs. The wrapper refuses roots that
    are not int32. The C entry refuses modes a/b without roots, a mode it
    lacks, another width, a stack bound past 128, 2^31 rays, a scratch too
    small for the tree and mode c without its uv outputs; a call that
    violates none is taken. The per-round kernels' occupancy: positive for
    each kernel, -1 for modes a/b without roots. A round call and an a/b
    call share the width's scratch, each giving its twin's bits again."""
    geom, planars = atrium
    accs, _, o, d, _, _, _ = bistro
    host_kernel("w16")
    lib = tf._load(16)
    alpha = accs[16].blas_planar_alp
    key = tf.launch_key("candidate_roots", 16)
    before = tf.LAUNCHES[key]
    none = tf._traverse_cuda(alpha, o[:0], d[:0], torch.ones(0), None, "candidate", True,
                             torch.zeros(0, dtype=torch.int32))
    assert tf.LAUNCHES[key] == before and all(x.numel() == 0 for x in none)
    with pytest.raises(ValueError, match="root0"):
        tf._traverse_cuda(alpha, o, d, torch.ones(N_BISTRO), None, "candidate", True,
                          torch.zeros(N_BISTRO, dtype=torch.int64))
    for mode, cull in ROOT_PAIRS:
        assert tf.round_occupancy(16, mode, cull, True) > 0
    assert tf.round_occupancy(16, "candidate", False, False) > 0
    assert lib.vkrt_traverse_round_occupancy(0, 1, 0) == -1
    assert lib.vkrt_traverse_round_occupancy(1, 0, 0) == -1
    n = 8
    planar = planars[16]
    slots = lib.vkrt_traverse_round_slots(2, 1, 0)
    words = lib.vkrt_traverse_ab_words(40, slots)
    assert words > 8 and (words - 8) % slots == 0
    small = torch.zeros(words - 1, dtype=torch.int32)
    enough = torch.zeros(lib.vkrt_traverse_ab_words(129, slots), dtype=torch.int32)
    t = torch.ones(n)
    root = torch.zeros(n, dtype=torch.int32)
    outs = [torch.empty(n) for _ in range(7)]

    def call(mode=2, cull=1, width=16, stack=planar.stack_depth, roots=None, n_rays=n,
             scratch=enough, uv=True):
        uvp = [outs[5].data_ptr(), outs[6].data_ptr()] if uv else [None, None]
        return lib.vkrt_traverse(mode, cull, width, planar.rows.data_ptr(), stack,
                                 o.data_ptr(), d.data_ptr(), t.data_ptr(), None,
                                 None if roots is None else roots.data_ptr(), n_rays,
                                 scratch.data_ptr(), scratch.numel(), slots,
                                 *(x.data_ptr() for x in outs[:5]), *uvp, None)

    assert call(mode=0) != 0 and call(mode=1, cull=0) != 0
    assert call(mode=3) != 0 and call(mode=3, roots=root) != 0
    assert call(width=32) != 0
    assert call(stack=129) != 0
    assert call(n_rays=2**31) != 0
    assert call(stack=40, scratch=small) != 0
    assert call(uv=False) != 0 and call(roots=root, uv=False) != 0
    assert call() == 0 and call(mode=0, roots=root) == 0 and call(mode=1, cull=0, roots=root) == 0
    # The width's one scratch, shared by the a/b entry and the per-round entry.
    oa, da, tma, acta = _rays(geom, 7)
    inf = torch.full_like(tma, tf.INF)
    ab = tf._traverse_cuda(planar, oa, da, inf, None, "closest", True)
    root0 = torch.zeros(oa.shape[0], dtype=torch.int32)
    rnd = _check(planar, oa, da, tma, acta, "closest", True, root0, "roots at row 0")[0]
    ab2 = tf._traverse_cuda(planar, oa, da, inf, None, "closest", True)
    assert all(_same_bits(a, b) for a, b in zip(ab[:5], ab2[:5]))
    again = tf._traverse_cuda(planar, oa, da, tma, acta, "closest", True, root0)
    assert all(_same_bits(a, b) for a, b in zip(rnd[:5], again[:5]))
    assert len(tf._AB_GRIDS[16].scratch) == 1
