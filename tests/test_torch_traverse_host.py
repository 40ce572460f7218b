"""The persistent mode a/b traversal (``vkrt_traverse_ab`` in
``csrc/traverse.cu``) run on the CPU: the CUDA source compiled as host C++
under the stand-in header ``tests/cuda_host_shim/cuda_runtime.h`` (blocks of
one thread, a one-lane warp, atomics as plain adds, each rounded float
intrinsic one IEEE single operation, g++ ``-ffp-contract=off``), bound
through the port's own ctypes wrapper, and held against the plain twin
``traverse_fused._traverse_plain`` on the 2x2-bay atrium at widths 16 and
32: t, tri, u, v and steps bit for bit. A build with two shared stack
entries runs the global spill. Skips where g++ is missing.

The single-level alpha rounds (``vkrt_alpha_rounds``, persistent warps,
the alpha pass's need line at their ray intake) through the same host
libraries: ``traverse_alpha._alpha_rounds_cuda`` against the round loop
``traverse_alpha._rounds_core`` fed ``_alpha_need_plain``'s mask (what
``_alpha_rounds`` runs on the CPU) on rays toward the atrium's banners,
each build, closest (culling) and any (none), with the alpha pack and
without (every candidate passes): t, tri, u, v, seed and steps bit for
bit; the deepest stack, the warps' step counts, the scratch reused, zero
rays, a deep alpha cloud past the sixteen shared entries, the 24-round cap
on a stack of 30 rejecting panels, and the refusal of a scratch too small;
the same at every build on ``chip_smoke.prefilter_rays``' sets with
``active`` absent, about half and none, with the intake's counts (rays
fetched, rays that needed the rounds); a need
mask given as ``active`` gives the same outputs. Modes a/b on the NaN set
against the twin: a NaN plane distance at the root is a miss in both.

The alpha pass's root prefilter (``vkrt_root_prefilter``) through the
same libraries at both widths: ``traverse_fused._alpha_need_cuda`` against
``_alpha_need_plain`` on ``chip_smoke.prefilter_rays``'s sets (random, along
the axes with +-0 and components below 1e-20, NaN and +-inf, t_limit <= 0,
INF, inf and NaN, subnormals) with ``active`` absent, about half and none:
equal bools, also on ray counts that fill no block and past one stride
of its persistent grid; zero rays and refusals.

Also the rank formula of a child order in registers (each hit child's rank
the number of hits j with key_j < key_i, or key_j == key_i and j < i: how
``sort_children_kernel`` ranks, and the a/b entry's first design, which
measured slower than the insertion it keeps) against the stable insertion
order of ``insert_child`` (numpy), with ties, misses, NaN and -0.
"""

import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_traverse import one_torch_thread  # noqa: F401
from vk_raytrace_torch import cuda_build
from vk_raytrace_torch import render as R
from vk_raytrace_torch.models import procedural
from vk_raytrace_torch.models import schema as S
from vk_raytrace_torch.models.builder import GeometryBuilder
from vk_raytrace_torch.ops import traverse_alpha as ta
from vk_raytrace_torch.ops import traverse_fused as tf
from vk_raytrace_torch.ops.bvh8 import build_accel_bundle
from vk_raytrace_torch.ops.traverse_wide import make_alpha_pack

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHIM = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_host_shim")
SMALL_ATRIUM = dict(bays_x=2, bays_z=2, column_segments=16, column_rows=12)
# (library, width, shared stack entries): the card's layout at both widths,
# and one that sends every entry past the second to the spill.
BUILDS = (("w16", 16, None), ("w32", 32, None), ("w16_spill", 16, 2))
N_RAYS = 3000


def _host_source(src):
    """traverse.cu with its launches and dynamic shared memory rewritten for
    the stand-in header."""
    src = src.replace("extern __shared__ float smem[];", "float* smem = vkrt_dynamic_shared;")
    return re.sub(r"([A-Za-z_]\w*(?:<[^<>;()]*>)?)<<<(.*?)>>>\(", r"vkrt_launch(\1, \2)(", src,
                  flags=re.S)


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source as host C++")
    out = tmp_path_factory.mktemp("traverse_host")
    cpp = out / "traverse_host.cpp"
    with open(os.path.join(cuda_build.CSRC, "traverse.cu")) as f:
        cpp.write_text(_host_source(f.read()))

    def build(name, width, shared):
        lib = out / f"lib{name}.so"
        cmd = ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
               f"-DVKRT_WIDTH={width}", f"-I{SHIM}", f"-I{cuda_build.CSRC}", "-o", str(lib),
               str(cpp)]
        if shared is not None:
            cmd.insert(-3, f"-DVKRT_SHARED_STACK={shared}")
        res = subprocess.run(cmd, capture_output=True, text=True)
        assert res.returncode == 0, res.stderr
        return str(lib)

    with ThreadPoolExecutor(len(BUILDS)) as pool:
        futures = {name: pool.submit(build, name, w, sh) for name, w, sh in BUILDS}
        return {name: f.result() for name, f in futures.items()}


class _Stream:
    cuda_stream = 0


@pytest.fixture
def host_kernel(host_libs, monkeypatch):
    """Point the wrapper at a host library: ``use(name)`` loads it for its
    width (the wrapper's argtypes and scratch as on the card)."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: _Stream())
    monkeypatch.setattr(tf, "_libs", {})
    monkeypatch.setattr(tf, "_AB_GRIDS", {w: tf.PersistentGrid() for w in tf.WIDTHS})

    def use(name):
        monkeypatch.setattr(tf, "build", lambda width, verbose=False: host_libs[name])
        tf._libs.clear()
        for grid in tf._AB_GRIDS.values():
            grid.clear()

    return use


@pytest.fixture(scope="module")
def atrium_bundles():
    scene = procedural.atrium_scene(**SMALL_ATRIUM)
    return scene, {w: build_accel_bundle(scene[0], width=w).to("cpu") for w in tf.WIDTHS}


@pytest.fixture(scope="module")
def atrium(atrium_bundles):
    (geom, *_), bundles = atrium_bundles
    return geom, {w: b.opaque_planar for w, b in bundles.items()}


def _rays(geom, seed):
    """Half rays from inside the scene in random directions, half toward
    random points of random triangles (most of them hit)."""
    rng = np.random.default_rng(seed)
    pos = np.asarray(geom.positions)
    lo, hi = pos.min(0), pos.max(0)
    o = rng.uniform(lo + 0.05 * (hi - lo), hi - 0.05 * (hi - lo), (N_RAYS, 3))
    d = rng.standard_normal((N_RAYS, 3))
    half = N_RAYS // 2
    tri = np.asarray(geom.indices)[rng.integers(0, len(geom.indices), half)]
    d[:half] = np.einsum("rk,rkc->rc", rng.dirichlet(np.ones(3), half), pos[tri]) - o[:half]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = rng.uniform(0.5, 20.0, N_RAYS)
    active = rng.random(N_RAYS) < 0.9
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    return f32(o), f32(d), f32(t_max), torch.tensor(active)


def _same_bits(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.parametrize("mode", ["closest", "any"])
@pytest.mark.parametrize("name", [b[0] for b in BUILDS])
def test_host_kernel_matches_twin(host_kernel, atrium, name, mode):
    geom, planars = atrium
    width = dict((b[0], b[1]) for b in BUILDS)[name]
    planar = planars[width]
    host_kernel(name)
    o, d, t_max, active = _rays(geom, 11)
    cull = mode == "closest"
    t_in = torch.full((N_RAYS,), tf.INF) if mode == "closest" else t_max
    act = None if mode == "closest" else active
    lib = tf._load(width)
    key = tf.launch_key(mode, width)
    before = tf.LAUNCHES[key]
    kern = tf._traverse_cuda(planar, o, d, t_in, act, mode, cull)
    assert tf.LAUNCHES[key] == before + 1
    twin = tf._traverse_plain(planar, o, d, t_in, act, mode, cull)
    for k, what in enumerate(("t", "tri", "u", "v", "steps")):
        assert _same_bits(kern[k], twin[k]), f"{name} {mode}: {what} differs from the twin"
    assert 0.2 < float((twin[1] >= 0).float().mean()) < 0.999
    # The deepest stack any ray reached: within the tree's exact bound, and
    # past the two shared entries in the spill build.
    deepest = tf.stack_reached(width, o.device)
    assert 0 < deepest <= planar.stack_depth
    if name.endswith("spill"):
        assert deepest > 2
    # The scratch (counter, spill) is reused by the next call: the same result.
    again = tf._traverse_cuda(planar, o, d, t_in, act, mode, cull)
    assert all(_same_bits(a, b) for a, b in zip(kern[:5], again[:5]))
    assert lib.vkrt_traverse_ab_occupancy(tf._MODE_ID[mode]) > 0


@pytest.mark.parametrize("mode", ["closest", "any"])
@pytest.mark.parametrize("name", ["w16", "w32"])
def test_host_kernel_matches_twin_on_nan_rays(host_kernel, atrium, name, mode):
    """Rays with NaN, +-inf and +-3e38 components (``chip_smoke.
    prefilter_rays``' ``nan`` set, toward the opaque tree's root children):
    a NaN plane distance makes the root a miss in the kernel as torch's NaN
    propagation does in the twin, so every output is the twin's bit for
    bit, steps included."""
    geom, planars = atrium
    width = dict((b[0], b[1]) for b in BUILDS)[name]
    planar = planars[width]
    host_kernel(name)
    o, d, t_max = chip_smoke.prefilter_rays("nan", planar, N_RAYS, np.random.default_rng(61))
    cull = mode == "closest"
    kern = tf._traverse_cuda(planar, o, d, t_max, None, mode, cull)
    twin = tf._traverse_plain(planar, o, d, t_max, None, mode, cull)
    for k, what in enumerate(("t", "tri", "u", "v", "steps")):
        assert _same_bits(kern[k], twin[k]), f"{name} {mode}: {what} differs from the twin"
    assert (twin[4] > 0).any() and (twin[4] == 0).any()


def test_host_kernel_refuses(host_kernel, atrium):
    """Modes a/b from the root run only in the a/b entry (the per-round
    entry refuses them, with a scratch large enough), which refuses a
    scratch too small for the tree and a mode it lacks."""
    _, planars = atrium
    host_kernel("w16")
    lib = tf._load(16)
    planar = planars[16]
    n = 8
    o = torch.zeros(n, 3)
    d = torch.ones(n, 3)
    t = torch.ones(n)
    out = [torch.empty(n) for _ in range(5)]
    ptr = [x.data_ptr() for x in out]
    slots = lib.vkrt_traverse_ab_slots(0)
    big = torch.zeros(lib.vkrt_traverse_ab_words(128, slots), dtype=torch.int32)
    for mode in (0, 1):
        assert lib.vkrt_traverse(mode, 1 - mode, 16, planar.rows.data_ptr(), planar.stack_depth,
                                 o.data_ptr(), d.data_ptr(), t.data_ptr(), None, None, n,
                                 big.data_ptr(), big.numel(), slots, *ptr, None, None,
                                 None) != 0
    words = lib.vkrt_traverse_ab_words(40, slots)
    assert lib.vkrt_traverse_ab_words(8, slots) == 8  # a shallow tree: the head alone
    assert words > 8 and (words - 8) % slots == 0  # a column of spill entries per thread
    scratch = torch.zeros(words - 1, dtype=torch.int32)
    for mode, stack in ((0, 40), (2, 8)):
        assert lib.vkrt_traverse_ab(mode, 16, planar.rows.data_ptr(), stack, o.data_ptr(),
                                    d.data_ptr(), t.data_ptr(), None, n, scratch.data_ptr(),
                                    scratch.numel(), slots, *ptr, None) != 0


def _insertion_order(keys, hit):
    """``insert_child``: the hit children inserted in row order after every
    key <= theirs."""
    key, ref = [], []
    for i in np.nonzero(hit)[0]:
        j = len(key)
        while j > 0 and key[j - 1] > keys[i]:
            j -= 1
        key.insert(j, keys[i])
        ref.insert(j, int(i))
    return ref


def _rank_order(keys, hit):
    """The rank formula: a miss keyed +inf; hit i ranked by the hits j with
    key_j <= key_i before it and key_j < key_i after it."""
    k = np.where(hit, keys, np.float32(np.inf))
    w = len(k)
    order = [None] * int(hit.sum())
    for i in np.nonzero(hit)[0]:
        rank = sum(int(k[j] <= k[i]) for j in range(i)) + sum(
            int(k[j] < k[i]) for j in range(i + 1, w))
        assert order[rank] is None, "two children share a rank"
        order[rank] = int(i)
    return order


@pytest.mark.parametrize("width", tf.WIDTHS)
def test_child_rank_matches_insertion(width):
    rng = np.random.default_rng(width)
    special = np.array([0.0, -0.0, np.nan, np.inf, 1.0, 1.0, -0.0], dtype=np.float32)
    for case in range(400):
        keys = (rng.integers(-3, 4, width) / 2.0).astype(np.float32)  # many ties
        pick = rng.random(width) < 0.3
        keys[pick] = rng.choice(special, int(pick.sum()))
        if case % 4 == 0:
            keys = rng.standard_normal(width).astype(np.float32)
        # The slab test's hit: NaN never passes, nor does a key at +inf or a
        # child the ray misses.
        hit = (keys < np.float32(np.inf)) & (rng.random(width) < 0.7)
        assert _rank_order(keys, hit) == _insertion_order(keys, hit), keys


# ---------------------------------------------------------------------------
# The single-level alpha rounds (vkrt_alpha_rounds)
# ---------------------------------------------------------------------------

N_BANNER_RAYS = 2048
ROUNDS_OUT = ("t", "tri", "u", "v", "seed", "steps")


def _need_rays(planar, rays):
    """``rays`` (origin, direction, t_limit, seed, active) with the active
    mask replaced by the alpha pass's need mask (``_alpha_need_plain``)."""
    o, d, t_lim, seed, act = rays
    return o, d, t_lim, seed, tf._alpha_need_plain(planar, o, d, t_lim, act)


@pytest.fixture(scope="module")
def banners(atrium_bundles):
    """The atrium's alpha trees and alpha pack, and rays from inside the
    scene toward random points of its banners (the alpha-tested
    triangles), windows 1 to 40 long, 95% of them active, a seed each."""
    (geom, mats, lights, cam, atlas), bundles = atrium_bundles
    small = R.build_scene(geom, mats, lights, cam, atlas=atlas).to("cpu")
    pack = make_alpha_pack(small.materials, small.atlas, small.geometry.tri_material)
    rng = np.random.default_rng(17)
    o, d = chip_smoke.rays_at(rng, geom, np.where(np.asarray(geom.tri_flags) & 2)[0],
                              N_BANNER_RAYS, "cpu")
    t_lim = torch.tensor(rng.uniform(1.0, 40.0, N_BANNER_RAYS), dtype=torch.float32)
    seed = torch.tensor(rng.integers(0, 2**32, N_BANNER_RAYS), dtype=torch.int64)
    need = torch.tensor(rng.random(N_BANNER_RAYS) < 0.95)
    return {w: b.alpha_planar for w, b in bundles.items()}, pack, (o, d, t_lim, seed, need)


def _check_rounds(planar, pack, rays, cull, what):
    """The kernel (one launch; its intake runs the alpha pass's need line on
    ``rays``' active mask) against the round loop fed that line's mask
    (``_alpha_need_plain``, as ``_alpha_rounds`` feeds it on the CPU):
    every output bit for bit. Returns both."""
    key = tf.launch_key("alpha_rounds", planar.width)
    before = tf.LAUNCHES[key]
    kern = ta._alpha_rounds_cuda(planar, pack, *rays, cull)
    assert tf.LAUNCHES[key] == before + 1
    loop = ta._rounds_core(planar, pack, *_need_rays(planar, rays), cull)
    for k, name in enumerate(ROUNDS_OUT):
        assert _same_bits(kern[k], loop[k]), f"{what}: {name} differs from the round loop"
    return kern, loop


@pytest.mark.parametrize("with_pack", [True, False], ids=["pack", "null_pack"])
@pytest.mark.parametrize("kind", ["closest", "any"])
@pytest.mark.parametrize("name", [b[0] for b in BUILDS])
def test_host_alpha_rounds_match_loop(host_kernel, banners, name, kind, with_pack):
    """Every ray's rounds in one launch against the loop, bit for bit; the
    deepest stack within the alpha tree's bound (past the two shared
    entries in the spill build); at width 16, on the host's one-lane warps,
    every lane slot busy, one node step for each of the loop's (which count
    nodes only; width 32 counts none); the scratch reused by the next call,
    with the same result."""
    planars, pack, rays = banners
    width = dict((b[0], b[1]) for b in BUILDS)[name]
    planar = planars[width]
    host_kernel(name)
    pk = pack if with_pack else None
    kern, loop = _check_rounds(planar, pk, rays, kind == "closest", f"{name} {kind}")
    assert 0.05 < float((loop[1] >= 0).float().mean()) < 0.99
    seed = rays[3]
    assert torch.equal(kern[4], seed) if pk is None else bool((kern[4] != seed).any())
    deepest = tf.stack_reached(width, "cpu")
    assert 0 < deepest <= planar.stack_depth
    if name.endswith("spill"):
        assert deepest > 2
    busy, slots = tf._AB_GRIDS[width].lane_steps("cpu")
    assert busy == slots == (int(loop[5].sum()) if width == 16 else 0)
    again = ta._alpha_rounds_cuda(planar, pk, *rays, kind == "closest")
    assert all(_same_bits(a, b) for a, b in zip(kern, again))


@pytest.mark.parametrize("name", ["w16", "w16_spill"])
def test_host_threads_share_one_stream(host_kernel, atrium, banners, name):
    """Calls from four host threads on one stream, as the viewer's render
    loop and its ``/pick`` make them: the a/b entry (closest and any) and
    the alpha rounds, which share the width's scratch, each against its
    plain version bit for bit on every call. Without the grid's lock one
    call's scratch reset lands between another's reset and launch, and a
    kernel finds the ray counter past its rays."""
    geom, planars = atrium
    alpha_planars, pack, rounds_rays = banners
    host_kernel(name)
    cases = []
    for k, mode in enumerate(("closest", "any")):
        o, d, t_max, active = _rays(geom, 40 + k)
        cull = mode == "closest"
        args = (planars[16], o, d, torch.full((N_RAYS,), tf.INF) if cull else t_max,
                None if cull else active, mode, cull)
        cases.append((tf._traverse_cuda, args, tf._traverse_plain(*args)[:5]))
    args = (alpha_planars[16], None, *rounds_rays, True)
    want = ta._rounds_core(alpha_planars[16], None, *_need_rays(alpha_planars[16], rounds_rays),
                           True)
    cases.append((ta._alpha_rounds_cuda, args, want))
    tf._load(16)

    def run(k):
        fn, args, want = cases[k % len(cases)]
        for rep in range(3):
            got = fn(*args)
            for a, b in zip(got, want):
                assert _same_bits(a, b), f"thread task {k}, call {rep}: differs from the plain version"

    with ThreadPoolExecutor(4) as pool:
        list(pool.map(run, range(12)))


def test_host_alpha_rounds_zero_rays_and_refusals(host_kernel, banners):
    """No ray: no launch and empty outputs. The C entry refuses a scratch
    too small for the tree, 2^31 rays and a pack without its plane."""
    planars, pack, (o, d, t_lim, seed, need) = banners
    host_kernel("w16")
    planar = planars[16]
    key = tf.launch_key("alpha_rounds", 16)
    before = tf.LAUNCHES[key]
    none = ta._alpha_rounds_cuda(planar, pack, o[:0], d[:0], t_lim[:0], seed[:0], need[:0], True)
    assert tf.LAUNCHES[key] == before and all(x.numel() == 0 for x in none)
    lib = tf._load(16)
    slots = lib.vkrt_machine_slots(tf.ROUNDS, 0, 0)
    assert slots > 0 and lib.vkrt_machine_occupancy(tf.ROUNDS, 1, 0) > 0
    words = lib.vkrt_traverse_ab_words(planar.stack_depth, slots)
    n = 8
    out = [torch.empty(n, dtype=dt) for dt in (torch.float32, torch.int32, torch.float32,
                                               torch.float32, torch.int64, torch.int32)]
    args = lambda scratch, n_rays, n_plane: (  # noqa: E731
        1, 16, planar.rows.data_ptr(), planar.stack_depth, o.data_ptr(), d.data_ptr(),
        t_lim.data_ptr(), None, seed.data_ptr(), pack.rows.data_ptr(), pack.rows.shape[0],
        pack.alpha_plane.data_ptr(), n_plane, pack.atlas_width, n_rays, ta._MAX_ROUNDS,
        scratch.data_ptr(), scratch.numel(), slots, *(x.data_ptr() for x in out), None)
    plane = pack.alpha_plane.numel()
    small = torch.zeros(words - 1, dtype=torch.int32)
    enough = torch.zeros(words, dtype=torch.int32)
    assert lib.vkrt_alpha_rounds(*args(small, n, plane)) != 0
    assert lib.vkrt_alpha_rounds(*args(enough, 2**31, plane)) != 0
    assert lib.vkrt_alpha_rounds(*args(enough, n, 0)) != 0
    assert lib.vkrt_alpha_rounds(*args(enough, n, plane)) == 0


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_host_alpha_rounds_deep_cloud(host_kernel, kind):
    """``chip_smoke.alpha_cloud`` (a single-level alpha tree whose rays
    push past the sixteen shared stack entries) with the card's layout:
    bit for bit against the loop, the deepest stack past 16."""
    rng = np.random.default_rng(41)
    planar, pack, rays = chip_smoke.alpha_cloud(rng, 1024, "cpu")
    host_kernel("w16")
    _, loop = _check_rounds(planar, pack, rays, kind == "closest", f"cloud {kind}")
    assert (loop[1] >= 0).any()
    assert 16 < tf.stack_reached(16, "cpu") <= planar.stack_depth


STACK = 30  # opacity-0 panels above an alpha-1 one: more than the cap


def _quad(z, r=2.0):
    return np.asarray([[-r, -r, z], [r, -r, z], [r, r, z], [-r, r, z]], float)


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_host_alpha_rounds_cap_each_ray_at_24(host_kernel, kind):
    """``tests/test_torch_machines.py``'s stack through the kernel: an
    opaque backstop at z = 0, an alpha-1 BLEND panel at z = 1 and ``STACK``
    opacity-0 ones above it, rays straight down from z = 10. Every active
    ray rejects one panel a round and stops after exactly 24 rounds with
    nothing accepted, its seed advanced by 24 PCG steps; inactive rays keep
    their seeds and count no step; bit for bit against the loop."""
    quad = np.asarray([[0, 1, 2], [0, 2, 3]])
    b = GeometryBuilder()
    b.add_mesh(_quad(0.0, 10.0), quad, 0)
    b.add_mesh(_quad(1.0), quad, 1, alpha_mode=S.ALPHA_BLEND)
    for k in range(STACK):
        b.add_mesh(_quad(1.2 + 0.2 * k), quad, 2, alpha_mode=S.ALPHA_BLEND)
    geom = b.build()
    mats = S.make_materials([
        dict(base_color_factor=[0.5, 0.5, 0.5, 1.0]),
        dict(base_color_factor=[1.0, 1.0, 1.0, 1.0], alpha_mode=S.ALPHA_BLEND),
        dict(base_color_factor=[1.0, 1.0, 1.0, 0.0], alpha_mode=S.ALPHA_BLEND),
    ]).to("cpu")
    pack = make_alpha_pack(mats, S.dummy_atlas().to("cpu"),
                           torch.as_tensor(np.asarray(geom.tri_material)).long())
    planar = build_accel_bundle(geom).to("cpu").alpha_planar
    g = np.random.default_rng(81)
    n = 40
    o = torch.tensor(np.stack([g.uniform(-1.5, 1.5, n), g.uniform(-1.5, 1.5, n),
                               np.full(n, 10.0)], -1), dtype=torch.float32)
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(n, 1)
    seed = torch.tensor(g.integers(0, 2**32, n), dtype=torch.int64)
    act = torch.tensor(g.random(n) < 0.9)
    host_kernel("w16")
    kern, _ = _check_rounds(planar, pack, (o, d, torch.full((n,), 10.0), seed, act),
                            kind == "closest", f"stack {kind}")
    assert not (kern[1] >= 0).any()
    s = seed.numpy().astype(np.uint64)
    for _ in range(ta._MAX_ROUNDS):
        s = (s * 747796405 + 2891336453) & 0xFFFFFFFF
    a = act.numpy()
    np.testing.assert_array_equal(kern[4].numpy()[a], s.astype(np.int64)[a])
    np.testing.assert_array_equal(kern[4].numpy()[~a], seed.numpy()[~a])
    assert (kern[5][~act] == 0).all() and (kern[5][act] > 0).all()


N_SET_RAYS = 1001


@pytest.mark.parametrize("case", chip_smoke.PREFILTER_CASES)
@pytest.mark.parametrize("name", [b[0] for b in BUILDS])
def test_host_folded_rounds_on_prefilter_sets(host_kernel, banners, name, case):
    """The rounds kernel's intake runs the alpha pass's need line: on each
    of ``chip_smoke.prefilter_rays``' sets (NaN, +-inf, +-0, components
    below 1e-20, subnormals, t_limit <= 0, INF and NaN) toward the atrium's
    alpha tree, with ``active`` absent, about half and none, closest (with
    culling) and any hit by turns, the kernel's outputs bit for bit those of
    the round loop fed ``_alpha_need_plain``'s mask (what ``_alpha_rounds``
    runs on the CPU); the rays that need nothing keep the outputs of a
    masked ray, and the intake counts every ray fetched and the needing
    ones."""
    planars, pack, _ = banners
    width = dict((b[0], b[1]) for b in BUILDS)[name]
    planar = planars[width]
    host_kernel(name)
    k = chip_smoke.PREFILTER_CASES.index(case)
    rng = np.random.default_rng(70 + 7 * width + k)
    o, d, t_lim = chip_smoke.prefilter_rays(case, planar, N_SET_RAYS, rng)
    seed = torch.tensor(rng.integers(0, 2**32, N_SET_RAYS), dtype=torch.int64)
    for j, active in enumerate(chip_smoke.PREFILTER_ACTIVE):
        act = chip_smoke.prefilter_active(active, N_SET_RAYS, rng)
        cull = (k + j) % 2 == 0
        what = f"{name} {case} active {active} {'closest' if cull else 'any'}"
        kern, loop = _check_rounds(planar, pack, (o, d, t_lim, seed, act), cull, what)
        need = tf._alpha_need_plain(planar, o, d, t_lim, act)
        assert tf._AB_GRIDS[width].intake("cpu") == (N_SET_RAYS, int(need.sum())), what
        assert (kern[0][~need] == tf.INF).all() and (kern[1][~need] == -1).all()
        assert (kern[2][~need] == 0).all() and (kern[3][~need] == 0).all()
        assert torch.equal(kern[4][~need], seed[~need]) and (kern[5][~need] == 0).all()
        if active != "none" and case != "t_limit":
            assert 0 < int(need.sum()) < N_SET_RAYS, what


@pytest.mark.parametrize("name", ["w16", "w32"])
def test_host_need_as_active_gives_the_same_outputs(host_kernel, banners, name):
    """A need mask given to the kernel as ``active`` (the form of the alpha
    pass before the fold: ``vkrt_root_prefilter``, then the rounds on its
    mask) gives the outputs of the pass's own ``active``, bit for bit: every
    ray the mask holds hits a root child. Banner rays (95% active) and the
    random prefilter set."""
    planars, pack, rays = banners
    width = dict((b[0], b[1]) for b in BUILDS)[name]
    planar = planars[width]
    host_kernel(name)
    o, d, t_lim = chip_smoke.prefilter_rays("random", planar, N_SET_RAYS,
                                            np.random.default_rng(90 + width))
    sets = [rays, (o, d, t_lim, rays[3][:N_SET_RAYS], rays[4][:N_SET_RAYS])]
    for k, (o, d, t_lim, seed, act) in enumerate(sets):
        for cull in (True, False):
            own = ta._alpha_rounds_cuda(planar, pack, o, d, t_lim, seed, act, cull)
            own_intake = tf._AB_GRIDS[width].intake("cpu")
            need = tf._alpha_need_cuda(planar, o, d, t_lim, act)
            assert torch.equal(need, tf._alpha_need_plain(planar, o, d, t_lim, act))
            via = ta._alpha_rounds_cuda(planar, pack, o, d, t_lim, seed, need, cull)
            for i, field in enumerate(ROUNDS_OUT):
                assert _same_bits(own[i], via[i]), f"{name} set {k} cull {cull}: {field}"
            assert own_intake == tf._AB_GRIDS[width].intake("cpu") == (o.shape[0],
                                                                        int(need.sum()))


# ---------------------------------------------------------------------------
# The alpha pass's root prefilter (vkrt_root_prefilter)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", chip_smoke.PREFILTER_CASES)
@pytest.mark.parametrize("name", ["w16", "w32"])
def test_host_root_prefilter_matches_plain(host_kernel, atrium_bundles, name, case):
    """``traverse_fused._alpha_need_cuda`` on the host library against
    ``_alpha_need_plain`` on the atrium's alpha tree, each of
    ``chip_smoke.prefilter_rays``'s sets with ``active`` absent, about half
    and none: the same bools, one launch a call. The host build's fminf /
    fmaxf drop a NaN as the card's do, so the NaN set holds the kernel to
    torch's propagation here too."""
    width = dict((b[0], b[1]) for b in BUILDS)[name]
    planar = atrium_bundles[1][width].alpha_planar
    host_kernel(name)
    key = tf.launch_key("root_prefilter", width)
    rng = np.random.default_rng(31 * width + chip_smoke.PREFILTER_CASES.index(case))
    o, d, t_limit = chip_smoke.prefilter_rays(case, planar, 3001, rng)
    for active in chip_smoke.PREFILTER_ACTIVE:
        act = chip_smoke.prefilter_active(active, 3001, rng)
        before = tf.LAUNCHES[key]
        kern = tf._alpha_need_cuda(planar, o, d, t_limit, act)
        assert tf.LAUNCHES[key] == before + 1
        plain = tf._alpha_need_plain(planar, o, d, t_limit, act)
        assert kern.dtype == torch.bool and torch.equal(kern, plain), (
            f"{name} {case} {active}: {int((kern != plain).sum())} rays differ")
        if active != "none":
            assert 0 < int(plain.sum()) < 3001


def test_host_root_prefilter_zero_rays_and_refusals(host_kernel, atrium_bundles):
    """No ray: no launch and an empty mask. The wrapper refuses rays it does
    not take (an active mask that is not bool), the C entry another width."""
    planar = atrium_bundles[1][16].alpha_planar
    host_kernel("w16")
    o, d, t_limit = chip_smoke.prefilter_rays("random", planar, 64, np.random.default_rng(2))
    key = tf.launch_key("root_prefilter", 16)
    before = tf.LAUNCHES[key]
    none = tf._alpha_need_cuda(planar, o[:0], d[:0], t_limit[:0], None)
    assert tf.LAUNCHES[key] == before and none.shape == (0,) and none.dtype == torch.bool
    with pytest.raises(ValueError, match="active"):
        tf._alpha_need_cuda(planar, o, d, t_limit, torch.ones(64, dtype=torch.uint8))
    need = torch.empty(64, dtype=torch.bool)
    assert tf._load(16).vkrt_root_prefilter(32, planar.rows.data_ptr(), o.data_ptr(),
                                            d.data_ptr(), t_limit.data_ptr(), None, 64,
                                            need.data_ptr(), None) != 0


# The host shim's persistent grid: one SM of two resident blocks, each
# launched as 256 one-thread blocks, a ray a thread.
HOST_STRIDE_RAYS = 2 * 256


@pytest.mark.parametrize("name", ["w16", "w32"])
def test_host_root_prefilter_counts(host_kernel, atrium_bundles, name):
    """The standalone prefilter on ray counts that fill no block (1, 3, 4,
    5, 255), that fill the persistent grid's stride exactly, and that span
    more than one stride (517, 1021, 1931: the grid strides over the rays):
    each of
    ``chip_smoke.prefilter_rays``' sets (NaN, +-inf, +-0 and subnormals
    included) with ``active`` absent, about half and none, equal to
    ``_alpha_need_plain`` bool for bool."""
    width = dict((b[0], b[1]) for b in BUILDS)[name]
    planar = atrium_bundles[1][width].alpha_planar
    host_kernel(name)
    counts = (1, 3, 4, 5, 255, HOST_STRIDE_RAYS, HOST_STRIDE_RAYS + 5, 1021,
              3 * HOST_STRIDE_RAYS + 395)
    rng = np.random.default_rng(17 * width)
    for case in chip_smoke.PREFILTER_CASES:
        rays = chip_smoke.prefilter_rays(case, planar, counts[-1], rng)
        for active in chip_smoke.PREFILTER_ACTIVE:
            act = chip_smoke.prefilter_active(active, counts[-1], rng)
            for n in counts:
                sub = [x[:n] for x in rays] + [None if act is None else act[:n]]
                kern = tf._alpha_need_cuda(planar, *sub)
                plain = tf._alpha_need_plain(planar, *sub)
                assert kern.dtype == torch.bool and torch.equal(kern, plain), (
                    f"{name} {case} {active} {n}: {int((kern != plain).sum())} rays differ")
