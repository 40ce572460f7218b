"""The persistent mode a/b traversal (``vkrt_traverse_ab`` in
``csrc/traverse.cu``) run on the CPU: the CUDA source compiled as host C++
under the stand-in header ``tests/cuda_host_shim/cuda_runtime.h`` (blocks of
one thread, a one-lane warp, atomics as plain adds, each rounded float
intrinsic one IEEE single operation, g++ ``-ffp-contract=off``), bound
through the port's own ctypes wrapper, and held against the plain twin
``traverse_fused._traverse_plain`` on the 2x2-bay atrium at widths 16 and
32: t, tri, u, v and steps bit for bit. A build with two shared stack
entries runs the global spill. Skips where g++ is missing.

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

from vk_raytrace_torch import cuda_build
from vk_raytrace_torch.models import procedural
from vk_raytrace_torch.ops import traverse_fused as tf
from vk_raytrace_torch.ops.bvh8 import build_accel_bundle

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
def atrium():
    geom = procedural.atrium_scene(**SMALL_ATRIUM)[0]
    return geom, {w: build_accel_bundle(geom, width=w).opaque_planar.to("cpu")
                  for w in tf.WIDTHS}


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


def test_host_kernel_refuses(host_kernel, atrium):
    """Modes a/b from the root run only in the a/b entry, which refuses a
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
    assert lib.vkrt_traverse(0, 1, 16, planar.rows.data_ptr(), planar.stack_depth, o.data_ptr(),
                             d.data_ptr(), t.data_ptr(), None, None, n, *ptr, None, None,
                             None) != 0
    slots = lib.vkrt_traverse_ab_slots(0)
    words = lib.vkrt_traverse_ab_words(40, slots)
    assert lib.vkrt_traverse_ab_words(8, slots) == 4  # a shallow tree: the head alone
    assert words > 4 and (words - 4) % slots == 0  # a column of spill entries per thread
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
