"""The capped entry (``vkrt_traverse_capped`` in ``csrc/traverse.cu``: mode
a from the root stopped after ``max_steps`` nodes a ray, and its no-gather
timing variant, on the persistent node loops of modes a/b) run on the CPU:
the CUDA source compiled as host C++ under ``tests/cuda_host_shim`` (blocks
of one thread, g++ ``-ffp-contract=off``; the ``host_libs`` builds of
``tests/test_torch_traverse_host.py``: widths 16 and 32, and width 16 with
two shared stack entries), bound through the port's own ctypes wrapper and
held against the plain twin ``traverse_fused._traverse_plain(...,
max_steps=, nogather=)`` on the 2x2-bay atrium: t, tri, u, v and steps bit
for bit.

Caps 0, 1, 8, kShStack - 1, kShStack and 40, capped and no-gather (on
``own_rows``), so both sides of the stack's line run at both width-16
builds: below kShStack steps the shared entries as a ring, with no spill;
at or above, and at every cap at width 32, the stack with its exact global
spill (to the tree's bound, or 128 entries
for no-gather, whose made-up rows push past 128 at both widths within 40
nodes: those pushes are dropped as in the twin). On the atrium a no-gather
ray never hits (its made-up triangles miss) and a capped ray's stack stays
shallow, so the outputs barely depend on the stack; a dense random table
(every child box around the rays' origins, refs to random rows and leaf
counts, the box lanes read as triangles that the rays do hit) pushes W - 1
entries at every interior node and picks each hit by the leaf counts it
pops, so a wrong stack entry changes t and tri. Also zero rays and the
refusals (a no-gather table with fewer rows than rays, a stack bound past
128, a negative cap, a scratch too small).
"""

import numpy as np
import pytest
import torch

from test_torch_traverse import one_torch_thread  # noqa: F401
from test_torch_traverse_host import BUILDS, _rays, _same_bits
from test_torch_traverse_host import atrium, atrium_bundles, host_kernel, host_libs  # noqa: F401
from vk_raytrace_torch.ops import traverse_fused as tf

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# The caps, with kShStack the build's shared stack entries.
CAPS = ("0", "1", "8", "kShStack-1", "kShStack", "40")
HEAD = 8  # kScratchHead: the scratch words before the spill
DENSE_ROWS = 512  # rows of the dense table, and its rays


@pytest.fixture(autouse=True)
def _capped_grids(monkeypatch):
    """The capped entry's scratch, fresh for the host libraries."""
    monkeypatch.setattr(tf, "_CAPPED_GRIDS", {w: tf.PersistentGrid() for w in tf.WIDTHS})


def _shared(name):
    """kShStack of build ``name``."""
    return {b[0]: b[2] for b in BUILDS}[name] or 16


def _cap(name, cap):
    k = _shared(name)
    return {"kShStack-1": k - 1, "kShStack": k}[cap] if cap.startswith("k") else int(cap)


def _dense(width, n, seed):
    """A table of ``n`` random rows ``width`` wide and ``n`` rays from near
    the origin: every child box holds the origins; the root's refs are
    interior rows, the other rows' mostly (85%) leaves of random rows and
    counts, so a ray pops runs of leaves pushed W - 1 at a time; the leaf
    meta double-sided. Read as a leaf, a row's box lanes are triangles
    around the origin."""
    rng = np.random.default_rng(seed)
    W, LT = width, width // 2
    rows = np.zeros((n, 8 * W), np.float32)
    rows[:, :3 * W] = rng.uniform(-2.0, -0.01, (n, 3 * W))
    rows[:, 3 * W:6 * W] = rng.uniform(0.01, 2.0, (n, 3 * W))
    leaf = -(rng.integers(0, n, (n, W)) * LT + rng.integers(0, LT, (n, W))) - 1
    is_leaf = rng.random((n, W)) < 0.85
    is_leaf[0] = False
    rows[:, 6 * W:7 * W] = np.where(is_leaf, leaf, rng.integers(0, n, (n, W)))
    rows[:, 15 * LT:16 * LT] = np.arange(n * LT).reshape(n, LT) * 4 + 1
    o = rng.uniform(-0.005, 0.005, (n, 3))
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    return tf.PlanarScene(f32(rows), tf.CAPPED_STACK, W), f32(o), f32(d)


@pytest.mark.parametrize("nogather", [False, True], ids=["capped", "nogather"])
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("name", [b[0] for b in BUILDS])
@pytest.mark.parametrize("scene", ["atrium", "dense"])
def test_host_capped_matches_twin(host_kernel, atrium, scene, name, cap, nogather):
    geom, planars = atrium
    width = {b[0]: b[1] for b in BUILDS}[name]
    max_steps = _cap(name, cap)
    host_kernel(name)
    if scene == "atrium":
        o, d, t_max, _ = _rays(geom, 11)
        planar = tf.own_rows(planars[width], o.shape[0]) if nogather else planars[width]
    else:
        planar, o, d = _dense(width, DENSE_ROWS, 7)
        t_max = torch.full((DENSE_ROWS,), tf.INF)
    lib = tf._load(width)
    key = tf.launch_key("nogather" if nogather else "capped", width)
    before = tf.LAUNCHES[key]
    kern = tf._traverse_capped_cuda(planar, o, d, t_max, max_steps, nogather)
    assert tf.LAUNCHES[key] == before + 1
    twin = tf.traverse_capped(planar, o, d, t_max, max_steps, nogather=nogather)
    for k, what in enumerate(("t", "tri", "u", "v", "steps")):
        assert _same_bits(kern[k], twin[k]), f"{name} cap {max_steps}: {what} differs"
    steps, hits = twin[4], float((twin[1] >= 0).float().mean())
    deepest = tf.capped_stack_reached(width, o.device)
    if nogather:  # every ray runs the cap, starting over at the root
        assert bool((steps == max_steps).all())
    elif scene == "atrium":
        assert int(steps.max()) == min(max_steps, int(tf.traverse(planar, o, d, t_max)[4].max()))
        assert deepest <= planar.stack_depth
        if max_steps >= 8:
            assert 0.3 < hits < 0.999
    if scene == "dense" and max_steps >= 8:
        assert hits > 0.2  # the leaf counts the rays pop decide their hits
    # Which stack ran: at width 16 the ring (the scratch's head alone) below
    # kShStack steps, else the spilling stack.
    ring = width == 16 and max_steps < _shared(name)
    assert tf.shared_stack(width) == _shared(name)
    words = lib.vkrt_traverse_capped_words(planar.stack_depth, max_steps, int(nogather), 1024)
    assert (words == HEAD) == ring
    if (nogather or scene == "dense") and max_steps == 40:
        assert deepest > tf.CAPPED_STACK  # pushes past the stack, dropped
    if name.endswith("spill") and max_steps >= 8:
        assert deepest > _shared(name)  # entries in the global spill
    assert tf.capped_occupancy(width, max_steps, nogather) > 0
    # The scratch is reused by the next call: the same result.
    again = tf._traverse_capped_cuda(planar, o, d, t_max, max_steps, nogather)
    assert all(_same_bits(a, b) for a, b in zip(kern[:5], again[:5]))


def test_host_capped_zero_rays_and_refusals(host_kernel, atrium):
    geom, planars = atrium
    host_kernel("w16")
    planar = planars[16]
    lib = tf._load(16)
    o, d, t_max, _ = _rays(geom, 5)
    empty = torch.zeros((0, 3)), torch.zeros((0, 3)), torch.zeros(0)
    for nogather in (False, True):
        key = tf.launch_key("nogather" if nogather else "capped", 16)
        before = tf.LAUNCHES[key]
        out = tf._traverse_capped_cuda(planar, *empty, 8, nogather)
        assert [x.numel() for x in out[:5]] == [0] * 5 and tf.LAUNCHES[key] == before
    # The wrapper's refusals, before any launch.
    few = planar.rows.shape[0] + 1
    big = o.repeat(2, 1)[:few], d.repeat(2, 1)[:few], t_max.repeat(2)[:few]
    with pytest.raises(ValueError, match="no-gather"):
        tf.traverse_capped(planar, *big, 8, nogather=True)
    with pytest.raises(ValueError, match="stack bound"):
        deep = tf.PlanarScene(planar.rows, 129, 16)
        tf._traverse_capped_cuda(deep, o, d, t_max, 8, False)
    with pytest.raises(ValueError, match="max_steps"):
        tf.traverse_capped(planar, o, d, t_max, -1)
    # The C entry's own refusals (cudaErrorInvalidValue, 1 under the shim).
    R = o.shape[0]
    outs = tf._outputs(R, o.device, False)[:5]
    slots = lib.vkrt_traverse_capped_slots(40, 1)
    scratch = torch.zeros(lib.vkrt_traverse_capped_words(planar.stack_depth, 40, 1, slots),
                          dtype=torch.int32)

    def call(n_rows, stack_depth, max_steps, nogather, words, width=16):
        return lib.vkrt_traverse_capped(
            width, planar.rows.data_ptr(), n_rows, stack_depth, o.data_ptr(), d.data_ptr(),
            t_max.data_ptr(), R, max_steps, nogather, scratch.data_ptr(), words, slots,
            *(x.data_ptr() for x in outs), 0)

    n_rows = planar.rows.shape[0]
    assert n_rows < R
    assert call(n_rows, planar.stack_depth, 8, 1, scratch.numel()) == 1  # rows < rays
    assert call(n_rows, 129, 8, 0, scratch.numel()) == 1                 # stack past 128
    assert call(n_rows, planar.stack_depth, -1, 0, scratch.numel()) == 1
    assert call(n_rows, planar.stack_depth, 40, 1, scratch.numel() - 1) == 1
    assert call(n_rows, planar.stack_depth, 8, 0, scratch.numel(), width=32) == 1
    assert call(n_rows, planar.stack_depth, 8, 0, scratch.numel()) == 0
