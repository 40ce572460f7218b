"""The alpha pass's root prefilter (``traverse_fused.alpha_need``): which
rays the single-level alpha rounds trace. Its plain version
``_alpha_need_plain`` is held exactly (equal bools) against the reference's
own expression before its rounds (``vk_raytrace_tpu/ops/traverse_alpha.py:
175-183``): ``active & (t_limit > 0) & traverse_fused.root_prefilter(...)``,
on the alpha tree of the 2x2-bay atrium at widths 16 and 32, the same
tables on both sides. The rays are ``chip_smoke.prefilter_rays``'s, made
from numpy seeds: random rays from inside and outside the root children's
boxes, rays along the axes with +-0 and normal components below 1e-20, NaN
and +-inf rays, t_limit <= 0, INF, inf and NaN; ``active`` absent, about
half and none.

Subnormals part the two by design: XLA on the CPU (as the TPU) runs with
subnormals flushed to zero, torch on both devices keeps them (-1e-40 < 0
is false there, and 1 / 3e38 is 0). So on rays where a subnormal enters
(a component of the origin or the direction, or the reciprocal of a
direction component) the two may differ, and only there; every other ray of
that set is held exactly.

The CUDA kernel ``vkrt_root_prefilter`` is held bit for bit against the
plain version on the same sets, subnormals included, by
``tests/test_torch_traverse_host.py`` (the source built as host C++) and
``chip_smoke.py`` phase 40 (on the card)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401 (fixtures)
from vk_raytrace_tpu.ops import traverse_fused as ref_tf
from vk_raytrace_torch.models import procedural
from vk_raytrace_torch.ops import traverse_alpha as ta
from vk_raytrace_torch.ops import traverse_fused as tf
from vk_raytrace_torch.ops.bvh8 import build_accel_bundle

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL_ATRIUM = dict(bays_x=2, bays_z=2, column_segments=16, column_rows=12)
N = 4099
EXACT_CASES = [c for c in chip_smoke.PREFILTER_CASES if c != "subnormal"]


@pytest.fixture(scope="module")
def alpha_trees():
    """The small atrium's alpha tree at each row width, on the CPU."""
    g = procedural.atrium_scene(**SMALL_ATRIUM)[0]
    return {w: build_accel_bundle(g, width=w).alpha_planar.to("cpu") for w in tf.WIDTHS}


def _rays(planar, case, active, seed):
    rng = np.random.default_rng(seed)
    o, d, t_limit = chip_smoke.prefilter_rays(case, planar, N, rng)
    return o, d, t_limit, chip_smoke.prefilter_active(active, N, rng)


def _reference(planar, o, d, t_limit, active):
    """The reference's expression on the same table and rays."""
    ref = ref_tf.PlanarScene(jnp.asarray(planar.rows.numpy()), planar.stack_depth, planar.width)
    t = jnp.asarray(t_limit.numpy())
    need = (t > 0.0) & ref_tf.root_prefilter(ref, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), t)
    if active is not None:
        need = need & jnp.asarray(active.numpy())
    return torch.from_numpy(np.array(need))


@pytest.mark.parametrize("active", chip_smoke.PREFILTER_ACTIVE)
@pytest.mark.parametrize("case", EXACT_CASES)
@pytest.mark.parametrize("width", tf.WIDTHS)
def test_plain_matches_reference(alpha_trees, width, case, active):
    planar = alpha_trees[width]
    seed = 100 * width + 10 * EXACT_CASES.index(case) + chip_smoke.PREFILTER_ACTIVE.index(active)
    o, d, t_limit, act = _rays(planar, case, active, seed)
    need = tf._alpha_need_plain(planar, o, d, t_limit, act)
    want = _reference(planar, o, d, t_limit, act)
    assert need.dtype == torch.bool and need.shape == (N,)
    assert torch.equal(need, want), int((need != want).sum())
    if active != "none":
        assert 0 < int(need.sum()) < N  # both outcomes occur


def _subnormal(x):
    x = x.abs()
    return (x > 0) & (x < torch.finfo(torch.float32).tiny)


@pytest.mark.parametrize("width", tf.WIDTHS)
def test_subnormals_part_only_where_the_reference_flushes(alpha_trees, width):
    planar = alpha_trees[width]
    o, d, t_limit, act = _rays(planar, "subnormal", "absent", 7 + width)
    need = tf._alpha_need_plain(planar, o, d, t_limit, act)
    want = _reference(planar, o, d, t_limit, act)
    enters = (_subnormal(o) | _subnormal(d) | _subnormal(1.0 / d)).any(1)
    assert int(enters.sum()) > N // 2
    assert torch.equal(need[~enters], want[~enters])
    assert bool((need != want).any())  # the flush shows on these rays


def test_alpha_need_dispatches_on_device(alpha_trees):
    """CPU tensors run the plain version; a device with neither raises."""
    planar = alpha_trees[16]
    o, d, t_limit, act = _rays(planar, "random", "partial", 3)
    assert torch.equal(tf.alpha_need(planar, o, d, t_limit, act),
                       tf._alpha_need_plain(planar, o, d, t_limit, act))
    meta = [x.to("meta") for x in (o, d, t_limit)]
    with pytest.raises(ValueError, match="no root prefilter"):
        tf.alpha_need(planar, *meta)


@pytest.mark.parametrize("cull", [True, False])
def test_alpha_rounds_take_their_need_from_alpha_need(alpha_trees, monkeypatch, cull):
    """The alpha pass asks ``alpha_need`` for its need mask, once a call,
    and traces exactly those rays."""
    planar = alpha_trees[16]
    o, d, t_limit, act = _rays(planar, "random", "partial", 5)
    calls, traced = [], []
    real_need, real_rounds = tf.alpha_need, ta._rounds

    def need(*args):
        calls.append(real_need(*args))
        return calls[-1]

    def rounds(planar_, pack, origin, direction, t_lim, seed, need0, cull_):
        traced.append(need0)
        return real_rounds(planar_, pack, origin, direction, t_lim, seed, need0, cull_)

    monkeypatch.setattr(tf, "alpha_need", need)
    monkeypatch.setattr(ta, "_rounds", rounds)
    ta._alpha_rounds(planar, None, o, d, t_limit, None, act, cull)
    assert len(calls) == 1 and len(traced) == 1 and traced[0] is calls[0]
    assert torch.equal(calls[0], tf._alpha_need_plain(planar, o, d, t_limit, act))
