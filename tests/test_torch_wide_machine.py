"""The wide back end's two-level machine (``vkrt_wide_machine``,
``csrc/traverse_wide.cu``) built as host C++ under the stand-in header
``tests/cuda_host_shim/cuda_runtime.h`` (a warp is one lane, the atomics are
plain) and bound through the port's own wrapper ``tlas._wide_machine_cuda``,
against its plain version, the round loop ``tlas._wide_rounds``: every
output (t_best, tri, u, v, inst, seed, steps) bit for bit.

* The small bistro (``detail=0.05``, the scene of ``tests/test_torch_wide.py``;
  its instance table in shared memory): closest and any hit, each pass of the
  instance-level split ("all", "opaque", "alpha") with and without the alpha
  pack, a tenth of the lanes inactive; the same with two stack entries in
  shared memory, so that the spill runs.
* The small plaza of ``tests/test_torch_tlas_scan.py`` (601 instances: the
  global table, the loop's chunked scan): closest and any, every instance
  without the pack and the alpha instances with it.
* One launch counted per pass, none for zero rays; the two-level call
  (``closest_hit_instanced`` / ``any_hit_instanced`` with ``backend="wide"``)
  with every pass on the machine equal to the loops' result, in two launches.
* The round loop's counters of alpha tests and visited rows, which the card's
  bound counts, and the per-lane roots of ``chip_smoke.py``'s phase 35.

The machine on the card against the same loop is
``tests/test_torch_cuda.py::test_wide_machine_matches_round_loop``.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_tlas_scan import _accel_and_pack, _plaza
from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401
from test_torch_wide import host_lib, host_wide  # noqa: F401 (fixtures)
from vk_raytrace_torch import render as port_render
from vk_raytrace_torch.models import procedural
from vk_raytrace_torch.ops import rng as prng
from vk_raytrace_torch.ops import tlas
from vk_raytrace_torch.ops import traverse_fused as tf
from vk_raytrace_torch.ops import traverse_wide as tw
from vk_raytrace_torch.ops.traverse_wide import make_alpha_pack

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 256
OUTPUTS = ("t_best", "tri", "u", "v", "inst", "seed", "steps")


def _rays(rng, pool, inst, targets, lo, hi):
    """N rays from a box [lo, hi]: half toward random triangles of the
    instances ``targets``, half in random directions."""
    origins = rng.uniform(lo, hi, (N, 3))
    o, d = chip_smoke.rays_toward_instances(rng, pool, inst, rng.choice(targets, N), origins,
                                            "cpu")
    rand = torch.tensor(rng.standard_normal((N // 2, 3)), dtype=torch.float32)
    d[N // 2:] = rand / rand.norm(dim=1, keepdim=True)
    return o.contiguous(), d.contiguous()


def _case(acc, pack, pool, inst, lo, hi, seed):
    acc = tlas.with_wide(acc, pool.geometry)
    rng = np.random.default_rng(seed)
    alpha = np.nonzero(np.asarray(acc.inst_alpha))[0]
    o, d = _rays(rng, pool, inst, alpha, lo, hi)
    return dict(acc=acc, pack=pack, o=o, d=d,
                seed=torch.tensor(rng.integers(0, 2**32, N), dtype=torch.int64),
                act=torch.tensor(rng.random(N) < 0.9),
                t_max=torch.tensor(rng.uniform(5.0, 80.0, N), dtype=torch.float32))


@pytest.fixture(scope="module")
def bistro():
    pool, inst, mats, lights, cam, atlas = procedural.bistro_scene(detail=0.05)
    scene = port_render.build_instanced_scene(pool, inst, mats, lights, cam, atlas=atlas)
    pack = make_alpha_pack(scene.materials.to("cpu"), scene.atlas.to("cpu"),
                           torch.as_tensor(np.asarray(pool.geometry.tri_material)).long())
    case = _case(scene.instances.to("cpu"), pack, pool, inst, [-50, 0.5, -10], [50, 8, 10], 3)
    assert 0 < case["acc"].inst.aabb_min.shape[0] <= tlas._DENSE_I_MAX
    return case


@pytest.fixture(scope="module")
def plaza(tmp_path_factory):
    pool, inst, acc, pack = _accel_and_pack(_plaza(tmp_path_factory, "wide_plaza"))
    case = _case(acc, pack, pool, inst, [-25, 0.5, -32], [25, 12, 32], 4)
    assert case["acc"].inst.aabb_min.shape[0] == 601 > tlas._DENSE_I_MAX
    return case


def _same_bits(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _machine_vs_loop(c, part, with_pack, kind):
    """The machine (one counted launch) and the round loop on the case's
    rays; every output bit for bit. Returns the loop's outputs."""
    any_hit = kind == "any"
    t_in = c["t_max"] if any_hit else torch.full((N,), tf.INF)
    args = (c["acc"], c["pack"] if with_pack else None, c["o"], c["d"], t_in, c["seed"],
            c["act"], part, any_hit)
    before = tf.LAUNCHES["wide_machine"]
    kern = tlas._wide_machine_cuda(*args)
    assert tf.LAUNCHES["wide_machine"] == before + 1
    rounds = torch.zeros(N, dtype=torch.int64)
    loop = tlas._wide_rounds(*args, rounds=rounds)
    for name, a, b in zip(OUTPUTS, kern, loop):
        assert _same_bits(a.to(b.dtype), b), name
    assert (loop[1] >= 0).any() and int(rounds.max()) >= 2
    assert not c["act"].all() and (loop[6][~c["act"]] == 0).all()
    return loop


@pytest.mark.parametrize("kind", ["closest", "any"])
@pytest.mark.parametrize("with_pack", [False, True])
@pytest.mark.parametrize("part", ["all", "opaque", "alpha"])
def test_machine_matches_round_loop_bistro(host_wide, bistro, part, with_pack, kind):
    """The shared table: each pass of the split, with and without the pack."""
    host_wide("shared")
    loop = _machine_vs_loop(bistro, part, with_pack, kind)
    if with_pack and part != "opaque":
        assert not torch.equal(loop[5], bistro["seed"])  # alpha tests drew


@pytest.mark.parametrize("kind", ["closest", "any"])
@pytest.mark.parametrize("part", ["all", "alpha"])
def test_machine_spill_matches_round_loop_bistro(host_wide, bistro, part, kind):
    """Two stack entries a thread in shared memory: the rest in the spill."""
    host_wide("spill")
    _machine_vs_loop(bistro, part, part == "alpha", kind)
    assert tw.stack_reached("cpu") > 2  # the spill ran


@pytest.mark.parametrize("kind", ["closest", "any"])
@pytest.mark.parametrize("part", ["all", "alpha"])
def test_machine_matches_round_loop_plaza(host_wide, plaza, part, kind):
    """The global table (601 instances), every instance without the pack
    and the alpha instances with it, against the loop's chunked scan."""
    host_wide("shared")
    _machine_vs_loop(plaza, part, part == "alpha", kind)


def test_zero_rays_launch_nothing(host_wide, bistro):
    host_wide("shared")
    e3, e = torch.zeros((0, 3)), torch.zeros(0)
    before = tf.LAUNCHES["wide_machine"]
    out = tlas._wide_machine_cuda(bistro["acc"], bistro["pack"], e3, e3, e,
                                  torch.zeros(0, dtype=torch.int64),
                                  torch.zeros(0, dtype=torch.bool), "alpha", False)
    assert tf.LAUNCHES["wide_machine"] == before
    assert all(x.shape == (0,) for x in out)


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_two_level_call_launches_once_a_pass(host_wide, bistro, monkeypatch, kind):
    """``closest_hit_instanced`` / ``any_hit_instanced`` (``backend="wide"``)
    with each pass sent to the machine: the loops' hit and seed bit for bit,
    in one launch a pass (the opaque instances, then the alpha ones)."""
    host_wide("shared")
    c = bistro
    any_hit = kind == "any"

    def call():
        if any_hit:
            return tlas.any_hit_instanced(c["acc"], c["pack"], c["o"], c["d"], c["t_max"],
                                          seed=c["seed"], active=c["act"], backend="wide")
        return tlas.closest_hit_instanced(c["acc"], c["pack"], c["o"], c["d"], seed=c["seed"],
                                          active=c["act"], backend="wide")

    want = call()
    monkeypatch.setattr(tlas, "_wide_pass", tlas._wide_machine_cuda)
    before = tf.LAUNCHES["wide_machine"]
    got = call()
    assert tf.LAUNCHES["wide_machine"] == before + 2
    (hit_w, seed_w), (hit_g, seed_g) = want, got
    assert torch.equal(seed_g, seed_w)
    for a, b in zip(hit_g if not any_hit else (hit_g,), hit_w if not any_hit else (hit_w,)):
        assert _same_bits(a.to(b.dtype), b)


def test_round_loop_counters(bistro):
    """The round loop's counters (what the machine's bound counts on the
    card): ``draws`` the alpha tests of each ray, whose seed advanced that
    many PCG steps; ``seen`` the BLAS rows the rounds visit, interior rows
    1 and leaf rows 2; the outputs those of the loop without them."""
    c = bistro
    args = (c["acc"], c["pack"], c["o"], c["d"], torch.full((N,), tf.INF), c["seed"], c["act"],
            "alpha", False)
    seen = torch.zeros(c["acc"].blas.rows.shape[0], dtype=torch.int8)
    draws = torch.zeros(N, dtype=torch.int64)
    out = tlas._wide_rounds(*args, seen=seen, draws=draws)
    for a, b in zip(out, tlas._wide_rounds(*args)):
        assert _same_bits(a, b)
    assert int(draws.sum()) > 0 and (draws[~c["act"]] == 0).all()
    s = c["seed"].clone()
    for k in range(int(draws.max())):
        s = torch.where(draws > k, prng.rand(s)[0], s)
    assert torch.equal(s, out[5])
    assert (seen == 1).any() and (seen == 2).any()


def test_interior_rows_for_per_lane_roots(bistro):
    """``chip_smoke.wide_interior_rows``, the per-lane roots of phase 35:
    the root and rows below it, each an interior row (a traversal that
    starts there marks it 1), unique."""
    blas = bistro["acc"].blas
    rows = chip_smoke.wide_interior_rows(blas, 2)
    assert rows[0] == 0 and len(rows) > 1 and len(np.unique(rows)) == len(rows)
    n = len(rows)
    seen = torch.zeros(blas.rows.shape[0], dtype=torch.int8)
    d = torch.nn.functional.normalize(torch.ones(n, 3), dim=1)
    tw._traverse_wide_plain(blas, None, torch.zeros(n, 3), d, torch.full((n,), tf.INF), None,
                            None, False, root0=torch.tensor(rows, dtype=torch.int32), seen=seen)
    assert (seen[torch.as_tensor(rows)] == 1).all()
