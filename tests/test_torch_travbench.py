"""The traversal micro-bench's entry points on the CPU: the step-capped and
no-gather twins (``traverse_capped``, the plain versions of the kernel's
capped entry) and ``python -m vk_raytrace_torch.travbench --device cpu``.

The capped twin must equal the uncapped one exactly once the cap is at
least every ray's node count, and stop each ray at ``min(cap, nodes)``.
The no-gather twin's hits are wrong by design; it must be deterministic,
read only the rays' own rows, and run exactly ``cap`` nodes per ray.

Both are held against the reference's step kernel (Pallas, interpret mode)
stepped as ``scripts/stepbench.py`` steps it: tri and node counts exact, t
within rtol 1e-5 / atol 1e-6 (``tests/test_torch_traverse.py``; XLA on the
CPU contracts the leaf's multiply-adds), on the lanes the test docstring
names.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401 (fixtures)
from vk_raytrace_tpu.ops import traverse_fused as ref_tf
from vk_raytrace_torch import travbench
from vk_raytrace_torch.models import procedural
from vk_raytrace_torch.ops import traverse_fused as tf
from vk_raytrace_torch.ops.bvh8 import build_accel_bundle

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def atrium():
    geom, _, _, cam, _ = procedural.atrium_scene(**travbench.SMALL_ATRIUM)
    planars = {w: build_accel_bundle(geom, width=w).opaque_planar.to("cpu") for w in tf.WIDTHS}
    o, d = travbench.camera_rays(cam, 600, "cpu")
    return planars, o, d


@pytest.mark.parametrize("width", tf.WIDTHS)
def test_capped_twin_stops_each_ray_at_its_cap(atrium, width):
    planars, o, d = atrium
    planar = planars[width]
    t_max = torch.full((o.shape[0],), tf.INF)
    full = tf.traverse(planar, o, d, t_max)
    n_max = int(full[4].max())
    assert n_max > 3
    same = tf.traverse_capped(planar, o, d, t_max, n_max)
    for a, b in zip(full[:5], same[:5]):
        assert torch.equal(a, b)
    for cap in (0, 1, 3, n_max - 1):
        out = tf.traverse_capped(planar, o, d, t_max, cap)
        assert torch.equal(out[4], torch.clamp(full[4], max=cap))
        done = full[4] <= cap  # rays that finished within the cap: same hit
        assert torch.equal(out[1][done], full[1][done])
    with pytest.raises(ValueError):
        tf.traverse_capped(planar, o, d, t_max, -1)


@pytest.mark.parametrize("width", tf.WIDTHS)
def test_nogather_twin_reads_each_rays_own_row(atrium, width):
    planars, o, d = atrium
    planar = planars[width]
    n = 300  # fewer rays than rows: every ray reads a real row
    t_max = torch.full((n,), tf.INF)
    seen = torch.zeros(planar.rows.shape[0], dtype=torch.int8)
    out = tf._traverse_plain(planar, o[:n], d[:n], t_max, None, "closest", True, seen,
                             max_steps=travbench.CAP, nogather=True)
    again = tf.traverse_capped(planar, o[:n], d[:n], t_max, travbench.CAP, nogather=True)
    for a, b in zip(out[:5], again[:5]):
        assert torch.equal(a, b)
    assert bool((out[4] == travbench.CAP).all())  # a ray its made-up nodes end starts over
    visited = torch.nonzero(seen).squeeze(1)
    assert visited.numel() > 0 and int(visited.max()) < n
    reps = planar.rows.shape[0] // o.shape[0] + 1  # more rays than rows: pad with own_rows
    with pytest.raises(ValueError):
        tf.traverse_capped(planar, o.repeat(reps, 1), d.repeat(reps, 1),
                           torch.full((o.shape[0] * reps,), tf.INF), 8, nogather=True)
    assert tf.own_rows(planar, n) is planar
    padded = tf.own_rows(planar, planar.rows.shape[0] + 5)
    assert torch.equal(padded.rows[:-5], planar.rows) and not bool(padded.rows[-5:].any())


def _ref_steps(rows, width, stack_depth, o, d, nogather, n_steps):
    """``n_steps`` launches of the reference's step kernel over ``rows``, as
    ``scripts/stepbench.py`` runs its ``base`` (``_step``: the row gather,
    then the kernel) and ``nogather`` variants: every lane starts at row 0
    with t 1e30 and an empty stack of K = min(stack bound, STACK_ROWS)
    rows. The no-gather block, rows[0:P] zero-padded, is what ``_step``
    gathers from the padded table with row ids 0..P-1. Returns, per step,
    the node each lane processed (TERM once ended) and the meta rows after
    the step."""
    P = o.shape[0]
    k_rows = min(stack_depth, ref_tf.STACK_ROWS)
    kern = ref_tf._make_step_kernel(True, False, k_rows, width, candidates=False,
                                    n_rows=rows.shape[0])
    t4 = lambda a: jnp.concatenate([jnp.asarray(a.T), jnp.zeros((1, P), jnp.float32)])
    step = jax.jit(functools.partial(ref_tf._step, jnp.asarray(rows), kern, k_rows, width, 8,
                                     t4(o), t4(d)))
    cur = jnp.zeros((1, P), jnp.int32)
    rowid = cur
    own = jnp.arange(P, dtype=jnp.int32)[None]
    meta = jnp.zeros((8, P), jnp.float32).at[1].set(1e30).at[2].set(-1.0)
    stack = jnp.zeros((k_rows, P), jnp.int32)
    out = []
    for _ in range(n_steps):
        node = np.asarray(cur)[0]
        cur, rowid, meta, stack = step(cur, own if nogather else rowid, meta, stack)
        out.append((node, np.asarray(meta)))
    return out


def _ambiguous(rows, width, o, d, row_ids, interior, t_prune):
    """Lanes whose interior row ``row_ids`` holds two hit children at one
    entry distance, where the reference's bitonic child order may differ
    from the port's stable one, or a hit child whose entry distance is
    within 1e-5 of ``t_prune``, where the last ulp of the best t (rounded
    differently on the two sides) decides whether it is pruned."""
    W = width
    r = torch.from_numpy(rows[row_ids])
    bmin = r[:, 0:3 * W].reshape(-1, 3, W).transpose(1, 2)
    bmax = r[:, 3 * W:6 * W].reshape(-1, 3, W).transpose(1, 2)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    tn, tfar = tf._slab(bmin, bmax, o[:, None, :], tf.inv_dir(d)[:, None, :])
    hit = (bmin[..., 0] <= bmax[..., 0]) & (tn <= tfar) & (tfar >= 0.0)
    key = torch.sort(torch.where(hit, tn, tf.INF), dim=1).values
    tie = ((key[:, 1:] == key[:, :-1]) & (key[:, 1:] < tf.INF)).any(dim=1)
    tp = torch.tensor(t_prune)[:, None]
    near = (hit & ((tn - tp).abs() <= 1e-5 * tp.abs())).any(dim=1)
    return (tie | near).numpy() & interior


@pytest.mark.parametrize("nogather", [False, True])
@pytest.mark.parametrize("width", tf.WIDTHS)
def test_capped_twins_match_reference_step_kernel(atrium, width, nogather):
    """``traverse_capped(..., k, nogather=)`` at every cap k <= 8 against
    the reference's step kernel after k steps, on P = BLK camera rays (more
    rays than the cut atrium has rows, so the no-gather block is partly
    zeros). Left out by design, each counted:

    * lanes the reference flags for its full-depth re-run (meta row 6): its
      short stack drops pushes past K rows, the port's capped stack holds
      128 (the tree's bound at most);
    * lanes whose path (the reference's) met an interior row with two hit
      children at one entry distance: its bitonic child order is not
      stable, the port's is, so the two may walk the tied children in
      another order; or with a hit child whose entry distance is within
      1e-5 of the best t so far, which the two sides round differently;
    * no-gather lanes after the reference ended them: a TPU lane at TERM
      idles, while the port starts the ray over at the root so that every
      ray runs the cap (the card's threads stop on their own). Each is
      compared at every step up to the one that ended it.

    The camera is inside the atrium, so every ray enters the root's box,
    which the port tests before the first node and the reference does not.
    """
    planars, _, _ = atrium
    P = ref_tf.BLK
    planar = planars[width]
    if nogather:
        planar = tf.own_rows(planar, P)
    cam = procedural.atrium_scene(**travbench.SMALL_ATRIUM)[3]
    o, d = travbench.camera_rays(cam, P, "cpu")
    rows, on, dn = planar.rows.numpy(), o.numpy(), d.numpy()
    ref = _ref_steps(rows, width, planar.stack_depth, on, dn, nogather, travbench.CAP)
    t_max = torch.full((P,), tf.INF)
    tied = np.zeros(P, bool)
    t_prune = np.full(P, 1e30, np.float32)
    compared = 0
    for k, (node, meta) in enumerate(ref, start=1):
        interior = (node >= 0) & (node != tf.TERM)
        ids = np.arange(P) if nogather else np.where(interior, node, 0)
        tied |= _ambiguous(rows, width, on, dn, ids, interior, t_prune)
        t_prune = meta[1]
        r_steps, r_t, r_tri = meta[5].astype(np.int32), meta[1], meta[2].astype(np.int64)
        ok = (meta[6] == 0) & ~tied
        if nogather:
            ok &= r_steps == k  # the lane ran every step so far
        t, tri, _, _, steps, _, _ = tf.traverse_capped(planar, o, d, t_max, k, nogather=nogather)
        t, tri, steps = t.numpy(), tri.numpy(), steps.numpy()
        np.testing.assert_array_equal(steps[ok], r_steps[ok])
        np.testing.assert_array_equal(tri[ok], r_tri[ok])
        hit = ok & (r_tri >= 0)
        np.testing.assert_allclose(t[hit], r_t[hit], rtol=1e-5, atol=1e-6)
        if nogather:
            assert bool((steps == k).all())
        compared += int(ok.sum())
    assert tied.mean() < 0.2, tied.mean()
    assert compared > (0.95 if nogather else 6) * P, compared


def test_sort_ops_counts_the_insertions():
    """One compare per child and per hit, and one per larger earlier hit."""
    keys = torch.tensor([[3.0, 1.0, tf.INF, 2.0] + [tf.INF] * 12])
    # hits 3, 1, 2: inversions (3, 1), (3, 2)
    assert travbench.sort_ops(keys) == 16 + 3 + 2
    assert travbench.sort_bytes(keys) == 16 * 16 + 4


def test_travbench_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run(
        [sys.executable, "-m", "vk_raytrace_torch.travbench", "--device", "cpu", "--small",
         "--rays", "256", "--reps", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [json.loads(ln) for ln in res.stdout.strip().splitlines()]
    assert [(x["variant"], x["width"]) for x in lines] == [
        (v, w) for w in tf.WIDTHS for v in travbench.VARIANTS
    ] + [("wide", 8)]
    for x in lines:
        assert x["device"] == "cpu" and x["rays"] == 256
        assert "ms" not in x and "bound_ms" not in x  # no device number from a CPU run
        assert x["cpu_ms"] > 0 and x["bytes"] > 0 and x["ops"] > 0
        assert np.isfinite(x["nodes_per_ray"])
    by = {(x["variant"], x["width"]): x for x in lines}
    for w in tf.WIDTHS:
        assert by["capped8", w]["nodes_per_ray"] <= min(8, by["full", w]["nodes_per_ray"]) + 1e-9
        assert by["nogather8", w]["nodes_per_ray"] == 8
    # Wider rows: fewer nodes per ray.
    assert by["full", 32]["nodes_per_ray"] < by["full", 16]["nodes_per_ray"]
    assert by["full", 16]["nodes_per_ray"] < by["wide", 8]["nodes_per_ray"]
    assert by["wide", 8]["hit_share"] == by["full", 16]["hit_share"]


def test_travbench_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    with pytest.raises(SystemExit):
        travbench.main(["--device", "cuda"])
