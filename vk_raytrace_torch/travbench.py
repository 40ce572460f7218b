"""Traversal micro-bench: the traversal kernel alone, at the main path's width.

    python -m vk_raytrace_torch.travbench [--device cuda|cpu] [--rays P]
        [--reps N] [--small]

Counterpart of ``scripts/travbench.py`` and ``scripts/stepbench.py``. It
builds the full atrium's opaque tree at each width (``--small``: the atrium
cut to 2x2 bays, as the CPU tests use it) and shoots P camera rays through
the 1080p pixel centres ``(i * 7919) % (1920 * 1080)`` (P = 524,288 by
default). Variants at each width:

* ``full``: closest hit to termination (kernel mode a);
* ``capped8``: closest hit stopped after 8 nodes per ray, the reference's
  ``base`` (8 production steps);
* ``nogather8``: 8 nodes per ray with ray r reading row r at every step,
  whatever its node is (the table zero-padded to a row per ray), the
  reference's measure of what the dependent row gather costs. Its hits are
  wrong by design. A ray its made-up nodes would end starts over at the
  root, as a TPU lane keeps paying for every step, so every ray runs 8
  nodes: compare it with ``capped8`` per node visited;
* ``capped24``, ``nogather24``: the same at 24 nodes, past the 16 stack
  entries a thread keeps in shared memory, where the capped kernel runs
  its spilling stack in place of the ring of shared entries it runs at
  width 16 (both run mode a's persistent node loops, as ``full`` does);
* ``root_order``: the child order alone (``sort_children``) on the entry
  distances of every ray into the root row's children.

and once, on the same rays, ``wide`` (width 8): the wide back end's
closest hit over the 8-wide opaque tree (``vkrt_traverse_wide``,
``ops/traverse_wide.py``), bytes in 32-byte sectors over the distinct
256-byte rows it visits, operations ``nodes * 26 * 8``.

Each variant prints one JSON line: mean ms per call (CUDA events, after a
warm-up) and its plain version's, mean nodes per ray, the distinct rows the
rays visit, the call's bytes and operations and its bound on the card, and
the card's name and power limit; ``full`` and each capped variant add their
kernel's registers, stack frame and spill bytes (ptxas), resident blocks per
SM and the deepest stack a ray reached, and a no-gather variant its row
bytes counted at every step (``bytes_per_step``: it reads its own row at
each node, which ``bytes`` counts once; its bound both ways). Every kernel
result is held against its
plain version first, bit for bit (t, tri, u, v, steps), and the largest
difference is printed (``max_abs_err``). It runs on the
card unless given ``--device cpu``, where it runs the plain versions and
times them on the host clock (``cpu_ms``; no device number).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from . import cuda_build
from .ops import traverse_fused as tf

RAYS = 524288
PIX_STRIDE = 7919
SMALL_ATRIUM = dict(bays_x=2, bays_z=2, column_segments=16, column_rows=12)
CAP = 8
LONG_CAP = 24  # past the shared stack entries: the capped kernel's spilling stack

# The card's peaks: the memory rate (H100 SXM data sheet) and the float32
# operations the port's kernels can issue. Every kernel is built with
# -fmad=false (cuda_build.NVCC_FLAGS) and the op counts count each add,
# multiply, min and max as one, so the most the card issues is one float32
# operation a lane a cycle: 132 SMs x 128 lanes x its maximum SM clock,
# 1,980 MHz on the H100 80GB HBM3 (nvidia-smi --query-gpu=clocks.max.sm),
# 33.45e12 a second. The data sheet's 67e12 counts a fused multiply-add as
# two. A call's bound is the larger of its bytes and its operations over them.
PEAK_BYTES_PER_S, PEAK_F32_PER_S = 3.35e12, 132 * 128 * 1980e6


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the least time of ``n_bytes`` moved and
    ``n_ops`` float32 operations at the card's peak rates."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def ops_per_node(width: int) -> int:
    """Float operations of one traversal step, counted from csrc/traverse.cu:
    an interior row tests ``width`` child boxes (6 subtract, 6 multiply, 10
    min/max and 4 compares each, 26), a leaf row ``width/2`` triangles
    (Moller-Trumbore, about 52 each): 26 * width either way."""
    return 26 * width


def row_bytes(width: int, mode: str):
    """(interior, leaf) bytes csrc/traverse.cu loads from a row it visits,
    in 32-byte sectors: an interior row's child boxes and refs (7 lanes per
    child); a leaf row's vertex and meta lanes (10 attributes of width/2
    lanes), all 16 in mode c for the texture UVs."""
    leaf_attrs = 16 if mode == "candidate" else 10
    return 7 * width * 4, leaf_attrs * (width // 2) * 4


def wide_row_bytes():
    """(interior, leaf) bytes csrc/traverse_wide.cu loads from an 8-wide row
    it visits, in 32-byte sectors: 8 child boxes and refs (56 lanes, 7
    sectors); 4 whole triangles (64 lanes, 8 sectors)."""
    return 7 * 32, 8 * 32


def traversal_bytes(n_rays, ray_bytes, seen, width, mode):
    """Bytes of one traversal call: ``ray_bytes`` in and out per ray, and
    each distinct row the rays visit (``seen`` from the twin) once; width 8
    is the wide back end's table."""
    n_inner, n_leaf = int((seen == 1).sum()), int((seen == 2).sum())
    inner_b, leaf_b = wide_row_bytes() if width == 8 else row_bytes(width, mode)
    return n_rays * ray_bytes + n_inner * inner_b + n_leaf * leaf_b, n_inner, n_leaf


def sort_ops(keys, chunk=1 << 16):
    """Operations of the child sort on these keys: one compare per child for
    the hit test, and per hit the insertion's compares (one more than the
    hits before it with a larger key)."""
    n_ops = keys.numel()
    for s in range(0, keys.shape[0], chunk):
        k = keys[s:s + chunk]
        hit = k < tf.INF
        w = k.shape[1]
        before = torch.ones(w, w, dtype=torch.bool, device=k.device).triu(1)  # [i, j]: i < j
        inv = hit[:, :, None] & hit[:, None, :] & before & (k[:, :, None] > k[:, None, :])
        n_ops += int(hit.sum()) + int(inv.sum())
    return n_ops


def sort_bytes(keys):
    """Keys and refs in and out (4 B each per child) and the hit counts."""
    return keys.numel() * 16 + keys.shape[0] * 4


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_time(fn, reps):
    """Mean milliseconds per call, timed with CUDA events after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_time(fn, reps):
    """Mean host milliseconds per call (CPU runs) after a warm-up."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def camera_rays(cam, n, dev):
    """Primary rays through the 1080p pixel centres (i * 7919) mod (1920*1080)."""
    from .integrator.camera import generate_rays_for_pixels, with_aspect
    from .ops import rng as vrng

    pix = (torch.arange(n, dtype=torch.int64) * PIX_STRIDE) % (1920 * 1080)
    cam = with_aspect(cam, 1920, 1080).to(dev)
    pix = pix.to(dev)
    o, d, _ = generate_rays_for_pixels(cam, 1920, 1080, pix, 0, vrng.tea(pix, 0))
    return o.contiguous(), d.contiguous()


def root_keys(planar, o, d):
    """Entry distance of every ray into each child of the root row (INF
    where it misses one), and the children's refs: the first interior row
    every ray orders."""
    valid, bmin, bmax = tf._root_boxes(planar.rows, planar.width)
    tn, tfar = tf._slab(bmin[None], bmax[None], o[:, None, :], tf.inv_dir(d)[:, None, :])
    hit = valid[None] & (tn <= tfar) & (tfar >= 0.0)
    keys = torch.where(hit, tn, tf.INF).contiguous()
    w = planar.width
    refs = planar.rows[0, 6 * w:7 * w].to(torch.int32)[None].expand(keys.shape[0], w)
    return keys, refs.contiguous()


def ab_report(width: int, mode: str, device) -> dict:
    """The persistent mode a/b kernel (``mode`` "closest" or "any") at
    ``width``: registers, stack frame and spill bytes (stores + loads) as
    ptxas reported them, resident blocks per SM, and the deepest stack a ray
    reached in its last call on ``device``."""
    res = cuda_build.resources(f"traverse{width}",
                               f"persistent_traverse_kernelILi{tf._MODE_ID[mode]}E")
    return dict(registers=res["registers"], stack_frame=res["stack_frame"],
                spill_bytes=res["spill_stores"] + res["spill_loads"],
                blocks_per_sm=tf.ab_occupancy(width, mode),
                deepest_stack=tf.stack_reached(width, device))


def round_report(width: int, mode: str, cull: bool, roots: bool, device) -> dict:
    """The per-round kernel that ``traverse`` launches for ``mode`` (mode c
    from the root, or any mode with per-lane roots) at ``width``: as
    :func:`ab_report`."""
    entry = (f"round_traverse_kernelILi{tf._MODE_ID[mode]}ELb{int(bool(cull))}ELi{width}"
             f"ELb{int(bool(roots))}E")
    res = cuda_build.resources(f"traverse{width}", entry)
    return dict(registers=res["registers"], stack_frame=res["stack_frame"],
                spill_bytes=res["spill_stores"] + res["spill_loads"],
                blocks_per_sm=tf.round_occupancy(width, mode, cull, roots),
                deepest_stack=tf.stack_reached(width, device))


def capped_report(width: int, max_steps: int, nogather: bool, device) -> dict:
    """The capped kernel that ``traverse_capped`` launches for ``max_steps``
    and ``nogather`` at ``width``: as :func:`ab_report` (at width 16 its
    ring of shared entries below ``tf.shared_stack`` steps, else its
    spilling stack)."""
    ring = width == 16 and max_steps < tf.shared_stack(width)
    res = cuda_build.resources(
        f"traverse{width}", f"capped_traverse_kernelILi{width}ELb{int(nogather)}ELb{int(ring)}E")
    return dict(registers=res["registers"], stack_frame=res["stack_frame"],
                spill_bytes=res["spill_stores"] + res["spill_loads"],
                blocks_per_sm=tf.capped_occupancy(width, max_steps, nogather),
                deepest_stack=tf.capped_stack_reached(width, device), ring=ring)


def same_hits(a, b) -> bool:
    """Two traversal results equal bit for bit in t, tri, u, v and steps."""
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) if x.is_floating_point()
               else torch.equal(x, y) for x, y in zip(a[:5], b[:5]))


def max_abs_err(a, b) -> float:
    """Largest |a - b| over the t, u and v of two traversal results, on the
    rays where both report the same hit triangle."""
    same = (a[1] == b[1]) & (a[1] >= 0)
    if not bool(same.any()):
        return 0.0
    return max(float((a[k][same] - b[k][same]).abs().max()) for k in (0, 2, 3))


def sort_err(a, b) -> float:
    """Largest |a - b| over the sorted keys, refs and hit counts of two
    child-sort results (a NaN key against a NaN key counts as 0)."""
    def err(x, y):
        d = (x.double() - y.double()).abs()
        return float(torch.where(x.isnan() & y.isnan(), 0.0, d).max()) if x.numel() else 0.0

    return max(err(x, y) for x, y in zip(a, b))


def same_sort(a, b) -> bool:
    """Two child-sort results equal bit for bit (NaN keys included)."""
    return (torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
            and torch.equal(a[1], b[1]) and torch.equal(a[2], b[2]))


def _variant(name, planar, o, d, t_max, cuda, reps):
    """One traversal variant: kernel (or plain on the CPU) vs plain, times,
    nodes and bound."""
    capped = name != "full"
    nogather = name.startswith("nogather")
    cap = int(name.removeprefix("nogather").removeprefix("capped")) if capped else None
    if nogather:
        planar = tf.own_rows(planar, o.shape[0])

    def kern():
        if capped:
            return tf.traverse_capped(planar, o, d, t_max, cap, nogather=nogather)
        return tf.traverse(planar, o, d, t_max, mode="closest", cull=True)

    seen = torch.zeros(planar.rows.shape[0], dtype=torch.int8, device=o.device)
    plain_kw = dict(max_steps=cap, nogather=nogather)
    plain = tf._traverse_plain(planar, o, d, t_max, None, "closest", True, seen, **plain_kw)
    out = kern()
    if cuda:
        torch.cuda.synchronize()
        assert same_hits(out, plain), f"{name}: kernel and plain version differ"
    nodes = float(plain[4].double().sum())
    n = o.shape[0]
    # rays in (origin, direction, t_max) and out (t, tri, u, v, steps)
    n_bytes, n_inner, n_leaf = traversal_bytes(n, 28 + 20, seen, planar.width, "closest")
    res = dict(nodes_per_ray=nodes / n, interior_rows=n_inner, leaf_rows=n_leaf,
               bytes=n_bytes, ops=nodes * ops_per_node(planar.width),
               hit_share=float((plain[1] >= 0).float().mean()))
    if nogather:
        # Every ray reads its own row at each of its ``cap`` steps: the rows'
        # bytes counted ``cap`` times.
        res["bytes_per_step"] = n * 48 + (n_bytes - n * 48) * cap
    if cuda:
        res["max_abs_err"] = max_abs_err(out, plain)
        res.update(capped_report(planar.width, cap, nogather, o.device) if capped
                   else ab_report(planar.width, "closest", o.device))
    timer = cuda_time if cuda else host_time
    res["ms" if cuda else "cpu_ms"] = timer(kern, reps)
    res["plain_ms" if cuda else "plain_cpu_ms"] = timer(
        lambda: tf._traverse_plain(planar, o, d, t_max, None, "closest", True, **plain_kw), 2)
    return res


def _root_order(planar, o, d, cuda, reps):
    keys, refs = root_keys(planar, o, d)
    out = tf.sort_children(keys, refs)
    plain = tf._sort_children_plain(keys, refs)
    if cuda:
        torch.cuda.synchronize()
        assert same_sort(out, plain), "root_order: kernel and plain version differ"
    timer = cuda_time if cuda else host_time
    res = dict(nodes_per_ray=1.0, hits_per_ray=float(plain[2].double().mean()),
               bytes=sort_bytes(keys), ops=sort_ops(keys))
    if cuda:
        res["max_abs_err"] = sort_err(out, plain)
    res["ms" if cuda else "cpu_ms"] = timer(lambda: tf.sort_children(keys, refs), reps)
    res["plain_ms" if cuda else "plain_cpu_ms"] = timer(
        lambda: tf._sort_children_plain(keys, refs), 2)
    if cuda:
        res["library_ms"] = timer(lambda: torch.sort(keys, dim=1, stable=True), reps)
    return res


def _wide(wide, o, d, t_max, cuda, reps):
    """The wide back end's closest hit: kernel (or plain on the CPU) vs
    plain, times, nodes and bound."""
    from .ops import traverse_wide as tw

    def kern():
        return tw.traverse_wide(wide, None, o, d, t_max)

    seen = torch.zeros(wide.rows.shape[0], dtype=torch.int8, device=o.device)
    plain = tw._traverse_wide_plain(wide, None, o, d, t_max, None, None, False, seen=seen)
    out = kern()
    if cuda:
        torch.cuda.synchronize()
        assert same_hits(out, plain) and torch.equal(out[5], plain[5]), (
            "wide: kernel and plain version differ")
    nodes = float(plain[4].double().sum())
    n = o.shape[0]
    # rays in (origin, direction, t_max) and out (t, tri, u, v, steps, seed)
    n_bytes, n_inner, n_leaf = traversal_bytes(n, 28 + 28, seen, 8, "closest")
    res = dict(nodes_per_ray=nodes / n, interior_rows=n_inner, leaf_rows=n_leaf,
               bytes=n_bytes, ops=nodes * ops_per_node(8),
               hit_share=float((plain[1] >= 0).float().mean()))
    if cuda:
        res["max_abs_err"] = max_abs_err(out, plain)
        r = cuda_build.resources("traverse_wide", "wide_kernelILb0ELb0E")
        res.update(registers=r["registers"], stack_frame=r["stack_frame"],
                   spill_bytes=r["spill_stores"] + r["spill_loads"])
    timer = cuda_time if cuda else host_time
    res["ms" if cuda else "cpu_ms"] = timer(kern, reps)
    res["plain_ms" if cuda else "plain_cpu_ms"] = timer(
        lambda: tw._traverse_wide_plain(wide, None, o, d, t_max, None, None, False), 2)
    return res


VARIANTS = ("full", f"capped{CAP}", f"nogather{CAP}", f"capped{LONG_CAP}",
            f"nogather{LONG_CAP}", "root_order")


def run(device, planars, cam, rays=RAYS, reps=20, card=None, emit=print, wide=None):
    """Every variant at every width of ``planars`` ({width: PlanarScene} of
    the opaque tree, on ``device``) on ``rays`` camera rays of ``cam``, and
    with ``wide`` (the 8-wide opaque tree, ``bvh8.WideScene``) the wide back
    end's variant. Emits and returns one dict per variant."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and card is None:
        card = card_line()
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    o, d = camera_rays(cam, rays, dev)
    t_max = torch.full((rays,), tf.INF, device=dev)
    results = []
    for width, planar in planars.items():
        for name in VARIANTS:
            if name == "root_order":
                res = _root_order(planar, o, d, cuda, reps)
            else:
                res = _variant(name, planar, o, d, t_max, cuda, reps)
            results.append(_emit(dict(bench="travbench", variant=name, width=width, rays=rays,
                                      rows=int(planar.rows.shape[0]),
                                      stack=planar.stack_depth, device=kind, **res),
                                 cuda, card, emit))
    if wide is not None:
        res = _wide(wide, o, d, t_max, cuda, reps)
        results.append(_emit(dict(bench="travbench", variant="wide", width=8, rays=rays,
                                  rows=int(wide.rows.shape[0]), stack=wide.stack_depth,
                                  device=kind, **res), cuda, card, emit))
    return results


def _emit(res, cuda, card, emit):
    if cuda:
        res["bound_ms"], res["bound_by"] = bound(res["bytes"], res["ops"])
        if "bytes_per_step" in res:
            res["bound_per_step_ms"], res["bound_per_step_by"] = bound(res["bytes_per_step"],
                                                                       res["ops"])
        res["card"] = card
    emit(json.dumps(res))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rays", type=int, default=RAYS)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--small", action="store_true", help="the atrium cut to 2x2 bays")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: run on the card or pass --device cpu")
    from .models import procedural
    from .ops.bvh8 import build_accel_bundle, build_wide

    geom, _, _, cam, _ = procedural.atrium_scene(**(SMALL_ATRIUM if args.small else {}))
    planars = {w: build_accel_bundle(geom, width=w).opaque_planar.to(args.device)
               for w in tf.WIDTHS}
    run(args.device, planars, cam, rays=args.rays, reps=args.reps,
        wide=build_wide(geom)[0].to(args.device))


if __name__ == "__main__":
    main()
