"""BVH traversal over planar rows (16 or 32 wide): the CUDA kernel and its
plain twin.

Counterpart of ``vk_raytrace_tpu/ops/traverse_fused.py``. The TPU kernel
(``_make_step_kernel``, launched once per traversal step) becomes
``csrc/traverse.cu``: one launch per traversal, one thread per ray looping
to termination with a full-depth stack. The kernel is bound by dependent
row reads (512 B at width 16, 1024 B at width 32) and divergence, not
arithmetic.

Three modes run on the main path:

* ``closest`` (a): nearest hit with backface culling by the double-sided
  flag — primary and bounce rays over the opaque tree;
* ``any`` (b): first accepted hit within ``t_max``, no culling — shadow rays;
* ``candidate`` (c): nearest alpha-flagged hit plus its interpolated texture
  UV, over the alpha tree (``ops/traverse_alpha.py``).

Each mode also runs with per-lane roots (``root0``, the reference's mode d):
the two-level path (``ops/tlas.py``) starts every lane at its instance's
BLAS root in a concatenated table and skips the root union-box test, which
the instance's box test has already done.

:func:`traverse` dispatches on the tensors' device: CPU tensors run
:func:`_traverse_plain` (vectorised torch over all rays), CUDA tensors launch
the kernel or raise. Modes a and b from the root launch the persistent entry
``vkrt_traverse_ab`` (the same nodes and outputs, bit for bit; warps that
fetch rays from a counter, the stack in shared memory with a spill in a
scratch kept per device, width and stream): :func:`ab_occupancy` gives its
resident blocks per SM and :func:`stack_reached` the deepest stack of its
last call. :data:`LAUNCHES` counts kernel launches per mode, with
per-lane roots under ``<mode>_roots`` and width-32 rows under ``..._w32``.

Three more entries, each with its plain version beside it:

* :func:`alpha_need`: which rays the single-level alpha rounds trace (the
  per-child slab test against the root row, :func:`root_prefilter`, with
  the ``active`` and ``t_limit > 0`` gates), a thread a ray on the card
  (``vkrt_root_prefilter``); the main path runs the same line in the
  rounds kernel's ray intake and launches this entry no time;

* :func:`sort_children`: the child order of interior rows alone (the order
  every interior step takes; the counterpart of the TPU kernel's bitonic
  network ``_bitonic``), a row per warp or half-warp on the card;
* :func:`traverse_capped`: closest hit stopped after ``max_steps`` nodes per
  ray, and its no-gather timing variant (``nogather=True``: ray r reads
  row r of :func:`own_rows` at every step and starts over at the root where
  it would end, so the hits are wrong by design; the counterpart of
  ``scripts/stepbench.py``'s no-gather kernel).

The same library holds the round machines, whose wrappers live beside
their plain loops: the single-level alpha rounds
(``ops/traverse_alpha.py``) and the two-level opaque and alpha rounds
(``ops/tlas.py``), each one launch per call on the card. They run in
persistent warps too: :func:`machine_state` gives their grid and scratch
(shared with the a/b entries of the width), :func:`machine_occupancy` their
resident blocks per SM, and ``_AB_GRIDS[width].lane_steps`` what their warps
counted.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from contextlib import contextmanager
from typing import NamedTuple, Optional

import torch

from .. import cuda_build

TERM = -(2**30)
INF = 1e32
MODES = ("closest", "any", "candidate")
_MODE_ID = {m: i for i, m in enumerate(MODES)}
# The (mode, cull) pairs the kernel instantiates: closest hit always culls,
# any hit never does, candidates either way.
_MODE_CULL = {("closest", True), ("any", False), ("candidate", True), ("candidate", False)}

WIDTHS = (16, 32)
ROOT_MODES = tuple(f"{m}_roots" for m in MODES)
W32_MODES = tuple(f"{m}_w32" for m in MODES + ROOT_MODES)
CAPPED_KEYS = ("capped", "nogather", "capped_w32", "nogather_w32")
SORT_KEYS = ("sort_children", "sort_children_w32")
MACHINE_KEYS = ("alpha_machine", "alpha_machine_w32")
ROUNDS_KEYS = ("alpha_rounds", "alpha_rounds_w32")
PREFILTER_KEYS = ("root_prefilter", "root_prefilter_w32")
OPAQUE_KEYS = ("opaque_machine", "opaque_machine_w32")
# The wide back end's kernels (ops/traverse_wide.py, ops/tlas.py,
# csrc/traverse_wide.cu): one tree, and the two-level rounds whole.
WIDE_KEYS = ("traverse_wide", "wide_machine")

# Kernel launches per entry, counted where the wrapper launches: traversal
# per mode (``<mode>_roots`` with per-lane roots, ``_w32`` at width 32), the
# capped and no-gather entries, the child sort, the alpha pass's root
# prefilter, and the round machines: the
# single-level alpha rounds (``ops/traverse_alpha.py``), the two-level opaque
# rounds and the two-level alpha machine (``ops/tlas.py``), and the wide
# back end's kernels (``vkrt_traverse_wide``, ``vkrt_wide_machine``).
LAUNCHES = {m: 0 for m in (MODES + ROOT_MODES + W32_MODES + CAPPED_KEYS + SORT_KEYS
                           + MACHINE_KEYS + ROUNDS_KEYS + PREFILTER_KEYS + OPAQUE_KEYS
                           + WIDE_KEYS)}


def reset_launches() -> None:
    for m in LAUNCHES:
        LAUNCHES[m] = 0


def launch_key(name: str, width: int) -> str:
    """The :data:`LAUNCHES` key of entry ``name`` at row ``width``."""
    return name if width == 16 else f"{name}_w32"


# The stack of the kernel's capped entry (``vkrt_traverse_capped``), which
# the no-gather twin mirrors.
CAPPED_STACK = 128


@dataclasses.dataclass
class PlanarScene:
    """Planar row table: ``rows`` (X, width*8) f32; ``stack_depth`` is the
    tree's exact worst-case traversal stack need."""

    rows: object
    stack_depth: int
    width: int = 16

    def to(self, device) -> "PlanarScene":
        from ..models.schema import to_tensor

        return dataclasses.replace(self, rows=to_tensor(self.rows, device))


class Hit(NamedTuple):
    t: torch.Tensor      # (R,) f32, INF on miss
    tri: torch.Tensor    # (R,) int64 original triangle id, -1 on miss
    u: torch.Tensor      # (R,) f32 barycentric of vertex 1
    v: torch.Tensor      # (R,) f32 barycentric of vertex 2
    steps: torch.Tensor  # (R,) int32 nodes visited
    inst: Optional[torch.Tensor] = None  # (R,) int64 instance (two-level scenes)


def inv_dir(d: torch.Tensor) -> torch.Tensor:
    """Guarded reciprocal direction: |d| < 1e-20 -> +-1e-20."""
    tiny = torch.where(d < 0, -1e-20, 1e-20).to(d.dtype)
    return 1.0 / torch.where(torch.abs(d) < 1e-20, tiny, d)


def _root_boxes(rows, W):
    rb = rows[0]
    valid = rb[0:W] <= rb[3 * W:4 * W]
    bmin = torch.stack([rb[0:W], rb[W:2 * W], rb[2 * W:3 * W]], dim=-1)
    bmax = torch.stack([rb[3 * W:4 * W], rb[4 * W:5 * W], rb[5 * W:6 * W]], dim=-1)
    return valid, bmin, bmax


def _slab(lo_b, hi_b, origin, inv_d):
    lo = (lo_b - origin) * inv_d
    hi = (hi_b - origin) * inv_d
    tn = torch.amax(torch.minimum(lo, hi), dim=-1)
    tf = torch.amin(torch.maximum(lo, hi), dim=-1)
    return tn, tf


def root_prefilter(planar: PlanarScene, origin, direction, t_max) -> torch.Tensor:
    """Per-child slab test against the root row: which rays can hit the
    tree within (0, t_max) (``traverse_fused.py:575``)."""
    W = planar.width
    valid, bmin, bmax = _root_boxes(planar.rows, W)
    tn, tf = _slab(bmin[None], bmax[None], origin[:, None, :], inv_dir(direction)[:, None, :])
    hit = valid[None] & (tn <= tf) & (tf >= 0.0) & (tn < t_max[:, None])
    return torch.any(hit, dim=1)


def _alpha_need_plain(planar: PlanarScene, origin, direction, t_limit, active=None):
    """The plain version of :func:`alpha_need` (torch on any device)."""
    need = torch.ones_like(t_limit, dtype=torch.bool) if active is None else active
    return need & (t_limit > 0.0) & root_prefilter(planar, origin, direction, t_limit)


def _alpha_need_cuda(planar: PlanarScene, origin, direction, t_limit, active):
    """One launch of ``vkrt_root_prefilter``."""
    lib = _load(planar.width)
    r, dev = origin.shape[0], origin.device
    active = _check_rays(lib, planar, origin, direction, t_limit, active)
    need = torch.empty(r, dtype=torch.bool, device=dev)
    if r == 0:  # nothing to launch, and so nothing to count
        return need
    err = lib.vkrt_root_prefilter(
        planar.width, planar.rows.data_ptr(), origin.data_ptr(), direction.data_ptr(),
        t_limit.data_ptr(), _ptr(active), r, need.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"root prefilter kernel launch failed: cudaError {err}")
    LAUNCHES[launch_key("root_prefilter", planar.width)] += 1
    return need


def alpha_need(planar: PlanarScene, origin, direction, t_limit, active=None) -> torch.Tensor:
    """Which rays the single-level alpha rounds must trace: ``active`` (all
    where None), ``t_limit > 0`` and a root child hit within ``(0,
    t_limit)`` (:func:`root_prefilter`); the reference's line before its
    rounds (``traverse_alpha.py:175-183``). CUDA tensors launch
    ``vkrt_root_prefilter`` (or raise), CPU tensors run the plain version.
    On the card the alpha pass does not call it: ``vkrt_alpha_rounds`` runs
    the line at its ray intake."""
    if origin.device.type == "cuda":
        return _alpha_need_cuda(planar, origin, direction, t_limit, active)
    if origin.device.type != "cpu":
        raise ValueError(f"no root prefilter for device {origin.device}")
    return _alpha_need_plain(planar, origin, direction, t_limit, active)


def _root_union_hit(rows, W, origin, inv_d, t_max):
    """Ray setup: slab test against the union box of the valid root children."""
    valid, bmin, bmax = _root_boxes(rows, W)
    big = 3.0e38
    rmin = torch.where(valid[:, None], bmin, big).amin(dim=0)
    rmax = torch.where(valid[:, None], bmax, -big).amax(dim=0)
    tn0, tf0 = _slab(rmin[None], rmax[None], origin, inv_d)
    return (tn0 <= tf0) & (tf0 >= 0.0) & (tn0 < t_max)


def _minfold(cols):
    """Tournament min over the leaf lanes (dim 1) in the reference's fold
    order; a lane keeps its entry unless the partner's t is strictly less.
    ``cols[0]`` is t; the rest ride along. Returns lane 0 of each."""
    k = cols[0].shape[1] // 2
    while k >= 1:
        rolled = [torch.roll(c, -k, dims=1) for c in cols]
        take = rolled[0] < cols[0]
        cols = [torch.where(take, r, c) for r, c in zip(rolled, cols)]
        k //= 2
    return [c[:, 0] for c in cols]


def _traverse_plain(
    planar: PlanarScene, origin, direction, t_max, active, mode: str, cull: bool, seen=None,
    root0=None, max_steps=None, nogather=False,
):
    """Plain torch twin of the kernel: every step advances all live rays by
    one node, with an (R, D) stack, ``torch.sort`` for the child order and
    gathered rows. Returns (t, tri, u, v, steps, uvu, uvv). ``seen``, an
    optional (X,) int8 tensor over the rows, is set to 1 at every interior
    row and 2 at every leaf row that some ray visits. ``root0``, an optional
    (R,) integer tensor, starts each ray at its own interior row instead of
    the root union-box test.

    ``max_steps`` stops every ray after that many nodes. ``nogather`` (the
    no-gather timing variant) gives ray r row r of the table (which must
    have a row per ray, :func:`own_rows`) at every step, read as its node's
    kind, restarts at the root (row 0, empty stack) a ray that would end,
    so every ray runs ``max_steps`` nodes, and has the capped kernel's stack
    of :data:`CAPPED_STACK` entries: pushes past it are dropped and a pop
    past it ends the node's run, which only such made-up nodes can reach."""
    if nogather and max_steps is None:
        raise ValueError("the no-gather variant never ends a ray: give it max_steps")
    rows = planar.rows
    W = planar.width
    LT = W // 2
    CB = LT.bit_length() - 1
    dev = origin.device
    R = origin.shape[0]
    cand = mode == "candidate"
    inv_d = inv_dir(direction)

    if root0 is not None:
        cur = root0.long()
    else:
        cur = torch.where(_root_union_hit(rows, W, origin, inv_d, t_max), 0, TERM).long()
    if active is not None:
        cur = torch.where(active, cur, TERM)
    t_best = t_max.clone()
    tri = torch.full((R,), -1, dtype=torch.int64, device=dev)
    u = torch.zeros(R, device=dev)
    v = torch.zeros(R, device=dev)
    c_t = t_max.clone()
    c_tri = tri.clone()
    c_u, c_v, c_uvu, c_uvv = (torch.zeros(R, device=dev) for _ in range(4))
    steps = torch.zeros(R, dtype=torch.int32, device=dev)
    D = CAPPED_STACK if nogather else max(planar.stack_depth, 1)
    stack = torch.zeros((R, D + W), dtype=torch.int64, device=dev)
    depth = torch.zeros(R, dtype=torch.int64, device=dev)
    lane = torch.arange(LT, device=dev)

    while True:
        if nogather:
            over = cur == TERM
            cur[over] = 0
            depth[over] = 0
        live = cur != TERM
        if max_steps is not None:
            live &= steps < max_steps
        act = torch.nonzero(live).squeeze(1)
        if act.numel() == 0:
            break
        c = cur[act]
        steps[act] += 1
        o, dd, iv = origin[act], direction[act], inv_d[act]
        tb = t_best[act]
        ct = c_t[act]
        t_prune = torch.minimum(tb, ct) if cand else tb
        is_wide = c >= 0
        vleaf = -c - 1
        row_id = act if nogather else torch.where(is_wide, c, vleaf >> CB)
        row = rows[row_id]
        if seen is not None:
            seen[row_id] = torch.where(is_wide, 1, 2).to(seen.dtype)
        dep = depth[act]
        nxt = torch.full_like(c, TERM)
        need_pop = ~is_wide

        # ---- interior: W-way slab test, stable sort of the hit children
        wi = torch.nonzero(is_wide).squeeze(1)
        if wi.numel():
            rw = row[wi]
            bmin = rw[:, 0:3 * W].reshape(-1, 3, W).transpose(1, 2)
            bmax = rw[:, 3 * W:6 * W].reshape(-1, 3, W).transpose(1, 2)
            tn, tf = _slab(bmin, bmax, o[wi][:, None, :], iv[wi][:, None, :])
            hit = (bmin[..., 0] <= bmax[..., 0]) & (tn <= tf) & (tf >= 0.0) & (
                tn < t_prune[wi][:, None]
            )
            key = torch.where(hit, tn, INF)
            skey, order = torch.sort(key, dim=1, stable=True)
            sref = torch.gather(rw[:, 6 * W:7 * W], 1, order).long()
            n_valid = (skey < INF).sum(dim=1)
            has = n_valid > 0
            # push sorted children 1..n-1 far-to-near above the current depth
            d0 = dep[wi]
            for k in range(1, W):
                sel = n_valid - 1 >= k
                if not bool(sel.any()):
                    break
                pos = d0 + (n_valid - 1 - k)
                sel &= pos < D  # past the stack: dropped, as the kernel does
                stack[act[wi[sel]], pos[sel]] = sref[sel, k]
            dep_w = d0 + torch.where(has, n_valid - 1, 0)
            depth[act[wi]] = dep_w
            dep[wi] = dep_w
            nxt[wi] = torch.where(has, sref[:, 0], TERM)
            need_pop[wi] = ~has

        # ---- leaf: LT triangles, Moller-Trumbore, tournament min ---------
        li = torch.nonzero(~is_wide).squeeze(1)
        found = torch.zeros_like(is_wide)
        if li.numel():
            rl = row[li]
            a = lambda k: rl[:, k * LT:(k + 1) * LT]
            ol, dl = o[li], dd[li]
            ox, oy, oz = ol[:, 0:1], ol[:, 1:2], ol[:, 2:3]
            dx, dy, dz = dl[:, 0:1], dl[:, 1:2], dl[:, 2:3]
            p0x, p0y, p0z = a(0), a(1), a(2)
            e1x, e1y, e1z = a(3) - p0x, a(4) - p0y, a(5) - p0z
            e2x, e2y, e2z = a(6) - p0x, a(7) - p0y, a(8) - p0z
            tmeta = a(15).long()
            orig = tmeta >> 2
            flags = tmeta & 3
            pvx = dy * e2z - dz * e2y
            pvy = dz * e2x - dx * e2z
            pvz = dx * e2y - dy * e2x
            det = e1x * pvx + e1y * pvy + e1z * pvz
            det_ok = torch.abs(det) > 1e-12
            facing = ((flags & 1) != 0) | (det > 1e-12) if cull else det_ok
            inv_det = 1.0 / torch.where(det_ok, det, 1.0)
            tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
            uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
            qvx = tvy * e1z - tvz * e1y
            qvy = tvz * e1x - tvx * e1z
            qvz = tvx * e1y - tvy * e1x
            vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det
            tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
            cnt = (vleaf[li] & (LT - 1)) + 1
            geo = (
                (lane[None] < cnt[:, None]) & det_ok & facing
                & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0) & (tt > 0.0)
            )
            tbl = tb[li][:, None]
            is_alpha = (flags & 2) != 0
            opq = geo & ~is_alpha & (tt < tbl) if cand else geo & (tt < tbl)
            of = orig.float()
            bt, bo, bu, bv = _minfold([torch.where(opq, tt, INF), of, uu, vv])
            upd = bt < tb[li]
            ids = act[li]
            t_best[ids] = torch.where(upd, bt, t_best[ids])
            tri[ids] = torch.where(upd, bo.long(), tri[ids])
            u[ids] = torch.where(upd, bu, u[ids])
            v[ids] = torch.where(upd, bv, v[ids])
            if cand:
                ctl = ct[li][:, None]
                alp = geo & is_alpha & (tt < tbl) & (tt < ctl)
                wbar = 1.0 - uu - vv
                tu = a(9) * wbar + a(11) * uu + a(13) * vv
                tv = a(10) * wbar + a(12) * uu + a(14) * vv
                ft, fo, fu, fv, ftu, ftv = _minfold(
                    [torch.where(alp, tt, INF), of, uu, vv, tu, tv]
                )
                cu = ft < ct[li]
                c_t[ids] = torch.where(cu, ft, c_t[ids])
                c_tri[ids] = torch.where(cu, fo.long(), c_tri[ids])
                c_u[ids] = torch.where(cu, fu, c_u[ids])
                c_v[ids] = torch.where(cu, fv, c_v[ids])
                c_uvu[ids] = torch.where(cu, ftu, c_uvu[ids])
                c_uvv[ids] = torch.where(cu, ftv, c_uvv[ids])
            if mode == "any":
                found[li] = upd

        # ---- next node: pop where done with the node ---------------------
        need_pop = need_pop & ~found
        can_pop = need_pop & (dep > 0)
        top = stack[act, torch.clamp(dep - 1, min=0, max=D - 1)]
        top = torch.where(dep - 1 < D, top, TERM)
        nxt = torch.where(can_pop, top, nxt)
        depth[act] = dep - can_pop.long()
        cur[act] = nxt

    if cand:
        t_out = torch.where(c_tri >= 0, c_t, INF)
        return t_out, c_tri, c_u, c_v, steps, c_uvu, c_uvv
    t_out = torch.where(tri >= 0, t_best, INF)
    return t_out, tri, u, v, steps, None, None


# ---------------------------------------------------------------------------
# CUDA kernel: build at first use, bind through ctypes, launch.
# ---------------------------------------------------------------------------

_libs = {}


def build(width: int = 16, verbose: bool = False) -> str:
    """Compile ``csrc/traverse.cu`` for rows ``width`` wide into
    ``_build/libtraverse<width>.so`` when the library is missing or older
    than the source (one library per width, so the two build in parallel).
    Returns the library path."""
    if width not in WIDTHS:
        raise ValueError(f"the kernel takes rows 16 or 32 wide, not {width}")
    return cuda_build.build(f"traverse{width}", "traverse.cu", verbose=verbose,
                            defines=[f"VKRT_WIDTH={width}"])


def _load(width: int):
    if width not in _libs:
        lib = ctypes.CDLL(build(width))
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.vkrt_traverse.argtypes = [
            i32, i32, i32, p, i32, p, p, p, p, p, i64, p, p, p, p, p, p, p, p,
        ]
        lib.vkrt_traverse.restype = i32
        lib.vkrt_traverse_capped.argtypes = [
            i32, p, i64, i32, p, p, p, i64, i32, i32, p, i64, i64, p, p, p, p, p, p,
        ]
        lib.vkrt_traverse_capped.restype = i32
        lib.vkrt_traverse_capped_occupancy.argtypes = [i32, i32]
        lib.vkrt_traverse_capped_occupancy.restype = i32
        lib.vkrt_traverse_capped_slots.argtypes = [i32, i32]
        lib.vkrt_traverse_capped_slots.restype = i64
        lib.vkrt_traverse_capped_words.argtypes = [i32, i32, i32, i64]
        lib.vkrt_traverse_capped_words.restype = i64
        lib.vkrt_sort_children.argtypes = [p, p, i64, i32, p, p, p, p]
        lib.vkrt_sort_children.restype = i32
        lib.vkrt_root_prefilter.argtypes = [i32, p, p, p, p, p, i64, p, p]
        lib.vkrt_root_prefilter.restype = i32
        lib.vkrt_alpha_machine.argtypes = [
            i32, i32, i32, p, i32, p, p, p, i32, p, i64, p, i64, i64, p, p, p, p, p, i64, i32,
            p, i64, i64, p, p, p, p, p, p, p, p,
        ]
        lib.vkrt_alpha_machine.restype = i32
        lib.vkrt_alpha_rounds.argtypes = [
            i32, i32, p, i32, p, p, p, p, p, p, i64, p, i64, i64, i64, i32, p, i64, i64, p, p, p,
            p, p, p, p,
        ]
        lib.vkrt_alpha_rounds.restype = i32
        lib.vkrt_opaque_machine.argtypes = [
            i32, i32, i32, p, i32, p, p, p, i32, p, p, p, p, i64, p, i64, i64, p, p, p, p, p, p,
            p,
        ]
        lib.vkrt_opaque_machine.restype = i32
        lib.vkrt_machine_occupancy.argtypes = [i32, i32, i32]
        lib.vkrt_machine_occupancy.restype = i32
        lib.vkrt_machine_slots.argtypes = [i32, i32, i32]
        lib.vkrt_machine_slots.restype = i64
        lib.vkrt_traverse_max_stack.restype = i32
        lib.vkrt_traverse_shared_stack.restype = i32
        lib.vkrt_traverse_ab_occupancy.argtypes = [i32]
        lib.vkrt_traverse_ab_occupancy.restype = i32
        lib.vkrt_traverse_ab_slots.argtypes = [i32]
        lib.vkrt_traverse_ab_slots.restype = i64
        lib.vkrt_traverse_ab_words.argtypes = [i32, i64]
        lib.vkrt_traverse_ab_words.restype = i64
        lib.vkrt_traverse_ab.argtypes = [
            i32, i32, p, i32, p, p, p, p, i64, p, i64, i64, p, p, p, p, p, p,
        ]
        lib.vkrt_traverse_ab.restype = i32
        _libs[width] = lib
    return _libs[width]


def _check(name, x, shape, dt, dev):
    if x.device != dev or x.dtype != dt or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dt} {shape} on {dev}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
        )


def _check_rays(lib, planar, origin, direction, t_max, active=None):
    """Shapes, types and devices the kernel takes; returns the active mask
    as a contiguous tensor (None without one), which the caller keeps alive
    until the launch."""
    R, dev, rows = origin.shape[0], origin.device, planar.rows
    if planar.width not in WIDTHS:
        raise ValueError(f"the CUDA kernel takes rows 16 or 32 wide, got {planar.width}")
    _check("rows", rows, (rows.shape[0], planar.width * 8), torch.float32, dev)
    _check("origin", origin, (R, 3), torch.float32, dev)
    _check("direction", direction, (R, 3), torch.float32, dev)
    _check("t_max", t_max, (R,), torch.float32, dev)
    if planar.stack_depth > lib.vkrt_traverse_max_stack():
        raise ValueError(
            f"tree stack bound {planar.stack_depth} exceeds the kernel's "
            f"{lib.vkrt_traverse_max_stack()}"
        )
    if active is None:
        return None
    if active.device != dev or active.dtype != torch.bool or tuple(active.shape) != (R,):
        raise ValueError("active: want a (R,) bool tensor on the rays' device")
    return active.contiguous()


def _outputs(R, dev, cand):
    f = lambda: torch.empty(R, dtype=torch.float32, device=dev)  # noqa: E731
    return (f(), torch.empty(R, dtype=torch.int32, device=dev), f(), f(),
            torch.empty(R, dtype=torch.int32, device=dev),
            f() if cand else None, f() if cand else None)


def _ptr(x):
    return None if x is None else x.data_ptr()


class PersistentGrid:
    """The host state of one library's persistent entries: per (device,
    entry) the entry's resident threads, and per (device, stream) one scratch
    (the ray counter, the deepest stack a ray reached, the stack spill) that
    every call of its entries on that stream reuses.

    An entry's C call resets the scratch's head and then launches on the
    stream. Two host threads on one stream (the viewer's render loop and a
    ``/pick``) must not interleave those: the second reset would land
    before the first launch, and the second kernel would find the ray
    counter already past its rays and trace none. So a call holds the
    grid's lock from the scratch's lookup through its C call (the
    ``with`` of :meth:`state`); the stream then runs reset, kernel, reset,
    kernel."""

    def __init__(self):
        self.slots = {}
        self.scratch = {}
        self.lock = threading.Lock()

    def clear(self):
        self.slots.clear()
        self.scratch.clear()

    @contextmanager
    def state(self, dev, entry, slots_of, words_of):
        """Entry ``entry``'s resident threads (``slots_of()``, asked once a
        device) and the scratch on ``dev``'s current stream, grown to
        ``words_of(slots)`` int32 words, as (scratch, slots, stream), with
        the grid's lock held until the ``with`` block (the entry's C call)
        ends."""
        dev = cuda_device(dev)
        with self.lock:
            if (dev, entry) not in self.slots:
                slots = slots_of()
                if slots <= 0:
                    raise RuntimeError(f"no resident threads for the persistent entry {entry}")
                self.slots[dev, entry] = slots
            slots = self.slots[dev, entry]
            stream = torch.cuda.current_stream(dev).cuda_stream
            words = words_of(slots)
            scratch = self.scratch.get((dev, stream))
            if scratch is None or scratch.numel() < words:
                scratch = torch.empty(words, dtype=torch.int32, device=dev)
                self.scratch[dev, stream] = scratch
            yield scratch, slots, stream

    def _head(self, device):
        dev = cuda_device(device)
        return self.scratch[(dev, torch.cuda.current_stream(dev).cuda_stream)][:6].tolist()

    def stack_reached(self, device) -> int:
        """The deepest stack a ray reached in the last call of any entry on
        ``device``'s current stream (waits for it)."""
        return self._head(device)[1]

    def lane_steps(self, device):
        """What the last call's warps counted on ``device``'s current stream,
        where the entry counts (the round machines, the single-level alpha
        rounds at width 16 only; waits for it): (the
        lanes' node steps, the lane slots of the warps' node loops). Their
        quotient is the share of the warps' lane-steps that do work."""
        _, _, busy, slots, _, _ = self._head(device)
        return busy % 2**32, slots % 2**32

    def intake(self, device):
        """The last single-level alpha rounds call's intake on ``device``'s
        current stream (waits for it): (rays fetched, rays that needed the
        rounds)."""
        return tuple(self._head(device)[4:6])


def cuda_device(dev):
    """``dev`` with its index (the current CUDA device where it has none)."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


# Per row width: the persistent a/b entries of that width's library (the
# round machines share them), and the capped entry's own, so that the
# micro-bench's deeper spill never grows the main path's scratch.
_AB_GRIDS = {w: PersistentGrid() for w in WIDTHS}
_CAPPED_GRIDS = {w: PersistentGrid() for w in WIDTHS}


def ab_occupancy(width: int, mode: str) -> int:
    """Blocks of the persistent mode a/b kernel (``mode`` "closest" or
    "any") that reside on one SM of the current device."""
    blocks = _load(width).vkrt_traverse_ab_occupancy(_MODE_ID[mode])
    if blocks <= 0:
        raise RuntimeError(f"no occupancy for the {mode} kernel at width {width}")
    return blocks


# The round machines' kinds (``vkrt_machine_occupancy``): the two-level
# opaque (0, False) and alpha (1, True) machines and the single-level alpha
# rounds (2).
ROUNDS = 2
_MACHINE_NAMES = ("opaque_machine", "alpha_machine", "alpha_rounds")


def machine_occupancy(width: int, kind, any_hit: bool, n_inst: int) -> int:
    """Blocks of a round machine kernel that reside on one SM of the current
    device: ``kind`` False (0) the opaque machine, True (1) the alpha
    machine, closest or any hit, for ``n_inst`` instances (the instance
    table in shared memory up to 512); :data:`ROUNDS` the single-level alpha
    rounds with culling (``any_hit`` False) or without (True), ``n_inst``
    unused."""
    blocks = _load(width).vkrt_machine_occupancy(int(kind), int(any_hit), n_inst)
    if blocks <= 0:
        raise RuntimeError(f"no occupancy for the {_MACHINE_NAMES[int(kind)]} kernel at width "
                           f"{width}")
    return blocks


def machine_state(lib, planar, dev, kind, any_hit: bool, n_inst: int):
    """The persistent grid of a round machine (``kind`` as in
    :func:`machine_occupancy`) on ``planar``'s width: (scratch, resident
    threads, stream) on ``dev``'s current stream, the scratch shared with
    the a/b entries; a context manager (:meth:`PersistentGrid.state`) around
    the entry's C call."""
    entry = (_MACHINE_NAMES[int(kind)], int(any_hit), n_inst)
    return _AB_GRIDS[planar.width].state(
        dev, entry, lambda: lib.vkrt_machine_slots(int(kind), int(any_hit), n_inst),
        lambda slots: lib.vkrt_traverse_ab_words(planar.stack_depth, slots))


def stack_reached(width: int, device) -> int:
    """The deepest stack a ray reached in the last mode a/b call from the
    root at ``width`` on ``device``'s current stream (waits for it)."""
    return _AB_GRIDS[width].stack_reached(device)


def _traverse_ab(lib, planar, origin, direction, t_max, active, mode):
    """Modes a/b from the root: the persistent kernel ``vkrt_traverse_ab``."""
    R, dev = origin.shape[0], origin.device
    t, tri, u, v, steps, _, _ = _outputs(R, dev, False)
    if R == 0:  # nothing to launch, and so nothing to count
        return t, tri.long(), u, v, steps, None, None
    with _AB_GRIDS[planar.width].state(
            dev, mode, lambda: lib.vkrt_traverse_ab_slots(_MODE_ID[mode]),
            lambda slots: lib.vkrt_traverse_ab_words(planar.stack_depth, slots)) as (
            scratch, slots, stream):
        err = lib.vkrt_traverse_ab(
            _MODE_ID[mode], planar.width, planar.rows.data_ptr(), planar.stack_depth,
            origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(), _ptr(active), R,
            scratch.data_ptr(), scratch.numel(), slots, t.data_ptr(), tri.data_ptr(),
            u.data_ptr(), v.data_ptr(), steps.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"traverse kernel launch failed: cudaError {err}")
    LAUNCHES[launch_key(mode, planar.width)] += 1
    return t, tri.long(), u, v, steps, None, None


def _traverse_cuda(planar, origin, direction, t_max, active, mode, cull, root0=None):
    lib = _load(planar.width)
    R, dev = origin.shape[0], origin.device
    active = _check_rays(lib, planar, origin, direction, t_max, active)
    if root0 is None and mode != "candidate":
        return _traverse_ab(lib, planar, origin, direction, t_max, active, mode)
    if root0 is not None:
        if (root0.device != dev or root0.dtype != torch.int32 or tuple(root0.shape) != (R,)
                or not root0.is_contiguous()):
            raise ValueError("root0: want a contiguous (R,) int32 tensor on the rays' device")
    t, tri, u, v, steps, uvu, uvv = _outputs(R, dev, mode == "candidate")
    if R == 0:  # nothing to launch, and so nothing to count
        return t, tri.long(), u, v, steps, uvu, uvv
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.vkrt_traverse(
        _MODE_ID[mode], int(cull), planar.width, planar.rows.data_ptr(), planar.stack_depth,
        origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(), _ptr(active), _ptr(root0), R,
        t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(), steps.data_ptr(),
        _ptr(uvu), _ptr(uvv), stream,
    )
    if err != 0:
        raise RuntimeError(f"traverse kernel launch failed: cudaError {err}")
    LAUNCHES[launch_key(mode if root0 is None else f"{mode}_roots", planar.width)] += 1
    return t, tri.long(), u, v, steps, uvu, uvv


def traverse(planar, origin, direction, t_max, active=None, mode="closest", cull=True,
             root0=None):
    """Run one traversal mode, from the tree's root or, with ``root0`` (an
    (R,) int32 tensor of interior rows), from each ray's own root. CPU
    tensors take the plain twin; CUDA tensors launch the kernel (or raise).
    Returns (t, tri, u, v, steps, uvu, uvv); the last two are None outside
    candidate mode."""
    if (mode, cull) not in _MODE_CULL:
        raise ValueError(f"no traversal for mode {mode!r} with cull={cull}")
    if origin.device.type == "cuda":
        return _traverse_cuda(planar, origin, direction, t_max, active, mode, cull, root0)
    if origin.device.type != "cpu":
        raise ValueError(f"no traversal for device {origin.device}")
    return _traverse_plain(planar, origin, direction, t_max, active, mode, cull, root0=root0)


def own_rows(planar: PlanarScene, n: int) -> PlanarScene:
    """The no-gather variant's table for ``n`` rays: ``planar``'s rows,
    zero-padded to ``n`` rows where it has fewer, so that ray r reads row r
    (``scripts/stepbench.py`` feeds ``rows[0:P]``, zero-padded)."""
    rows = planar.rows
    if rows.shape[0] >= n:
        return planar
    pad = rows.new_zeros((n - rows.shape[0], rows.shape[1]))
    return dataclasses.replace(planar, rows=torch.cat([rows, pad]))


def traverse_capped(planar, origin, direction, t_max, max_steps: int, nogather=False):
    """Closest hit (backface culling, from the tree's root) stopped after
    ``max_steps`` nodes per ray; with ``nogather``, the no-gather timing
    variant (ray r reads row r of ``planar``, which needs a row per ray,
    :func:`own_rows`, and starts over at the root where it would end: wrong
    hits by design, the same on both devices). CPU tensors take the plain
    twin; CUDA tensors launch the kernel's capped entry (or raise): mode
    a's persistent node loops, with a scratch of its own
    (:func:`capped_stack_reached`). Returns (t, tri, u, v, steps, None,
    None)."""
    if max_steps < 0:
        raise ValueError(f"max_steps must be >= 0, got {max_steps}")
    R = origin.shape[0]
    if nogather and planar.rows.shape[0] < R:
        raise ValueError(f"no-gather: {R} rays need {R} rows, the table has "
                         f"{planar.rows.shape[0]}; pad it with own_rows()")
    if origin.device.type == "cpu":
        return _traverse_plain(planar, origin, direction, t_max, None, "closest", True,
                               max_steps=max_steps, nogather=nogather)
    if origin.device.type != "cuda":
        raise ValueError(f"no traversal for device {origin.device}")
    return _traverse_capped_cuda(planar, origin, direction, t_max, max_steps, nogather)


def _traverse_capped_cuda(planar, origin, direction, t_max, max_steps, nogather):
    """One launch of ``vkrt_traverse_capped``."""
    lib = _load(planar.width)
    R, dev = origin.shape[0], origin.device
    _check_rays(lib, planar, origin, direction, t_max)
    t, tri, u, v, steps, _, _ = _outputs(R, dev, False)
    if R == 0:  # nothing to launch, and so nothing to count
        return t, tri.long(), u, v, steps, None, None
    cap, ng = int(max_steps), int(bool(nogather))
    with _CAPPED_GRIDS[planar.width].state(
            dev, ("capped", ng, cap), lambda: lib.vkrt_traverse_capped_slots(cap, ng),
            lambda slots: lib.vkrt_traverse_capped_words(planar.stack_depth, cap, ng, slots)) as (
            scratch, slots, stream):
        err = lib.vkrt_traverse_capped(
            planar.width, planar.rows.data_ptr(), planar.rows.shape[0], planar.stack_depth,
            origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(), R, cap, ng,
            scratch.data_ptr(), scratch.numel(), slots, t.data_ptr(), tri.data_ptr(),
            u.data_ptr(), v.data_ptr(), steps.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"capped traverse kernel launch failed: cudaError {err}")
    LAUNCHES[launch_key("nogather" if nogather else "capped", planar.width)] += 1
    return t, tri.long(), u, v, steps, None, None


def capped_stack_reached(width: int, device) -> int:
    """The deepest stack a ray reached in the last :func:`traverse_capped`
    call at ``width`` on ``device``'s current stream (waits for it; the
    no-gather variant's depth counts its dropped pushes too)."""
    return _CAPPED_GRIDS[width].stack_reached(device)


def shared_stack(width: int) -> int:
    """Stack entries a thread of the persistent entries at ``width`` holds in
    shared memory: at width 16, below this many steps
    :func:`traverse_capped`'s kernel keeps them as a ring and needs no
    spill."""
    return _load(width).vkrt_traverse_shared_stack()


def capped_occupancy(width: int, max_steps: int, nogather: bool) -> int:
    """Blocks of the capped kernel that :func:`traverse_capped` launches for
    ``max_steps`` and ``nogather`` that reside on one SM of the current
    device."""
    blocks = _load(width).vkrt_traverse_capped_occupancy(int(max_steps), int(bool(nogather)))
    if blocks <= 0:
        raise RuntimeError(f"no occupancy for the capped kernel at width {width}")
    return blocks


def _sort_children_plain(keys, refs):
    """Plain version of :func:`sort_children`: a stable ``torch.sort`` of
    each row with every miss (a key not below ``INF``, NaN included) sorted
    as ``INF``, and the keys and refs gathered in that order."""
    hit = keys < INF
    _, order = torch.sort(torch.where(hit, keys, INF), dim=1, stable=True)
    return (torch.gather(keys, 1, order), torch.gather(refs, 1, order),
            hit.sum(dim=1, dtype=torch.int32))


def sort_children(keys, refs):
    """The child order of interior rows: ``keys`` (N, W) f32 entry
    distances, ``INF`` for a child the ray misses, ``refs`` (N, W) int32.
    Returns (sorted keys, refs in key order, (N,) int32 hit count): keys
    ascending and stable, the misses (keys not below ``INF``, NaN
    included) last in row order. CPU tensors take the
    plain version; CUDA tensors launch ``vkrt_sort_children`` (or raise)."""
    if keys.dim() != 2 or keys.shape[1] not in WIDTHS:
        raise ValueError(f"keys: want (N, 16) or (N, 32), got {tuple(keys.shape)}")
    if keys.device.type == "cpu":
        return _sort_children_plain(keys, refs)
    if keys.device.type != "cuda":
        raise ValueError(f"no child sort for device {keys.device}")
    n, w = keys.shape
    dev = keys.device
    _check("keys", keys, (n, w), torch.float32, dev)
    _check("refs", refs, (n, w), torch.int32, dev)
    out_k = torch.empty_like(keys)
    out_r = torch.empty_like(refs)
    count = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out_k, out_r, count
    err = _load(w).vkrt_sort_children(
        keys.data_ptr(), refs.data_ptr(), n, w, out_k.data_ptr(), out_r.data_ptr(),
        count.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"sort_children kernel launch failed: cudaError {err}")
    LAUNCHES[launch_key("sort_children", w)] += 1
    return out_k, out_r, count


def closest_hit_fused(planar, origin, direction, active=None) -> Hit:
    """Mode a: nearest hit with backface culling; rays outside ``active``
    (an optional (R,) bool mask) miss."""
    t_max = torch.full(origin.shape[:1], INF, device=origin.device)
    t, tri, u, v, steps, _, _ = traverse(planar, origin, direction, t_max, active, "closest", True)
    return Hit(t, tri, u, v, steps)


def any_hit_fused(planar, origin, direction, t_max, active=None) -> torch.Tensor:
    """Mode b: occlusion within ``t_max`` (no culling)."""
    _, tri, _, _, _, _, _ = traverse(planar, origin, direction, t_max, active, "any", False)
    return tri >= 0


def candidate_hit_fused(planar, origin, direction, t_max, active=None, cull=True):
    """Mode c: nearest alpha-flagged hit within ``t_max`` plus its texture
    UV. Returns ``(Hit, uvu, uvv)``."""
    t, tri, u, v, steps, uvu, uvv = traverse(
        planar, origin, direction, t_max, active, "candidate", cull
    )
    return Hit(t, tri, u, v, steps), uvu, uvv
