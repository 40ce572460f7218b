"""Closest/any hit over an accel bundle, by either traversal back end, and the
alpha-test tables (counterpart of ``vk_raytrace_tpu/ops/traverse_wide.py``).

Two interchangeable back ends, as in the reference (its ``--renderer
fused|wide``, the createRender analog of ``sample_example.cpp:322-337``):

* ``fused``: the planar trees; the opaque tree runs traversal mode a
  (closest) or b (any), the alpha tree candidate rounds (mode c,
  ``ops/traverse_alpha.py``) pruned by the opaque result;
* ``wide`` (the RayQuery analog): the 8-wide trees of ``ops/bvh8.py``
  (:class:`~vk_raytrace_torch.ops.bvh8.WideScene`); one pass per ray in which
  every alpha-flagged candidate gets its stochastic test inside the
  traversal (the any-hit shader analog), in the order the reference draws:
  near-to-far by its 8-input comparator network, leaf triangles k = 0..3,
  no draw for opaque or culled candidates. The closest hit runs the opaque
  tree without the test, then the alpha tree windowed by the opaque t; the
  any hit runs the alpha tree only for rays the opaque tree left unoccluded.

:func:`traverse_wide` dispatches on the tensors' device: CUDA tensors launch
``vkrt_traverse_wide`` (``csrc/traverse_wide.cu``: persistent warps, the
stack in shared memory) or raise; CPU tensors run the plain version
:func:`_traverse_wide_plain`, a torch loop over the same rows with the same
semantics that advances every live ray by one node a step. The two-level
passes' machine ``vkrt_wide_machine`` lives in the same library; its wrapper
is ``tlas._wide_machine_cuda``. The reference's phased while-loop, compaction
and merge are XLA scaffolding and have no counterpart.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from .. import cuda_build
from . import rng
from . import traverse_fused as tf
from .traverse_fused import INF, TERM, Hit

BACKENDS = ("fused", "wide")


@dataclasses.dataclass
class AlphaPack:
    """Gather-minimal alpha-test tables: one 16-lane row per triangle
    (a_factor, mode, cutoff, tex_id, uvT 3x2, atlas x/y/w/h, wrap_s/t) and
    the atlas alpha channel, flat."""

    rows: torch.Tensor
    alpha_plane: torch.Tensor
    atlas_width: int


def make_alpha_pack(materials, atlas, tri_material=None) -> AlphaPack:
    """Per-triangle alpha rows (per-material when ``tri_material`` is None)
    from the device material and atlas tables."""
    m, at = materials, atlas
    t = m.uv_transform
    tex = torch.clamp(m.base_color_texture, 0, at.x.shape[0] - 1)
    rows = torch.stack(
        [
            m.base_color_factor[:, 3],
            m.alpha_mode.float(),
            m.alpha_cutoff,
            m.base_color_texture.float(),
            t[:, 0, 0], t[:, 0, 1], t[:, 1, 0], t[:, 1, 1], t[:, 2, 0], t[:, 2, 1],
            at.x[tex].float(), at.y[tex].float(),
            at.width[tex].float(), at.height[tex].float(),
            at.wrap_s[tex].float(), at.wrap_t[tex].float(),
        ],
        dim=1,
    )
    if tri_material is not None:
        rows = rows[torch.clamp(tri_material, 0, rows.shape[0] - 1)]
    return AlphaPack(
        rows=rows,
        alpha_plane=at.data[:, :, 3].reshape(-1).contiguous(),  # read by the alpha kernels
        atlas_width=int(at.data.shape[1]),
    )


@dataclasses.dataclass
class AccelBundle:
    """Opaque and alpha trees: the planar ones of the fused back end
    (``alpha_planar`` None when the scene has no alpha-tested triangles) and
    the 8-wide ones of the wide back end (``opaque``, ``alpha``; None until
    ``ops/bvh8.py::with_wide`` builds them)."""

    opaque_planar: tf.PlanarScene
    alpha_planar: Optional[tf.PlanarScene] = None
    opaque: Optional[object] = None
    alpha: Optional[object] = None

    def to(self, device) -> "AccelBundle":
        move = lambda x: None if x is None else x.to(device)  # noqa: E731
        return AccelBundle(move(self.opaque_planar), move(self.alpha_planar),
                           move(self.opaque), move(self.alpha))


def check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"no traversal back end {backend!r}; the port has {BACKENDS}")


def _merge(hit_o, hit_a):
    """The opaque hit, or the alpha hit where there is one (the alpha pass
    ran windowed by the opaque t, so it is nearer)."""
    take_a = hit_a.tri >= 0
    return Hit(
        t=torch.where(take_a, hit_a.t, hit_o.t),
        tri=torch.where(take_a, hit_a.tri, hit_o.tri),
        u=torch.where(take_a, hit_a.u, hit_o.u),
        v=torch.where(take_a, hit_a.v, hit_o.v),
        steps=hit_o.steps + hit_a.steps,
    )


def _need_wide(bundle) -> None:
    if bundle.opaque is None:
        raise ValueError("the wide back end needs the bundle's 8-wide tables: "
                         "ops/bvh8.with_wide(bundle, geometry)")


def closest_hit_bundle(bundle, pack, origin, direction, seed, active=None, backend="fused"):
    """Opaque closest hit, then the nearest alpha surface in front of it
    that passes its stochastic test, by ``backend`` ("fused" or "wide").
    Returns ``(Hit, seed')``; rays outside ``active`` (an optional (R,) bool
    mask) miss and keep their seed."""
    check_backend(backend)
    if backend == "wide":
        _need_wide(bundle)
        hit_o, seed = closest_hit_wide(bundle.opaque, None, origin, direction, seed, active)
        if bundle.alpha is None:
            return hit_o, seed
        hit_a, seed = closest_hit_wide(bundle.alpha, pack, origin, direction, seed, active,
                                       t_max=hit_o.t)
        return _merge(hit_o, hit_a), seed
    from . import traverse_alpha as ta

    hit_o = tf.closest_hit_fused(bundle.opaque_planar, origin, direction, active=active)
    if bundle.alpha_planar is None:
        return hit_o, seed
    hit_a, seed = ta.closest_hit_alpha(
        bundle.alpha_planar, pack, origin, direction, hit_o.t, seed=seed, active=active
    )
    return _merge(hit_o, hit_a), seed


def any_hit_bundle(bundle, pack, origin, direction, t_max, seed, active=None, backend="fused"):
    """Shadow-ray occlusion by ``backend`` ("fused" or "wide"): opaque any
    hit, then the alpha tree for the rays still unoccluded. Returns
    ``(occluded, seed')``."""
    check_backend(backend)
    if backend == "wide":
        _need_wide(bundle)
        occ, seed = any_hit_wide(bundle.opaque, None, origin, direction, t_max, seed, active)
    else:
        occ = tf.any_hit_fused(bundle.opaque_planar, origin, direction, t_max, active=active)
    alpha = bundle.alpha if backend == "wide" else bundle.alpha_planar
    if alpha is None:
        return occ, seed
    still = active & ~occ if active is not None else ~occ
    if backend == "wide":
        occ_a, seed = any_hit_wide(alpha, pack, origin, direction, t_max, seed, still)
    else:
        from . import traverse_alpha as ta

        occ_a, seed = ta.any_hit_alpha(alpha, pack, origin, direction, t_max, seed=seed,
                                       active=still)
    return occ | occ_a, seed


def closest_hit_wide(wide, pack, origin, direction, seed=None, active=None, t_max=None,
                     root0=None):
    """Closest hit with backface culling over one 8-wide tree within
    ``t_max`` (default ``INF``), the alpha test inline with ``pack``.
    Returns ``(Hit, seed')``."""
    if t_max is None:
        t_max = torch.full(origin.shape[:1], INF, device=origin.device)
    t, tri, u, v, steps, seed = traverse_wide(wide, pack, origin, direction, t_max, seed,
                                              active, any_hit=False, root0=root0)
    return Hit(t, tri, u, v, steps), seed


def any_hit_wide(wide, pack, origin, direction, t_max, seed=None, active=None):
    """First accepted hit within ``t_max`` over one 8-wide tree, no
    culling. Returns ``(occluded, seed')``."""
    _, tri, _, _, _, seed = traverse_wide(wide, pack, origin, direction, t_max, seed, active,
                                          any_hit=True)
    return tri >= 0, seed


# ---------------------------------------------------------------------------
# The traversal: plain version and kernel
# ---------------------------------------------------------------------------

# The reference's _SORT8_NETWORK (Batcher's odd-even merge sort, 19
# comparators): the child order, and so the order of the alpha draws.
SORT8_NETWORK = (
    (0, 1), (2, 3), (4, 5), (6, 7),
    (0, 2), (1, 3), (4, 6), (5, 7),
    (1, 2), (5, 6),
    (0, 4), (1, 5), (2, 6), (3, 7),
    (2, 4), (3, 5),
    (1, 2), (3, 4), (5, 6),
)
_EPS_DET = 1e-12
_ROOT_BIG = 3.0e38


def _inv_dir(d):
    """1/d with |d| < 1e-20 clamped to +-1e-20 (``traverse_wide.py:129-135``)."""
    tiny = torch.where(d < 0, -1e-20, 1e-20).to(d.dtype)
    return 1.0 / torch.where(torch.abs(d) < 1e-20, tiny, d)


def _slab8(bx, o, iv):
    """Entry and exit t of rays (n, 3) into the 8 boxes of their rows
    (n, 8, 6)."""
    ts = []
    for a in range(3):
        lo = (bx[:, :, a] - o[:, a:a + 1]) * iv[:, a:a + 1]
        hi = (bx[:, :, 3 + a] - o[:, a:a + 1]) * iv[:, a:a + 1]
        ts.append((torch.minimum(lo, hi), torch.maximum(lo, hi)))
    tn = torch.maximum(torch.maximum(ts[0][0], ts[1][0]), ts[2][0])
    tfar = torch.minimum(torch.minimum(ts[0][1], ts[1][1]), ts[2][1])
    return tn, tfar


def _root_union_hit(rows, origin, inv_d, t_max):
    """One slab test against the union of the root row's valid child boxes."""
    rb = rows[0, 0:48].reshape(8, 6)
    valid = rb[:, 0] <= rb[:, 3]
    mn = torch.where(valid[:, None], rb[:, 0:3], _ROOT_BIG).amin(dim=0)
    mx = torch.where(valid[:, None], rb[:, 3:6], -_ROOT_BIG).amax(dim=0)
    tn, tfar = _slab8(torch.cat([mn, mx])[None, None].expand(origin.shape[0], 1, 6),
                      origin, inv_d)
    return (tn[:, 0] <= tfar[:, 0]) & (tfar[:, 0] >= 0.0) & (tn[:, 0] < t_max)


def _sort8(key, ref):
    """The network over (n, 8) keys with refs riding along: ascending,
    unstable on ties as the reference's."""
    k = list(key.unbind(1))
    r = list(ref.unbind(1))
    for i, j in SORT8_NETWORK:
        swap = k[i] > k[j]
        k[i], k[j] = torch.where(swap, k[j], k[i]), torch.where(swap, k[i], k[j])
        r[i], r[j] = torch.where(swap, r[j], r[i]), torch.where(swap, r[i], r[j])
    return torch.stack(k, 1), torch.stack(r, 1)


def check_stack(wide) -> int:
    """The kernel's stack entries for ``wide``: its exact bound, which may
    not pass ``bvh8.WIDE_STACK_MAX`` (a deeper tree raises; the reference
    would drop pushes past its cap)."""
    from .bvh8 import WIDE_STACK_MAX

    if not 1 <= wide.stack_depth <= WIDE_STACK_MAX:
        raise ValueError(f"8-wide tree stack bound {wide.stack_depth} outside the kernel's "
                         f"1..{WIDE_STACK_MAX}")
    return wide.stack_depth


def _traverse_wide_plain(wide, pack, origin, direction, t_max, seed, active, any_hit, root0=None,
                         seen=None, draws=None):
    """Plain torch version of the kernel: every step advances all live rays
    by one node, with an (R, D) stack. Returns (t, tri, u, v, steps, seed').
    ``seen``, an optional (X,) int8 tensor over the rows, is set to 1 at
    every interior row and 2 at every leaf row that some ray visits;
    ``draws``, an optional (R,) integer tensor, counts each ray's alpha
    tests."""
    rows = wide.rows
    dev = origin.device
    R = origin.shape[0]
    D = check_stack(wide)
    cull = not any_hit
    inv_d = _inv_dir(direction)
    if root0 is not None:
        cur = root0.long().clone()
    else:
        cur = torch.where(_root_union_hit(rows, origin, inv_d, t_max), 0, TERM).long()
    if active is not None:
        cur = torch.where(active, cur, TERM)
    seed = torch.zeros(R, dtype=torch.int64, device=dev) if seed is None else seed.clone()
    t_best = t_max.clone()
    tri = torch.full((R,), -1, dtype=torch.int64, device=dev)
    u = torch.zeros(R, device=dev)
    v = torch.zeros(R, device=dev)
    steps = torch.zeros(R, dtype=torch.int32, device=dev)
    stack = torch.zeros((R, D), dtype=torch.int64, device=dev)
    depth = torch.zeros(R, dtype=torch.int64, device=dev)
    kk = torch.arange(4, device=dev)

    while True:
        act = torch.nonzero(cur != TERM).squeeze(1)
        if act.numel() == 0:
            break
        c = cur[act]
        steps[act] += 1
        is_wide = c >= 0
        vleaf = -c - 1
        row_id = torch.where(is_wide, c, vleaf >> 2)
        row = rows[row_id]
        if seen is not None:
            seen[row_id] = torch.where(is_wide, 1, 2).to(seen.dtype)
        dep = depth[act]
        nxt = torch.full_like(c, TERM)
        need_pop = ~is_wide

        # ---- interior: 8 slab tests, the network's order, push the rest --
        wi = torch.nonzero(is_wide).squeeze(1)
        if wi.numel():
            ids = act[wi]
            rw = row[wi]
            bx = rw[:, 0:48].reshape(-1, 8, 6)
            tn, tfar = _slab8(bx, origin[ids], inv_d[ids])
            hit = (bx[:, :, 0] <= bx[:, :, 3]) & (tn <= tfar) & (tfar >= 0.0) & (
                tn < t_best[ids][:, None])
            skey, sref = _sort8(torch.where(hit, tn, INF), rw[:, 48:56].long())
            n_valid = (skey < INF).sum(dim=1)
            has = n_valid > 0
            d0 = dep[wi]
            for j in range(7):
                k = n_valid - 1 - j
                sel = (k >= 1) & (d0 + j < D)
                stack[ids[sel], (d0 + j)[sel]] = sref[sel, k[sel]]
            dep_w = torch.clamp(d0 + torch.where(has, n_valid - 1, 0), max=D)
            depth[ids] = dep_w
            dep[wi] = dep_w
            nxt[wi] = torch.where(has, sref[:, 0], TERM)
            need_pop[wi] = ~has

        # ---- leaf: 4 triangles, the alpha test, the tournament -----------
        li = torch.nonzero(~is_wide).squeeze(1)
        if li.numel():
            ids = act[li]
            tr = row[li].reshape(-1, 4, 16)
            a = lambda k: tr[:, :, k]  # noqa: E731
            o, dd = origin[ids], direction[ids]
            ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
            dx, dy, dz = dd[:, 0:1], dd[:, 1:2], dd[:, 2:3]
            p0x, p0y, p0z = a(0), a(1), a(2)
            e1x, e1y, e1z = a(3) - p0x, a(4) - p0y, a(5) - p0z
            e2x, e2y, e2z = a(6) - p0x, a(7) - p0y, a(8) - p0z
            meta = a(15).long()
            orig = meta >> 2
            flags = meta & 3
            pvx = dy * e2z - dz * e2y
            pvy = dz * e2x - dx * e2z
            pvz = dx * e2y - dy * e2x
            det = e1x * pvx + e1y * pvy + e1z * pvz
            det_ok = torch.abs(det) > _EPS_DET
            facing = ((flags & 1) != 0) | (det > _EPS_DET) if cull else det_ok
            inv_det = 1.0 / torch.where(det_ok, det, 1.0)
            tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
            uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
            qvx = tvy * e1z - tvz * e1y
            qvy = tvz * e1x - tvx * e1z
            qvz = tvx * e1y - tvy * e1x
            vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det
            tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
            cnt = (vleaf[li] & 3) + 1
            tb = t_best[ids]
            geo = ((kk[None] < cnt[:, None]) & det_ok & facing & (uu >= 0.0) & (vv >= 0.0)
                   & (uu + vv <= 1.0) & (tt > 0.0) & (tt < tb[:, None]))
            if pack is not None:
                from .traverse_alpha import _alpha_opacity

                needs = geo & ((flags & 2) != 0)
                wbar = 1.0 - uu - vv
                uvu = a(9) * wbar + a(11) * uu + a(13) * vv
                uvv = a(10) * wbar + a(12) * uu + a(14) * vv
                op = _alpha_opacity(pack, orig.reshape(-1), uvu.reshape(-1),
                                    uvv.reshape(-1)).reshape(-1, 4)
                sd = seed[ids]
                for k in range(4):
                    s2, rnd = rng.rand(sd)
                    sd = torch.where(needs[:, k], s2, sd)
                    geo[:, k] &= ~needs[:, k] | (rnd <= op[:, k])
                seed[ids] = sd
                if draws is not None:
                    draws[ids] += needs.sum(dim=1).to(draws.dtype)
            tc = torch.where(geo, tt, INF)
            w01 = torch.where(tc[:, 1] < tc[:, 0], 1, 0)
            w23 = torch.where(tc[:, 3] < tc[:, 2], 3, 2)
            t01 = tc.gather(1, w01[:, None])[:, 0]
            t23 = tc.gather(1, w23[:, None])[:, 0]
            w = torch.where(t23 < t01, w23, w01)[:, None]
            bt = tc.gather(1, w)[:, 0]
            upd = bt < tb
            t_best[ids] = torch.where(upd, bt, tb)
            tri[ids] = torch.where(upd, orig.gather(1, w)[:, 0], tri[ids])
            u[ids] = torch.where(upd, uu.gather(1, w)[:, 0], u[ids])
            v[ids] = torch.where(upd, vv.gather(1, w)[:, 0], v[ids])
            if any_hit:
                need_pop[li] = ~upd  # the first accepted hit occludes

        # ---- next node: pop where done with the node ---------------------
        can_pop = need_pop & (dep > 0)
        top = stack[act, torch.clamp(dep - 1, min=0)]
        nxt = torch.where(can_pop, top, nxt)
        depth[act] = dep - can_pop.long()
        cur[act] = nxt

    t_out = torch.where(tri >= 0, t_best, INF)
    return t_out, tri, u, v, steps, seed


_lib = None
# Both wide entries' persistent state; an entry is (machine, any hit, alpha
# and, for the machine, the instance table's size).
_GRID = tf.PersistentGrid()


def build(verbose: bool = False) -> str:
    """Compile ``csrc/traverse_wide.cu`` into ``_build/libtraverse_wide.so``
    when the library is missing or older than the source. Returns its path."""
    return cuda_build.build("traverse_wide", "traverse_wide.cu", verbose=verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.vkrt_wide_slots.argtypes = [i32, i32, i32, i32]
        lib.vkrt_wide_slots.restype = i64
        lib.vkrt_wide_words.argtypes = [i32, i64]
        lib.vkrt_wide_words.restype = i64
        lib.vkrt_traverse_wide.argtypes = [
            i32, p, i32, p, p, p, p, p, p, p, i64, p, i64, i64, i64, p, i64, i64,
            p, p, p, p, p, p, p,
        ]
        lib.vkrt_traverse_wide.restype = i32
        lib.vkrt_wide_machine.argtypes = [
            i32, p, i32, p, p, p, i32, p, p, p, p, p, p, i64, p, i64, i64, i64, p, i64, i64,
            p, p, p, p, p, p, p, p,
        ]
        lib.vkrt_wide_machine.restype = i32
        _lib = lib
    return _lib


def _persistent(lib, entry, stack_depth, dev):
    """The persistent grid of ``entry``: its resident threads and a scratch
    on the current stream large enough for a tree with this stack bound:
    (scratch, slots, stream), a context manager around the entry's C call
    (:meth:`traverse_fused.PersistentGrid.state`)."""
    return _GRID.state(dev, entry, lambda: lib.vkrt_wide_slots(*entry),
                       lambda slots: lib.vkrt_wide_words(stack_depth, slots))


def stack_reached(device) -> int:
    """The deepest stack a ray reached in the last wide call (either entry)
    on ``device``'s current stream (waits for it)."""
    return _GRID.stack_reached(device)


def _pack_args(pack, dev):
    """The alpha pack's pointers and sizes for either entry (null: none)."""
    if pack is None:
        return None, 0, None, 0, 0
    tf._check("pack rows", pack.rows, (pack.rows.shape[0], 16), torch.float32, dev)
    tf._check("alpha plane", pack.alpha_plane, (pack.alpha_plane.numel(),), torch.uint8, dev)
    return (pack.rows.data_ptr(), pack.rows.shape[0], pack.alpha_plane.data_ptr(),
            pack.alpha_plane.numel(), pack.atlas_width)


def _check_active(active, R, dev):
    if active is None:
        return None
    if active.device != dev or active.dtype != torch.bool or tuple(active.shape) != (R,):
        raise ValueError("active: want a (R,) bool tensor on the rays' device")
    return active.contiguous()


def _traverse_wide_cuda(wide, pack, origin, direction, t_max, seed, active, any_hit, root0):
    lib = _load()
    R, dev, rows = origin.shape[0], origin.device, wide.rows
    depth = check_stack(wide)
    tf._check("rows", rows, (rows.shape[0], 64), torch.float32, dev)
    tf._check("origin", origin, (R, 3), torch.float32, dev)
    tf._check("direction", direction, (R, 3), torch.float32, dev)
    tf._check("t_max", t_max, (R,), torch.float32, dev)
    active = _check_active(active, R, dev)
    if root0 is not None:
        tf._check("root0", root0, (R,), torch.int32, dev)
    if seed is not None:
        tf._check("seed", seed, (R,), torch.int64, dev)
    alpha = _pack_args(pack, dev)
    f = lambda: torch.empty(R, dtype=torch.float32, device=dev)  # noqa: E731
    t, u, v = f(), f(), f()
    tri = torch.empty(R, dtype=torch.int32, device=dev)
    steps = torch.empty(R, dtype=torch.int32, device=dev)
    seed_out = torch.empty(R, dtype=torch.int64, device=dev)
    if R == 0:  # nothing to launch, and so nothing to count
        return t, tri.long(), u, v, steps, seed_out
    with _persistent(lib, (0, int(bool(any_hit)), int(pack is not None), 0), depth, dev) as (
            scratch, slots, stream):
        err = lib.vkrt_traverse_wide(
            int(bool(any_hit)), rows.data_ptr(), depth, origin.data_ptr(), direction.data_ptr(),
            t_max.data_ptr(), tf._ptr(active), tf._ptr(root0), tf._ptr(seed), *alpha, R,
            scratch.data_ptr(), scratch.numel(), slots, t.data_ptr(), tri.data_ptr(),
            u.data_ptr(), v.data_ptr(), steps.data_ptr(), seed_out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"wide traverse kernel launch failed: cudaError {err}")
    tf.LAUNCHES["traverse_wide"] += 1
    return t, tri.long(), u, v, steps, seed_out


def traverse_wide(wide, pack, origin, direction, t_max, seed=None, active=None, any_hit=False,
                  root0=None):
    """One traversal of an 8-wide tree: closest hit with backface culling
    (``any_hit`` False) or the first accepted hit without (True), within
    ``t_max``, from the root or, with ``root0`` (an (R,) int32 tensor of
    interior rows), from each ray's own root; with an AlphaPack ``pack``,
    the stochastic alpha test of alpha-flagged candidates inline (``seed``,
    (R,) uint32 values in int64, default zeros). CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise). Returns (t, tri, u,
    v, steps, seed')."""
    if origin.device.type == "cuda":
        return _traverse_wide_cuda(wide, pack, origin, direction, t_max, seed, active, any_hit,
                                   root0)
    if origin.device.type != "cpu":
        raise ValueError(f"no wide traversal for device {origin.device}")
    return _traverse_wide_plain(wide, pack, origin, direction, t_max, seed, active, any_hit,
                                root0=root0)
