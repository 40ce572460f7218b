"""The reference's own ray queries: trees built here, walked in plain torch.

The port answers its ray queries from planar trees that its native builder
makes (binned SAH, 16-wide rows). The reference works the trees out again in
its own way: every triangle set (the whole scene's opaque or alpha subset,
or one mesh's subset in a two-level scene) gets an implicit 4-wide tree over
its triangles sorted by the Morton code of their centroids, four triangles
a leaf, with exact vertex bounds (its few triangles far larger than the
rest in a tree of their own beside it). A query walks it with a stack per
ray, every live ray one node a step. The alpha rounds' candidate searches,
on sets of at most ``BRUTE_MAX`` triangles, test every triangle instead.

The answers do not depend on the tree: each query's semantics are the
port's, written out from its plain versions (``ops/traverse_fused.py::
_traverse_plain``, ``ops/traverse_alpha.py``, ``ops/tlas.py``):

* closest: the nearest triangle with ``0 < t < t_max``, back faces culled
  except on double-sided triangles (Moller-Trumbore in the port's operation
  order, on the triangle's vertices as float32);
* any: whether some triangle lies within ``(0, t_max)``, no culling;
* candidate: the nearest alpha-tested triangle within the window and its
  texture uv, for the stochastic alpha rounds;
* the alpha rounds: candidates tested in t order from the ray's origin,
  one random draw each from the ray's stream, the window moved just past a
  rejected surface, at most 24 rounds (single level); in a two-level scene,
  instances entered in (entry t, id) order over the alpha subsets' world
  boxes, candidates in t order inside each, at most 64 rounds in all.

Only exact ties between two triangles' t can part from the port (the tree
decides which is met first); the check's limit leaves room for them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import rng
from .vecmath import mat3_vec

INF = 1e32
ARITY = 4         # children of an interior node
LEAF = 4          # triangles of a leaf
ALPHA_MASK = 1    # glTF alpha mode MASK
MAX_ROUNDS = 24   # single-level alpha rounds a ray
A_MAX_ROUNDS = 64  # two-level alpha rounds a ray
ADV_REL, ADV_ABS = 1e-4, 1e-5  # the window's advance past a rejected surface
_NEG = -3.0e38
BIG = 16.0              # a triangle this many times its set's median extent is big
BRUTE_MAX = 4096        # a candidate set this small is tested triangle by triangle
BRUTE_PAIRS = 1 << 22   # ray-triangle pairs a chunk


def inv_dir(d: torch.Tensor) -> torch.Tensor:
    """Guarded reciprocal direction: |d| < 1e-20 -> +-1e-20."""
    tiny = torch.where(d < 0, -1e-20, 1e-20).to(d.dtype)
    return 1.0 / torch.where(torch.abs(d) < 1e-20, tiny, d)


def _morton(c: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points normalised to [0, 1)^3."""
    q = np.clip((c * 1024.0).astype(np.int64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


@dataclasses.dataclass
class Forest:
    """Trees over triangle sets, concatenated: per node its box and either
    its children (``kids[child:child + count]``) or, a leaf (``child`` -1),
    its run of ``count`` triangle slots from ``start``; per slot the
    triangle's id in the geometry, vertices, uvs and flags; at each set's
    root, the set's run of slots."""

    lo: torch.Tensor          # (N, 3) f32
    hi: torch.Tensor          # (N, 3) f32
    child: torch.Tensor       # (N,) int64: first entry in kids, -1 for a leaf
    count: torch.Tensor       # (N,) int64: children, or the leaf's triangles
    start: torch.Tensor       # (N,) int64: a leaf's first slot
    kids: torch.Tensor        # (K,) int64 node ids
    tri: torch.Tensor         # (S,) int64 triangle ids
    verts: torch.Tensor       # (S, 9) f32 p0 p1 p2
    uvs: torch.Tensor         # (S, 6) f32 uv0 uv1 uv2
    flags: torch.Tensor       # (S,) int64: bit 0 double-sided, bit 1 alpha
    depth: int                # levels of the deepest tree
    span_start: torch.Tensor  # (N,) int64: at a root, its set's first slot
    span_count: torch.Tensor  # (N,) int64: at a root, its set's triangles


class _Builder:
    """Accumulates the nodes of implicit trees (Morton order, ``LEAF``
    triangles a leaf, ``ARITY`` children a node, laid out root first) and of
    the nodes that join several trees under one root."""

    def __init__(self):
        self.lo, self.hi, self.child, self.count, self.start = [], [], [], [], []
        self.joins = []   # (node, [kid nodes])
        self.n = 0
        self.depth = 1

    def tree(self, tmin, tmax, slot0: int) -> int:
        """One tree over triangle boxes (in slot order from ``slot0``): its root."""
        t = len(tmin)
        first = np.arange(0, t, LEAF)
        levels = [dict(lo=np.minimum.reduceat(tmin, first), hi=np.maximum.reduceat(tmax, first),
                       start=first + slot0, count=np.minimum(LEAF, t - first), child=None)]
        while len(levels[-1]["lo"]) > 1:
            below = levels[-1]
            k = np.arange(0, len(below["lo"]), ARITY)
            levels.append(dict(lo=np.minimum.reduceat(below["lo"], k),
                               hi=np.maximum.reduceat(below["hi"], k), child=k,
                               count=np.minimum(ARITY, len(below["lo"]) - k), start=None))
        self.depth = max(self.depth, len(levels))
        offs = {}
        for i in range(len(levels) - 1, -1, -1):  # the root's level first
            lvl = levels[i]
            n = len(lvl["lo"])
            offs[i] = self.n
            self.lo.append(lvl["lo"])
            self.hi.append(lvl["hi"])
            self.count.append(lvl["count"])
            if lvl["child"] is None:
                self.child.append(np.full(n, -1, np.int64))
                self.start.append(lvl["start"])
            else:
                self.child.append(lvl["child"])  # made node ids below, once offs[i - 1] is known
                self.start.append(np.zeros(n, np.int64))
            self.n += n
        for i in range(1, len(levels)):
            pos = len(levels) - 1 - i  # where level i sits in the lists just appended
            self.child[-len(levels) + pos] = self.child[-len(levels) + pos] + offs[i - 1]
        return offs[len(levels) - 1]

    def join(self, roots, boxes) -> int:
        """A node over several roots: its id."""
        node = self.n
        self.lo.append(np.min([b[0] for b in boxes], axis=0)[None])
        self.hi.append(np.max([b[1] for b in boxes], axis=0)[None])
        self.count.append(np.asarray([len(roots)], np.int64))
        self.child.append(np.asarray([-1], np.int64))  # set when the kids are laid out
        self.start.append(np.zeros(1, np.int64))
        self.joins.append((node, list(roots)))
        self.n += 1
        self.depth += 1
        return node


def build_forest(positions: np.ndarray, indices: np.ndarray, uv: np.ndarray, flags: np.ndarray,
                 sets: list, device) -> tuple:
    """One tree per triangle set of ``sets`` (arrays of triangle ids; an
    empty set gets root -1): ``(Forest, roots (len(sets),) int64)``. A set's
    triangles more than ``BIG`` times its median extent get a tree of their
    own beside the others', joined under the set's root, so that their
    boxes do not swell every node above them."""
    pos = np.asarray(positions, np.float32)
    idx = np.asarray(indices, np.int64)
    b = _Builder()
    roots, spans, tri_all, n_slots = [], [], [], 0
    for ids in sets:
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            roots.append(-1)
            continue
        tv = pos[idx[ids]]                          # (T, 3, 3)
        tmin, tmax = tv.min(axis=1), tv.max(axis=1)
        ext = (tmax - tmin).max(axis=1)
        big = ext > BIG * np.median(ext)
        set_roots, boxes, ordered = [], [], []
        for part in (~big, big):
            if not part.any():
                continue
            pid, pmin, pmax = ids[part], tmin[part], tmax[part]
            cen = (pmin.astype(np.float64) + pmax) * 0.5
            c0, c1 = cen.min(axis=0), cen.max(axis=0)
            order = np.argsort(_morton((cen - c0) / np.maximum(c1 - c0, 1e-30)), kind="stable")
            set_roots.append(b.tree(pmin[order], pmax[order], n_slots + sum(map(len, ordered))))
            boxes.append((pmin.min(axis=0), pmax.max(axis=0)))
            ordered.append(pid[order])
        root = set_roots[0] if len(set_roots) == 1 else b.join(set_roots, boxes)
        ids = np.concatenate(ordered)
        roots.append(root)
        spans.append((root, n_slots, len(ids)))
        tri_all.append(ids)
        n_slots += len(ids)
    kids = [np.arange(b.n, dtype=np.int64)]
    child = np.concatenate(b.child) if b.child else np.zeros(0, np.int64)
    nk = b.n
    for node, ks in b.joins:
        child[node] = nk
        kids.append(np.asarray(ks, np.int64))
        nk += len(ks)
    span_start, span_count = np.zeros(b.n, np.int64), np.zeros(b.n, np.int64)
    for node, first_slot, n in spans:
        span_start[node], span_count[node] = first_slot, n
    tri = np.concatenate(tri_all) if tri_all else np.zeros(0, np.int64)
    f = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)  # noqa: E731
    cat = lambda lst, shape: np.concatenate(lst) if lst else np.zeros(shape)  # noqa: E731
    forest = Forest(
        lo=f(cat(b.lo, (0, 3)), torch.float32), hi=f(cat(b.hi, (0, 3)), torch.float32),
        child=f(child, torch.int64), count=f(cat(b.count, (0,)), torch.int64),
        start=f(cat(b.start, (0,)), torch.int64), kids=f(np.concatenate(kids), torch.int64),
        tri=f(tri, torch.int64), verts=f(pos[idx[tri]].reshape(-1, 9), torch.float32),
        uvs=f(np.asarray(uv, np.float32)[idx[tri]].reshape(-1, 6), torch.float32),
        flags=f(np.asarray(flags)[tri], torch.int64), depth=b.depth,
        span_start=f(span_start, torch.int64), span_count=f(span_count, torch.int64),
    )
    return forest, torch.as_tensor(np.asarray(roots, np.int64), device=device)


def _slab(lo_b, hi_b, o, inv_d):
    lo = (lo_b - o) * inv_d
    hi = (hi_b - o) * inv_d
    return torch.amax(torch.minimum(lo, hi), dim=-1), torch.amin(torch.maximum(lo, hi), dim=-1)


def _triangles(forest: Forest, slot, ok, o, d, t_max, cull: bool):
    """Moller-Trumbore of rays (R, 3) against the triangles in ``slot`` (R,
    K) where ``ok``, in the port's operation order: ``(u, v, t, flags,
    hit)``, ``hit`` within ``(0, t_max)``, culled per ``cull``."""
    vt = forest.verts[slot]
    a = lambda k: vt[..., k]  # noqa: E731
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    p0x, p0y, p0z = a(0), a(1), a(2)
    e1x, e1y, e1z = a(3) - p0x, a(4) - p0y, a(5) - p0z
    e2x, e2y, e2z = a(6) - p0x, a(7) - p0y, a(8) - p0z
    flg = forest.flags[slot]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    det_ok = torch.abs(det) > 1e-12
    facing = ((flg & 1) != 0) | (det > 1e-12) if cull else det_ok
    inv_det = 1.0 / torch.where(det_ok, det, 1.0)
    tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
    uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    hit = (ok & det_ok & facing & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0) & (tt > 0.0)
           & (tt < t_max[:, None]))
    return uu, vv, tt, flg, hit


def _uv_at(forest: Forest, slot, uu, vv):
    """The texture uv at barycentrics (u, v) of the triangles in ``slot``."""
    wbar = 1.0 - uu - vv
    uvt = forest.uvs[slot]
    return (uvt[..., 0] * wbar + uvt[..., 2] * uu + uvt[..., 4] * vv,
            uvt[..., 1] * wbar + uvt[..., 3] * uu + uvt[..., 5] * vv)


def candidates(forest: Forest, origin, direction, window, root, cull: bool):
    """The nearest alpha-tested candidate within ``(0, window)`` of the set
    at each ray's ``root`` (-1: none): ``(t, tri, u, v, uvu, uvv)`` as
    :func:`traverse` gives them. Sets of at most ``BRUTE_MAX`` triangles
    (the alpha subsets of both configurations) test every triangle, in
    chunks of ``BRUTE_PAIRS`` ray-triangle pairs: the alpha rounds call this
    once a round, and a tree walk a round would cost a host sync a node."""
    dev = origin.device
    r = origin.shape[0]
    live = root >= 0
    count = torch.where(live, forest.span_count[torch.clamp(root, min=0)], 0)
    widest = int(count.max()) if r else 0
    if widest > BRUTE_MAX:
        return traverse(forest, origin, direction, window, root, "candidate", cull)
    t = torch.full((r,), INF, device=dev)
    tri = torch.full((r,), -1, dtype=torch.int64, device=dev)
    u, v, uvu, uvv = (torch.zeros(r, device=dev) for _ in range(4))
    if widest == 0:
        return t, tri, u, v, uvu, uvv
    first = forest.span_start[torch.clamp(root, min=0)]
    lane = torch.arange(widest, device=dev)
    step = max(1, BRUTE_PAIRS // widest)
    for s in range(0, r, step):
        e = min(r, s + step)
        ok = lane[None] < count[s:e, None]
        slot = torch.where(ok, first[s:e, None] + lane[None], 0)
        uu, vv, tt, flg, hit = _triangles(forest, slot, ok, origin[s:e], direction[s:e],
                                          window[s:e], cull)
        tk = torch.where(hit & ((flg & 2) != 0), tt, INF)
        bt, j = torch.amin(tk, dim=1), torch.argmin(tk, dim=1)
        found = bt < INF
        take = lambda x: torch.gather(x, 1, j[:, None])[:, 0]  # noqa: E731
        tu, tv = _uv_at(forest, slot, uu, vv)
        t[s:e] = torch.where(found, bt, INF)
        tri[s:e] = torch.where(found, forest.tri[take(slot)], -1)
        u[s:e], v[s:e] = torch.where(found, take(uu), 0.0), torch.where(found, take(vv), 0.0)
        uvu[s:e], uvv[s:e] = torch.where(found, take(tu), 0.0), torch.where(found, take(tv), 0.0)
    return t, tri, u, v, uvu, uvv


def traverse(forest: Forest, origin, direction, t_max, root, mode: str, cull: bool):
    """One query per ray from node ``root`` (-1: none): ``mode`` "closest",
    "any" or "candidate" (the nearest alpha-tested triangle). Returns ``(t
    (INF on a miss), tri (-1), u, v, uvu, uvv)``; ``uvu``/``uvv`` the
    candidate's texture uv (zeros in the other modes)."""
    dev = origin.device
    r = origin.shape[0]
    inv_d = inv_dir(direction)
    cand = mode == "candidate"
    best = t_max.clone()
    tri = torch.full((r,), -1, dtype=torch.int64, device=dev)
    u, v, uvu, uvv = (torch.zeros(r, device=dev) for _ in range(4))
    depth = (ARITY - 1) * forest.depth + 2
    stack = torch.zeros((r, depth), dtype=torch.int64, device=dev)
    sp = torch.zeros(r, dtype=torch.int64, device=dev)
    cur = root.clone()
    lane_k = torch.arange(ARITY, device=dev)
    lane_l = torch.arange(LEAF, device=dev)
    while True:
        live = torch.nonzero(cur >= 0).squeeze(1)
        if live.numel() == 0:
            break
        c = cur[live]
        o, iv = origin[live], inv_d[live]
        tb = best[live]
        nxt = torch.full_like(c, -1)
        is_in = forest.child[c] >= 0
        pop = ~is_in

        wi = torch.nonzero(is_in).squeeze(1)
        if wi.numel():
            cw = c[wi]
            ok = lane_k[None] < forest.count[cw][:, None]
            kids = forest.kids[torch.where(ok, forest.child[cw][:, None] + lane_k[None], 0)]
            tn, tf = _slab(forest.lo[kids], forest.hi[kids], o[wi][:, None, :], iv[wi][:, None, :])
            hit = ok & (tn <= tf) & (tf >= 0.0) & (tn < tb[wi][:, None])
            key, order = torch.sort(torch.where(hit, tn, INF), dim=1, stable=True)
            skid = torch.gather(kids, 1, order)
            n_hit = (key < INF).sum(dim=1)
            lanes = live[wi]
            base = sp[lanes]
            for k in range(1, ARITY):  # push hit children 1..n-1, far ones deeper
                sel = n_hit - 1 >= k
                pos = base + (n_hit - 1 - k)
                stack[lanes[sel], pos[sel]] = skid[sel, k]
            sp[lanes] = base + torch.clamp(n_hit - 1, min=0)
            nxt[wi] = torch.where(n_hit > 0, skid[:, 0], -1)
            pop[wi] = n_hit == 0

        li = torch.nonzero(~is_in).squeeze(1)
        if li.numel():
            cl = c[li]
            slot = forest.start[cl][:, None] + lane_l[None]
            ok = lane_l[None] < forest.count[cl][:, None]
            slot = torch.where(ok, slot, 0)
            uu, vv, tt, flg, geo = _triangles(forest, slot, ok, o[li], direction[live[li]],
                                              tb[li], cull)
            if cand:
                geo = geo & ((flg & 2) != 0)
            tk = torch.where(geo, tt, INF)
            bt, j = torch.amin(tk, dim=1), torch.argmin(tk, dim=1)
            upd = bt < tb[li]
            ids = live[li]
            take = lambda x: torch.gather(x, 1, j[:, None])[:, 0]  # noqa: E731
            best[ids] = torch.where(upd, bt, best[ids])
            tri[ids] = torch.where(upd, forest.tri[take(slot)], tri[ids])
            u[ids] = torch.where(upd, take(uu), u[ids])
            v[ids] = torch.where(upd, take(vv), v[ids])
            if cand:
                tu, tv = _uv_at(forest, slot, uu, vv)
                uvu[ids] = torch.where(upd, take(tu), uvu[ids])
                uvv[ids] = torch.where(upd, take(tv), uvv[ids])
            if mode == "any":
                pop[li] = ~upd
                nxt[li] = torch.where(upd, -2, -1)  # -2: found, the ray ends

        # next node: pop where the node is done
        can = pop & (sp[live] > 0)
        top = stack[live, torch.clamp(sp[live] - 1, min=0)]
        nxt = torch.where(can, top, nxt)
        sp[live] = sp[live] - can.long()
        cur[live] = torch.where(nxt == -2, -1, nxt)
    t_out = torch.where(tri >= 0, best, INF)
    return t_out, tri, u, v, uvu, uvv


# ---------------------------------------------------------------------------
# Alpha: the opacity of a candidate and its stochastic test
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AlphaPack:
    """Per-triangle alpha rows (``ops/traverse_wide.py::make_alpha_pack``'s
    16 lanes) and the atlas's alpha plane."""

    rows: torch.Tensor
    alpha_plane: torch.Tensor
    atlas_width: int


def make_alpha_pack(materials, atlas, tri_material, device) -> AlphaPack:
    """The alpha rows of every triangle, from the material and atlas tables."""
    m = materials
    t = np.asarray(m.uv_transform, np.float32)
    ax = lambda k: np.asarray(getattr(atlas, k))  # noqa: E731
    tex = np.clip(np.asarray(m.base_color_texture), 0, ax("x").shape[0] - 1)
    rows = np.stack([
        np.asarray(m.base_color_factor, np.float32)[:, 3],
        np.asarray(m.alpha_mode).astype(np.float32),
        np.asarray(m.alpha_cutoff, np.float32),
        np.asarray(m.base_color_texture).astype(np.float32),
        t[:, 0, 0], t[:, 0, 1], t[:, 1, 0], t[:, 1, 1], t[:, 2, 0], t[:, 2, 1],
        *[ax(k)[tex].astype(np.float32) for k in ("x", "y", "width", "height", "wrap_s", "wrap_t")],
    ], axis=1)
    rows = rows[np.clip(np.asarray(tri_material), 0, rows.shape[0] - 1)]
    data = np.asarray(atlas.data)
    return AlphaPack(torch.as_tensor(rows, device=device),
                     torch.as_tensor(np.ascontiguousarray(data[:, :, 3].reshape(-1)), device=device),
                     int(data.shape[1]))


def _wrap(coord, size, mode):
    """Per-texture wrap mode (REPEAT / CLAMP / MIRROR) on integer texel
    coords; ``size`` >= 1 (int tensors)."""
    rep = torch.remainder(coord, size)
    clm = torch.minimum(torch.clamp(coord, min=0), size - 1)
    period = 2 * size
    m = torch.remainder(coord, period)
    mir = torch.where(m >= size, period - 1 - m, m)
    return torch.where(mode == 0, rep, torch.where(mode == 1, clm, mir))


def alpha_opacity(pack: AlphaPack, tri, uvu, uvv):
    """Opacity of each candidate: its alpha factor times the nearest atlas
    texel's alpha, or the mask cutoff's 0 / 1."""
    arow = pack.rows[torch.clamp(tri, 0, pack.rows.shape[0] - 1)]
    ut = uvu * arow[:, 4] + uvv * arow[:, 6] + arow[:, 8]
    vt = uvu * arow[:, 5] + uvv * arow[:, 7] + arow[:, 9]
    tw = torch.clamp(arow[:, 12].long(), min=1)
    th = torch.clamp(arow[:, 13].long(), min=1)
    xi = torch.floor(ut * tw.float()).long()
    yi = torch.floor(vt * th.float()).long()
    xw = _wrap(xi, tw, arow[:, 14].long()) + arow[:, 10].long()
    yw = _wrap(yi, th, arow[:, 15].long()) + arow[:, 11].long()
    flat = torch.clamp(yw * pack.atlas_width + xw, 0, pack.alpha_plane.shape[0] - 1)
    texel_a = pack.alpha_plane[flat].float() * (1.0 / 255.0)
    a = arow[:, 0] * torch.where(arow[:, 3] >= 0.0, texel_a, 1.0)
    return torch.where(arow[:, 1] == float(ALPHA_MASK), (a > arow[:, 2]).float(), a)


def alpha_accept(pack: AlphaPack, tri, uvu, uvv, seed, cand):
    """One stochastic test per candidate ray, a draw only where there is a
    candidate: ``(passed, seed')``."""
    opacity = alpha_opacity(pack, tri, uvu, uvv)
    seed2, rnd = rng.rand(seed)
    return rnd <= opacity, torch.where(cand, seed2, seed)


# ---------------------------------------------------------------------------
# Single level: the opaque tree, then the alpha rounds
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Hits:
    t: torch.Tensor
    tri: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    inst: Optional[torch.Tensor] = None


class SingleLevel:
    """A world-space scene: one tree over its opaque triangles and one over
    its alpha-tested ones (the whole scene in the first where none is)."""

    def __init__(self, geom, pack: Optional[AlphaPack], device):
        flags = np.asarray(geom.tri_flags)
        alpha = (flags & 2) != 0
        sets = [np.nonzero(~alpha)[0], np.nonzero(alpha)[0]] if alpha.any() else [
            np.arange(len(flags))]
        self.forest, roots = build_forest(geom.positions, geom.indices, geom.uv, flags, sets, device)
        self.root_opq = int(roots[0])
        self.root_alp = int(roots[1]) if len(roots) > 1 else -1
        self.pack = pack

    def _roots(self, n, root, active, dev):
        r = torch.full((n,), root, dtype=torch.int64, device=dev)
        return r if active is None else torch.where(active, r, -1)

    def _rounds(self, origin, direction, t_limit, seed, active, cull):
        """The alpha rounds (``traverse_alpha._rounds_core``'s semantics)."""
        r, dev = origin.shape[0], origin.device
        bt = torch.full((r,), INF, device=dev)
        btri = torch.full((r,), -1, dtype=torch.int64, device=dev)
        bu, bv = torch.zeros(r, device=dev), torch.zeros(r, device=dev)
        t_lo = torch.zeros(r, device=dev)
        seed = seed.clone()
        need = (t_limit > 0.0) if active is None else active & (t_limit > 0.0)
        idx = torch.nonzero(need).squeeze(1)
        for _ in range(MAX_ROUNDS):
            if idx.numel() == 0 or self.root_alp < 0:
                break
            tl = t_lo[idx]
            d = direction[idx]
            o2 = origin[idx] + d * tl[:, None]
            win = torch.clamp(t_limit[idx] - tl, min=0.0)
            root = torch.full((idx.numel(),), self.root_alp, dtype=torch.int64, device=dev)
            t, tri, u, v, uvu, uvv = candidates(self.forest, o2, d, win, root, cull)
            cand = tri >= 0
            if self.pack is not None:
                passed, seed[idx] = alpha_accept(self.pack, tri, uvu, uvv, seed[idx], cand)
            else:
                passed = torch.ones_like(cand)
            accept = cand & passed
            t_abs = tl + t
            bt[idx] = torch.where(accept, t_abs, bt[idx])
            btri[idx] = torch.where(accept, tri, btri[idx])
            bu[idx] = torch.where(accept, u, bu[idx])
            bv[idx] = torch.where(accept, v, bv[idx])
            again = cand & ~passed
            t_lo[idx] = torch.where(again, t_abs * (1.0 + ADV_REL) + ADV_ABS, tl)
            idx = idx[again]
        return Hits(bt, btri, bu, bv), seed

    def closest(self, origin, direction, seed, active):
        n, dev = origin.shape[0], origin.device
        t_max = torch.full((n,), INF, device=dev)
        t, tri, u, v, _, _ = traverse(self.forest, origin, direction, t_max,
                                      self._roots(n, self.root_opq, active, dev), "closest", True)
        if self.root_alp < 0:
            return Hits(t, tri, u, v), seed
        ha, seed = self._rounds(origin, direction, t, seed, active, cull=True)
        take = ha.tri >= 0
        return Hits(torch.where(take, ha.t, t), torch.where(take, ha.tri, tri),
                    torch.where(take, ha.u, u), torch.where(take, ha.v, v)), seed

    def occluded(self, origin, direction, t_max, seed, active):
        n, dev = origin.shape[0], origin.device
        _, tri, _, _, _, _ = traverse(self.forest, origin, direction, t_max,
                                      self._roots(n, self.root_opq, active, dev), "any", False)
        occ = tri >= 0
        if self.root_alp < 0:
            return occ, seed
        still = active & ~occ
        ha, seed = self._rounds(origin, direction, t_max, seed, still, cull=False)
        return occ | (ha.tri >= 0), seed


# ---------------------------------------------------------------------------
# Two levels: instances over per-mesh trees in object space
# ---------------------------------------------------------------------------


def _subset_obj_aabb(pos, idx, pool, sel):
    """Object-space box of each mesh's selected triangles; meshes whose
    subset is empty or complete keep the full-mesh box."""
    mn = np.array(pool.aabb_min, np.float32, copy=True)
    mx = np.array(pool.aabb_max, np.float32, copy=True)
    for m in range(len(pool.tri_start)):
        lo, cnt = int(pool.tri_start[m]), int(pool.tri_count[m])
        s = sel[lo:lo + cnt]
        if not s.any() or s.all():
            continue
        v = pos[np.asarray(idx[lo:lo + cnt][s]).ravel()]
        mn[m] = v.min(axis=0)
        mx[m] = v.max(axis=0)
    return mn, mx


def _inst_world_aabb(inst, omin, omax):
    """World box of each instance for per-mesh object-space boxes: the 8
    transformed corners."""
    o2w = np.asarray(inst.object_to_world, np.float32)
    mid = np.asarray(inst.mesh_id)
    mn, mx = omin[mid], omax[mid]
    bmin = np.full_like(mn, np.inf)
    bmax = np.full_like(mn, -np.inf)
    for k in range(8):
        pick = np.asarray([(k >> a) & 1 for a in range(3)], bool)
        c = np.where(pick, mx, mn)
        w = np.einsum("iab,ib->ia", o2w[:, :, :3], c) + o2w[:, :, 3]
        bmin = np.minimum(bmin, w)
        bmax = np.maximum(bmax, w)
    return bmin.astype(np.float32), bmax.astype(np.float32)


def _entries(bmin, bmax, mask, origin, direction, t_max):
    """Entry distance of each ray into each instance box: (R, I), INF where
    missed, not before ``t_max`` or outside ``mask``."""
    inv_d = inv_dir(direction)
    out = []
    for s in range(0, max(origin.shape[0], 1), 1 << 14):
        o = origin[s:s + (1 << 14), None, :]
        i = inv_d[s:s + (1 << 14), None, :]
        tn, tf = _slab(bmin[None], bmax[None], o, i)
        hit = (tn <= tf) & (tf >= 0.0) & (tn < t_max[s:s + (1 << 14), None]) & mask[None]
        out.append(torch.where(hit, tn, INF))
    return torch.cat(out)


def _next(entry, last_t, last_id):
    """The smallest (entry t, id) strictly after (last_t, last_id)."""
    ids = torch.arange(entry.shape[1], device=entry.device)[None]
    after = (entry > last_t[:, None]) | ((entry == last_t[:, None]) & (ids > last_id[:, None]))
    key = torch.where(after & (entry < INF), entry, INF)
    nt, ni = torch.amin(key, dim=1), torch.argmin(key, dim=1)  # the first minimum
    return nt, torch.where(nt < INF, ni, -1)


class TwoLevel:
    """A mesh pool under an instance table: per mesh one tree over its
    opaque and one over its alpha-tested triangles (where the pool mixes
    the two) in object space; the subsets' world boxes per instance."""

    def __init__(self, pool, inst, pack: Optional[AlphaPack], device):
        g = pool.geometry
        pos, idx = np.asarray(g.positions), np.asarray(g.indices)
        flags = np.asarray(g.tri_flags)
        alpha = (flags & 2) != 0
        if not (alpha.any() and (~alpha).any()):
            raise ValueError("the reference's two-level scenes mix opaque and alpha triangles")
        ranges = [np.arange(int(s), int(s) + int(c)) for s, c in zip(pool.tri_start, pool.tri_count)]
        sets = [r[~alpha[r]] for r in ranges] + [r[alpha[r]] for r in ranges]
        self.forest, roots = build_forest(pos, idx, g.uv, flags, sets, device)
        m = len(ranges)
        mid = torch.as_tensor(np.asarray(inst.mesh_id, np.int64), device=device)
        self.root_opq, self.root_alp = roots[:m][mid], roots[m:][mid]
        dev = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
        self.box_opq = [dev(b) for b in _inst_world_aabb(inst, *_subset_obj_aabb(pos, idx, pool, ~alpha))]
        self.box_alp = [dev(b) for b in _inst_world_aabb(inst, *_subset_obj_aabb(pos, idx, pool, alpha))]
        self.w2o = dev(inst.world_to_object)
        self.o2w = dev(inst.object_to_world)
        self.pack = pack

    def _to_object(self, iid, origin, direction):
        w2o = self.w2o[torch.clamp(iid, min=0)]
        return mat3_vec(w2o, origin) + w2o[:, :, 3], mat3_vec(w2o, direction)

    def _opaque(self, origin, direction, t_max, active, any_hit):
        """The nearest opaque hit over every instance (or any hit): each
        (ray, instance) pair whose box the ray enters traverses that
        instance's opaque tree; per ray the least t wins, an equal t by the
        earlier (entry t, id), the order in which the port meets them."""
        r, dev = origin.shape[0], origin.device
        mask = self.root_opq >= 0
        entry = _entries(*self.box_opq, mask, origin, direction, t_max)
        entry = torch.where(active[:, None], entry, INF)
        ray, iid = torch.nonzero(entry < INF, as_tuple=True)
        o_obj, d_obj = self._to_object(iid, origin[ray], direction[ray])
        t, tri, u, v, _, _ = traverse(self.forest, o_obj, d_obj, t_max[ray], self.root_opq[iid],
                                      "any" if any_hit else "closest", not any_hit)
        hit = tri >= 0
        ray, iid, t, tri, u, v = ray[hit], iid[hit], t[hit], tri[hit], u[hit], v[hit]
        et = entry[ray, iid]
        # order the pairs by (ray, t, entry t, id) and keep each ray's first
        order = torch.argsort(iid, stable=True)
        for key in (et, t):
            order = order[torch.argsort(key[order], stable=True)]
        order = order[torch.argsort(ray[order], stable=True)]
        ray, iid, t, tri, u, v = (x[order] for x in (ray, iid, t, tri, u, v))
        first = torch.ones_like(ray, dtype=torch.bool)
        first[1:] = ray[1:] != ray[:-1]
        ray, iid, t, tri, u, v = (x[first] for x in (ray, iid, t, tri, u, v))
        out_t = torch.full((r,), INF, device=dev)
        out_tri = torch.full((r,), -1, dtype=torch.int64, device=dev)
        out_u, out_v = torch.zeros(r, device=dev), torch.zeros(r, device=dev)
        out_i = torch.zeros(r, dtype=torch.int64, device=dev)
        out_t[ray], out_tri[ray], out_u[ray], out_v[ray], out_i[ray] = t, tri, u, v, iid
        return Hits(out_t, out_tri, out_u, out_v, out_i)

    def _alpha(self, origin, direction, t_max, seed, act, any_hit):
        """The alpha machine's rounds (``tlas._alpha_rounds``' semantics)."""
        r, dev = origin.shape[0], origin.device
        entry0 = _entries(*self.box_alp, self.root_alp >= 0, origin, direction, t_max)
        t_best = t_max.clone()
        tri = torch.full((r,), -1, dtype=torch.int64, device=dev)
        u, v = torch.zeros(r, device=dev), torch.zeros(r, device=dev)
        ibest = torch.zeros(r, dtype=torch.int64, device=dev)
        seed = seed.clone()
        last_t = torch.full((r,), _NEG, device=dev)
        last_id = torch.full((r,), -1, dtype=torch.int64, device=dev)
        t_lo = torch.zeros(r, device=dev)

        def next_cand(lanes, tb, lt, li):
            e = entry0[lanes]
            return _next(torch.where(e < tb[:, None], e, INF), lt, li)

        nt, nid = next_cand(slice(None), t_max, last_t, last_id)
        live = torch.nonzero(act & (nid >= 0)).squeeze(1)
        n_rounds = 0
        while live.numel() and n_rounds < A_MAX_ROUNDS:
            cid = nid[live]
            tl = t_lo[live]
            d = direction[live]
            o_obj, d_obj = self._to_object(cid, origin[live] + d * tl[:, None], d)
            tb = t_best[live]
            t, h_tri, hu, hv, uvu, uvv = candidates(
                self.forest, o_obj, d_obj, torch.clamp(tb - tl, min=0.0), self.root_alp[cid],
                not any_hit)
            cand = h_tri >= 0
            passed, seed[live] = alpha_accept(self.pack, h_tri, uvu, uvv, seed[live], cand)
            t_abs = tl + t
            accept = cand & passed
            tb = torch.where(accept, t_abs, tb)
            t_best[live] = tb
            tri[live] = torch.where(accept, h_tri, tri[live])
            u[live] = torch.where(accept, hu, u[live])
            v[live] = torch.where(accept, hv, v[live])
            ibest[live] = torch.where(accept, cid, ibest[live])
            reject = cand & ~passed
            lt = torch.where(reject, last_t[live], nt[live])
            li = torch.where(reject, last_id[live], cid)
            last_t[live] = lt
            last_id[live] = li
            t_lo[live] = torch.where(reject, t_abs * (1.0 + ADV_REL) + ADV_ABS, 0.0)
            nt2, nid2 = next_cand(live, tb, lt, li)
            cid = torch.where(reject, cid, nid2)
            nt[live] = torch.where(reject, nt[live], nt2)
            nid[live] = cid
            n_rounds += 1
            keep = cid >= 0
            if any_hit:
                keep = keep & (tri[live] < 0)
            live = live[keep]
        return Hits(torch.where(tri >= 0, t_best, INF), tri, u, v, ibest), seed

    def closest(self, origin, direction, seed, active):
        n, dev = origin.shape[0], origin.device
        t_max = torch.full((n,), INF, device=dev)
        ho = self._opaque(origin, direction, t_max, active, any_hit=False)
        t_o = torch.where(ho.tri >= 0, ho.t, t_max)
        ha, seed = self._alpha(origin, direction, t_o, seed, active, any_hit=False)
        take = (ha.tri >= 0) & (ha.t < t_o)
        pick = lambda a, b: torch.where(take, a, b)  # noqa: E731
        return Hits(pick(ha.t, ho.t), pick(ha.tri, ho.tri), pick(ha.u, ho.u), pick(ha.v, ho.v),
                    pick(ha.inst, ho.inst)), seed

    def occluded(self, origin, direction, t_max, seed, active):
        ho = self._opaque(origin, direction, t_max, active, any_hit=True)
        occ = ho.tri >= 0
        ha, seed = self._alpha(origin, direction, t_max, seed, active & ~occ, any_hit=True)
        return occ | (ha.tri >= 0), seed
