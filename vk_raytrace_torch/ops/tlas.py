"""Two-level acceleration: an instance table over shared per-mesh BVHs
(counterpart of ``vk_raytrace_tpu/ops/tlas.py``, planar tables only).

Each mesh keeps one object-space planar BVH (16 or 32 wide); the meshes'
tables are concatenated into one row table with absolute refs, and every
instance is a 3x4 transform and a mesh id. The top level runs as candidate
rounds: each ray picks its nearest not yet processed instance whose world
box it enters before its current best hit (in the round loops an (R, I)
slab test computed once per traversal up to ``_DENSE_I_MAX`` instances, a
chunked scan recomputed per round above; the kernels recompute each box's
slab test per round), moves into that instance's object space and traverses
the mesh's BVH from its own root with ``t_max = t_best`` (kernel modes
a/b/c with per-lane roots, ``ops/traverse_fused.py``). World-space t is kept by
not renormalising the object-space direction, so hits in different
instances compare directly. Rays overlapping instance boxes at equal entry
t are ordered by instance id, so each overlap is visited once.

With alpha-tested triangles the tables split per mesh into an opaque subset
and an alpha subset: the opaque rounds run over every instance's opaque
subset, then a second machine runs candidate rounds over the alpha subsets,
one stochastic alpha test per round (:func:`_two_level_alpha_pass`). A pool
whose triangles are all alpha-tested has no subsets: the instance-level
split runs the alpha machine alone, over the full tables of the instances
that carry alpha triangles (the rest have none).

The wide back end (``backend="wide"``, the reference's non-fused route)
reads the meshes' 8-wide tables instead (``blas``, ``mesh_root``, built at
its first use by :func:`with_wide`): one pass of rounds over every instance
without an alpha pack; with one, the instance-level split: the instances
without alpha triangles first, then the alpha-carrying instances with the
alpha test inline (``ops/traverse_wide.py``), windowed by the opaque result.
On the card each pass is one launch of ``vkrt_wide_machine``
(``csrc/traverse_wide.cu``: every round of a ray in one lane, no host sync);
its plain version is the round loop :func:`_wide_rounds` (:func:`_wide_pass`).

On the card each pass is one kernel launch (``csrc/traverse.cu``:
``vkrt_opaque_machine`` for the opaque rounds, ``vkrt_alpha_machine`` for
the alpha rounds): a lane of a persistent warp runs a ray's rounds to the
end and takes the next ray, the instance table in shared memory (in global
memory above ``_DENSE_I_MAX`` instances), with no (R, I) entry table and
no host sync; their grid and scratch are ``traverse_fused.machine_state``'s.
Their plain
versions, the round loops :func:`_two_level_pass` and
:func:`_alpha_rounds`, run the CPU tensors.

In the loops every round runs on the lanes still live (gathered, then
scattered back); results are lane for lane those of the reference's
full-width rounds, since a lane's state changes only in the rounds where it
is live.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import runtime
from ..models.instances import InstanceTable, MeshPool
from ..models.schema import Tables
from . import traverse_fused as tf
from .math import mat3_vec
from .traverse_fused import INF, Hit, PlanarScene
from .traverse_wide import check_backend

_NEG = -3.0e38             # "before every entry t" for the enumeration
# Instances up to which the round loops keep an (R, I) entry table and the
# machine kernels their instance table in shared memory (76 B each); above
# it the loops scan the instance table in chunks of _SCAN_CHUNK per round
# and the kernels read it from global memory.
_DENSE_I_MAX = 512
_SCAN_CHUNK = 128
_SLAB_CHUNK = 1 << 15      # rays per chunk of the (R, I, 3) slab test
# Bound on state-machine rounds in the alpha pass: instances overlapped
# along one ray plus stochastic rejections. One global count, as in the
# reference: every alpha surface after it counts as transparent.
_A_MAX_ROUNDS = 64


@dataclasses.dataclass
class InstancedAccel(Tables):
    """Traversal-ready two-level structure.

    ``blas_planar`` holds every mesh's triangles, ``mesh_root_planar`` the
    mesh roots in it. Where the pool mixes alpha-tested and opaque
    triangles, ``blas_planar_opq``/``blas_planar_alp`` hold each mesh's
    opaque and alpha subsets (root -1 for an empty subset), with the subset
    world boxes of every instance and the masks of the instances whose mesh
    has such triangles; otherwise they are None."""

    blas_planar: PlanarScene
    mesh_root_planar: object          # (M,) int
    inst: InstanceTable
    inst_alpha: object                # (I,) bool: mesh has >= 1 alpha triangle
    blas_planar_opq: Optional[PlanarScene] = None
    mesh_root_opq: object = None
    blas_planar_alp: Optional[PlanarScene] = None
    mesh_root_alp: object = None
    inst_opaque: object = None        # (I,) bool: mesh has >= 1 opaque triangle
    inst_aabb_opq_min: object = None  # (I, 3) world boxes of the subsets
    inst_aabb_opq_max: object = None
    inst_aabb_alp_min: object = None
    inst_aabb_alp_max: object = None
    # The wide back end's tables: every mesh's 8-wide BVH concatenated
    # (``bvh8.WideScene``) and the mesh roots in it, None until
    # :func:`with_wide` builds them from the pool's triangle ranges.
    blas: object = None
    mesh_root: object = None
    mesh_tri_start: object = None     # (M,) first triangle of each mesh
    mesh_tri_count: object = None     # (M,)

    def __post_init__(self):
        # The round machine kernels' instance tables by subset, built at
        # first use (``_machine_tables``), and whether any instance carries
        # alpha triangles (``_any_alpha``); a copy (``to``, ``replace``)
        # starts empty.
        self._machine = {}
        self._alpha = None

    def _any_alpha(self) -> bool:
        if self._alpha is None:
            self._alpha = bool(torch.as_tensor(self.inst_alpha).any())
        return self._alpha

    def check_root_masks(self) -> None:
        """The passes clamp a subset root of -1 (mesh without triangles in
        that subset) to 0, which is safe only because such instances are
        masked out: every instance the opaque (alpha) mask keeps has a mesh
        with an opaque (alpha) root."""
        if self.blas_planar_opq is None:
            return
        mid = np.asarray(self.inst.mesh_id)
        for roots, mask in ((self.mesh_root_opq, self.inst_opaque),
                            (self.mesh_root_alp, self.inst_alpha)):
            kept = np.asarray(roots)[mid][np.asarray(mask, bool)]
            assert (kept >= 0).all(), "an instance mask keeps a mesh with an empty subset"


# ---------------------------------------------------------------------------
# Build (host numpy)
# ---------------------------------------------------------------------------


def _classify_interior_planar(rows: np.ndarray, width: int, roots=(0,)) -> np.ndarray:
    """Interior-row mask of a planar table (bounds at lanes ``[k*width + c]``,
    refs at ``[6*width + c]``): a frontier walk of the interior refs from
    ``roots``."""
    n = len(rows)
    valid = rows[:, 0:width] <= rows[:, 3 * width:4 * width]
    refs = rows[:, 6 * width:7 * width]
    interior = np.zeros(n, bool)
    frontier = np.asarray(roots, np.int64)
    while frontier.size:
        interior[frontier] = True
        r = refs[frontier]
        kids = np.unique(r[valid[frontier] & (r >= 0.5)].astype(np.int64))
        kids = kids[kids < n]
        frontier = kids[~interior[kids]]
    return interior


def _assert_interior_roots(rows: np.ndarray, roots, width: int) -> None:
    """The kernel reads a root >= 0 as an interior row, so a leaf row there
    would be misread as child boxes. Each mesh's rows, from its root to the
    next mesh's, must be exactly the interior rows its root reaches by
    interior refs plus the leaf rows those reference, the root not among
    the leaves."""
    starts = sorted(int(r) for r in roots if r >= 0)
    valid = rows[:, 0:width] <= rows[:, 3 * width:4 * width]
    refs = rows[:, 6 * width:7 * width]
    for lo, hi in zip(starts, starts[1:] + [len(rows)]):
        inner = np.nonzero(_classify_interior_planar(rows, width, roots=(lo,)))[0]
        r = refs[inner][valid[inner]]
        leaves = np.unique((-r[r < 0] - 1).astype(np.int64) // (width // 2))
        covered = np.union1d(inner, leaves)
        assert np.array_equal(covered, np.arange(lo, hi)) and lo not in leaves, (
            f"mesh root {lo} is not an interior row"
        )


def _planar_concat(pool: MeshPool, pos, idx, uvs, flg, sel, width):
    """Per-mesh ``width``-wide planar tables over the pool-global triangle
    mask ``sel`` (None = all), concatenated with their refs made absolute:
    interior refs shift by the table's base row, leaf refs
    ``-(row*(width/2) + count)`` by ``(width/2) * base``. Meshes with no
    selected triangle get root -1."""
    tables, roots = [], []
    base, depth = 0, 1
    for m in range(len(pool.tri_start)):
        lo, cnt = int(pool.tri_start[m]), int(pool.tri_count[m])
        ids = np.arange(lo, lo + cnt, dtype=np.int32)
        if sel is not None:
            ids = ids[sel[lo:lo + cnt]]
        if ids.size == 0:
            roots.append(-1)
            continue
        rows, d = runtime.build_planar_rows(pos, idx[ids], uvs, flg[ids], tri_ids=ids,
                                            width=width)
        depth = max(depth, d)
        if base:
            interior = _classify_interior_planar(rows, width)
            valid = rows[:, 0:width] <= rows[:, 3 * width:4 * width]
            refs = rows[:, 6 * width:7 * width]
            fixed = np.where(refs >= 0, refs + base, refs - (width // 2) * base)
            rows[:, 6 * width:7 * width] = np.where(interior[:, None] & valid, fixed, refs)
        roots.append(base)
        base += len(rows)
        tables.append(rows)
    runtime._check_ref_ceiling(base, width // 2)
    all_rows = np.concatenate(tables, axis=0)
    _assert_interior_roots(all_rows, roots, width)
    return (PlanarScene(rows=all_rows, stack_depth=depth, width=width),
            np.asarray(roots, np.int32))


def _subset_obj_aabb(pos, idx, pool, sel):
    """Object-space box of each mesh's selected triangles; meshes whose
    subset is empty or complete keep the full-mesh box (empty ones are
    masked out of every pass that reads these boxes)."""
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


def _inst_world_aabb(inst: InstanceTable, omin, omax):
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


def build_instanced_accel(pool: MeshPool, inst: InstanceTable, width: int = 16) -> InstancedAccel:
    """Per-mesh ``width``-wide (16 or 32) planar BVHs (object space,
    pool-global triangle ids) for every triangle and, where the pool mixes
    the two, for the opaque and the alpha subsets; concatenated with
    absolute refs."""
    geom = pool.geometry
    pos = np.asarray(geom.positions)
    idx = np.asarray(geom.indices)
    uvs = np.asarray(geom.uv)
    flg = np.asarray(geom.tri_flags)
    n_mesh = len(pool.tri_start)
    mid = np.asarray(inst.mesh_id)
    alpha_sel = (flg & 2) != 0

    def per_mesh_any(sel):
        return np.asarray([
            bool(sel[int(pool.tri_start[m]):int(pool.tri_start[m]) + int(pool.tri_count[m])].any())
            for m in range(n_mesh)
        ])

    planar, roots = _planar_concat(pool, pos, idx, uvs, flg, None, width)
    accel = InstancedAccel(
        blas_planar=planar, mesh_root_planar=roots, inst=inst,
        inst_alpha=per_mesh_any(alpha_sel)[mid],
        mesh_tri_start=np.asarray(pool.tri_start, np.int64),
        mesh_tri_count=np.asarray(pool.tri_count, np.int64),
    )
    if alpha_sel.any() and (~alpha_sel).any():
        opq, opq_roots = _planar_concat(pool, pos, idx, uvs, flg, ~alpha_sel, width)
        alp, alp_roots = _planar_concat(pool, pos, idx, uvs, flg, alpha_sel, width)
        io_min, io_max = _inst_world_aabb(inst, *_subset_obj_aabb(pos, idx, pool, ~alpha_sel))
        ia_min, ia_max = _inst_world_aabb(inst, *_subset_obj_aabb(pos, idx, pool, alpha_sel))
        accel = dataclasses.replace(
            accel,
            blas_planar_opq=opq, mesh_root_opq=opq_roots,
            blas_planar_alp=alp, mesh_root_alp=alp_roots,
            inst_opaque=per_mesh_any(~alpha_sel)[mid],
            inst_aabb_opq_min=io_min, inst_aabb_opq_max=io_max,
            inst_aabb_alp_min=ia_min, inst_aabb_alp_max=ia_max,
        )
    accel.check_root_masks()
    return accel


def _classify_interior8(rows: np.ndarray) -> np.ndarray:
    """Interior-row mask of an 8-wide table (``bvh8.WideScene`` layout): a
    frontier walk of the interior refs from row 0."""
    n = len(rows)
    valid = rows[:, 0:48:6] <= rows[:, 3:48:6]
    refs = rows[:, 48:56]
    interior = np.zeros(n, bool)
    frontier = np.asarray([0], np.int64)
    while frontier.size:
        interior[frontier] = True
        r = refs[frontier]
        kids = np.unique(r[valid[frontier] & (r >= 0.5)].astype(np.int64))
        kids = kids[kids < n]
        frontier = kids[~interior[kids]]
    return interior


def build_wide_blas(geometry, tri_start, tri_count):
    """Every mesh's 8-wide BVH (object space, pool-global triangle ids)
    concatenated with absolute refs (interior refs shift by the table's
    base row, leaf refs ``-(row*4 + count)`` by ``4 * base``): ``(WideScene,
    (M,) int32 roots)``, from the disk cache when it holds them."""
    from ..utils import cache
    from .bvh8 import WideScene, builder_digest, host_geometry, stack_bound

    g = host_geometry(geometry)
    pos, idx, uvs, flg = g.positions, g.indices, g.uv, g.tri_flags
    tri_start = np.asarray(tri_start, np.int64)
    tri_count = np.asarray(tri_count, np.int64)
    key = cache.content_key("wide-blas-v1", pos, idx, uvs, flg, tri_start, tri_count,
                            builder_digest())
    hit = cache.load(key)
    if hit is not None:
        try:
            return (WideScene(np.ascontiguousarray(hit["rows"], np.float32), int(hit["depth"])),
                    np.asarray(hit["roots"], np.int32))
        except (KeyError, ValueError):
            cache.remove(key)
    tables, roots = [], []
    base, depth = 0, 1
    for lo, cnt in zip(tri_start, tri_count):
        ids = np.arange(lo, lo + cnt, dtype=np.int32)
        rows = runtime.build_bvh8_rows(pos, idx[lo:lo + cnt], uvs, flg[lo:lo + cnt], tri_ids=ids)
        depth = max(depth, stack_bound(rows))
        if base:
            interior = _classify_interior8(rows)
            valid = rows[:, 0:48:6] <= rows[:, 3:48:6]
            refs = rows[:, 48:56]
            fixed = np.where(refs >= 0, refs + base, refs - 4 * base)
            rows[:, 48:56] = np.where(interior[:, None] & valid, fixed, refs)
        roots.append(base)
        base += len(rows)
        tables.append(rows)
    runtime._check_ref_ceiling(base, 4)
    blas = WideScene(rows=np.concatenate(tables, axis=0), stack_depth=depth)
    roots = np.asarray(roots, np.int32)
    cache.save(key, rows=blas.rows, depth=blas.stack_depth, roots=roots)
    return blas, roots


def with_wide(accel: InstancedAccel, geometry) -> InstancedAccel:
    """``accel`` with the wide back end's tables (built by
    :func:`build_wide_blas` from the pool ``geometry`` and the accel's mesh
    ranges when it has none), on the device of its planar rows."""
    if accel.blas is not None:
        return accel
    if accel.mesh_tri_start is None:
        raise ValueError("the accel has no 8-wide tables and no mesh ranges to build them from")
    blas, roots = build_wide_blas(geometry, np.asarray(torch.as_tensor(accel.mesh_tri_start).cpu()),
                                  np.asarray(torch.as_tensor(accel.mesh_tri_count).cpu()))
    rows = accel.blas_planar.rows
    if isinstance(rows, torch.Tensor):
        blas = blas.to(rows.device)
        roots = torch.as_tensor(roots, device=rows.device)
    return dataclasses.replace(accel, blas=blas, mesh_root=roots)


# ---------------------------------------------------------------------------
# Top level: instance entry table, candidate enumeration, ray transform
# ---------------------------------------------------------------------------


def _instance_slab(inst: InstanceTable, origin, direction, t_best, mask=None):
    """Entry distance of each ray into each instance box: (R, I), INF where
    missed, not before the ray's ``t_best``, or outside the (I,) ``mask``."""
    inv_d = tf.inv_dir(direction)
    out = []
    for s in range(0, max(origin.shape[0], 1), _SLAB_CHUNK):
        o = origin[s:s + _SLAB_CHUNK, None, :]
        i = inv_d[s:s + _SLAB_CHUNK, None, :]
        lo = (inst.aabb_min[None] - o) * i
        hi = (inst.aabb_max[None] - o) * i
        tn = torch.amax(torch.minimum(lo, hi), dim=-1)
        tfar = torch.amin(torch.maximum(lo, hi), dim=-1)
        hit = (tn <= tfar) & (tfar >= 0.0) & (tn < t_best[s:s + _SLAB_CHUNK, None])
        if mask is not None:
            hit = hit & mask[None]
        out.append(torch.where(hit, tn, INF))
    return torch.cat(out)


def _scan_candidate(inst: InstanceTable, origin, direction, t_best, last_t, last_id, mask=None):
    """Per ray: the smallest (entry t, instance id) strictly after ``(last_t,
    last_id)`` among the instance boxes the ray enters before ``t_best``
    (and inside the (I,) ``mask``); id -1 where there is none. The instance
    table is scanned in chunks of ``_SCAN_CHUNK``, padded with empty boxes
    (min > max), so the working set is (R, chunk), never (R, I): the same
    result as :func:`_next_candidate` over :func:`_instance_slab`, bit for
    bit (the reference's ``_scan_candidate``)."""
    n, dev = inst.aabb_min.shape[0], origin.device
    chunk = min(_SCAN_CHUNK, 1 << max(n - 1, 0).bit_length())
    pad = -n % chunk
    amin = torch.cat([inst.aabb_min, torch.ones((pad, 3), dtype=inst.aabb_min.dtype, device=dev)])
    amax = torch.cat([inst.aabb_max, torch.zeros((pad, 3), dtype=inst.aabb_max.dtype, device=dev)])
    keep = torch.ones(n, dtype=torch.bool, device=dev) if mask is None else mask.bool()
    keep = torch.cat([keep, torch.zeros(pad, dtype=torch.bool, device=dev)])
    inv_d = tf.inv_dir(direction)
    o, i = origin[:, None, :], inv_d[:, None, :]
    r = origin.shape[0]
    bt = torch.full((r,), INF, device=dev)
    bi = torch.full((r,), 1 << 30, dtype=torch.int64, device=dev)
    ids = torch.arange(chunk, device=dev)[None]
    for base in range(0, n + pad, chunk):
        lo = (amin[None, base:base + chunk] - o) * i
        hi = (amax[None, base:base + chunk] - o) * i
        tn = torch.amax(torch.minimum(lo, hi), dim=-1)
        tfar = torch.amin(torch.maximum(lo, hi), dim=-1)
        ok = (tn <= tfar) & (tfar >= 0.0) & (tn < t_best[:, None]) & keep[None, base:base + chunk]
        after = (tn > last_t[:, None]) | ((tn == last_t[:, None]) & (base + ids > last_id[:, None]))
        key = torch.where(ok & after, tn, INF)
        ct = torch.amin(key, dim=1)
        ci = base + torch.argmin(key, dim=1)  # the first minimum: the lowest id
        better = (ct < bt) | ((ct == bt) & (ci < bi))
        bt = torch.where(better, ct, bt)
        bi = torch.where(better, ci, bi)
    return bt, torch.where(bt < INF, bi, -1)


def _candidates(inst: InstanceTable, origin, direction, t_max, mask, scan):
    """The round loops' candidate enumeration over ``inst``: a function of
    ``(lanes, t_best, last_t, last_id)`` giving the lanes' next (entry t,
    id), the lanes an index (or ``slice(None)`` for all). Up to
    ``_DENSE_I_MAX`` instances (``scan`` None) or with ``scan`` False, the
    (R, I) entry table computed once here, masked by each lane's best hit;
    above, or with ``scan`` True, the chunked scan per call."""
    if scan is None:
        scan = inst.aabb_min.shape[0] > _DENSE_I_MAX
    if scan:
        return lambda lanes, tb, lt, li: _scan_candidate(inst, origin[lanes], direction[lanes],
                                                          tb, lt, li, mask)
    entry0 = _instance_slab(inst, origin, direction, t_max, mask)

    def dense(lanes, tb, lt, li):
        e = entry0[lanes]
        return _next_candidate(torch.where(e < tb[:, None], e, INF), lt, li)

    return dense


def _next_candidate(entry, last_t, last_id):
    """Per ray: the smallest (entry t, instance id) strictly after
    ``(last_t, last_id)`` in that order; id -1 where there is none."""
    ids = torch.arange(entry.shape[1], device=entry.device)[None]
    after = (entry > last_t[:, None]) | ((entry == last_t[:, None]) & (ids > last_id[:, None]))
    key = torch.where(after & (entry < INF), entry, INF)
    nt = torch.amin(key, dim=1)
    ni = torch.argmin(key, dim=1)  # the first minimum: the lowest id
    return nt, torch.where(nt < INF, ni, -1)


def _transform_rays(inst: InstanceTable, iid, origin, direction):
    """Rays into the object space of instances ``iid``; the direction is not
    renormalised, so t stays world t."""
    w2o = inst.world_to_object[torch.clamp(iid, min=0)]
    return mat3_vec(w2o, origin) + w2o[:, :, 3], mat3_vec(w2o, direction)


def _check_pair(cull, any_hit) -> None:
    """The two-level passes run closest hit with culling or any hit
    without, the pairs their kernels instantiate; checked before the device
    dispatch, so that the CPU loops refuse what the card refuses."""
    if bool(cull) == bool(any_hit):
        raise ValueError("the two-level passes run closest hit with culling or any hit "
                         f"without, not cull={cull} with any_hit={any_hit}")


# ---------------------------------------------------------------------------
# Candidate rounds
# ---------------------------------------------------------------------------


def _subset(accel: InstancedAccel, subset: str):
    """A pass's ``(planar, roots, inst, mask)`` over ``subset``: "full"
    (every triangle, every instance); "full_alp", the full tables masked to
    the instances with alpha triangles (the instance-level split); "opq" or
    "alp" (each mesh's opaque or alpha
    subset, ``inst`` with the subset world boxes, the instances of
    ``inst_opaque`` or ``inst_alpha``; a subset root of -1 clamps to 0, safe
    under the mask, see ``check_root_masks``)."""
    if subset == "full":
        return accel.blas_planar, accel.mesh_root_planar, accel.inst, None
    if subset == "full_alp":
        return (accel.blas_planar, accel.mesh_root_planar, accel.inst,
                torch.as_tensor(accel.inst_alpha).bool())
    view = dataclasses.replace(accel.inst, aabb_min=getattr(accel, f"inst_aabb_{subset}_min"),
                               aabb_max=getattr(accel, f"inst_aabb_{subset}_max"))
    mask = accel.inst_opaque if subset == "opq" else accel.inst_alpha
    return (getattr(accel, f"blas_planar_{subset}"),
            torch.clamp(getattr(accel, f"mesh_root_{subset}"), min=0), view, mask)


def _two_level_opaque_pass(accel, subset, origin, direction, t_max, act, cull, any_hit):
    """Candidate rounds over the instances of ``subset`` ("full" or "opq",
    :func:`_subset`), traversing each instance's BLAS from its mesh root in
    mode a (closest hit, ``cull``) or b (``any_hit``, no culling). Returns
    per-lane ``(t_best, tri, u, v, inst, steps)``; ``t_best`` is ``t_max``
    where nothing was hit. CUDA tensors launch the opaque machine kernel
    (or raise), CPU tensors run the round loop."""
    _check_pair(cull, any_hit)
    if origin.device.type == "cuda":
        return _opaque_machine_cuda(accel, subset, origin, direction, t_max, act, any_hit)
    if origin.device.type != "cpu":
        raise ValueError(f"no opaque machine for device {origin.device}")
    planar, roots, inst, mask = _subset(accel, subset)
    return _two_level_pass(planar, roots, inst, origin, direction, t_max, act, mask, cull,
                           any_hit)


def _two_level_pass(planar, roots, inst, origin, direction, t_max, act, mask, cull, any_hit,
                    trav=tf.traverse, rounds=None, scan=None):
    """The opaque rounds as a loop of rounds on the live lanes (the plain
    version of the opaque machine kernel): each round's traversal is one
    ``trav`` call (``traverse_fused.traverse``: the per-round kernel with
    per-lane roots on CUDA tensors, the twin on CPU ones). ``rounds``, an
    optional (R,) integer tensor, counts each ray's rounds; ``scan`` picks
    the candidate enumeration (:func:`_candidates`; None: by the instance
    count)."""
    r, dev = origin.shape[0], origin.device
    mode = "any" if any_hit else "closest"
    next_cand = _candidates(inst, origin, direction, t_max, mask, scan)
    t_best = t_max.clone()
    tri = torch.full((r,), -1, dtype=torch.int64, device=dev)
    u = torch.zeros(r, device=dev)
    v = torch.zeros(r, device=dev)
    ibest = torch.zeros(r, dtype=torch.int64, device=dev)
    steps = torch.zeros(r, dtype=torch.int32, device=dev)
    last_t = torch.full((r,), _NEG, device=dev)
    last_id = torch.full((r,), -1, dtype=torch.int64, device=dev)
    nt, nid = next_cand(slice(None), t_max, last_t, last_id)
    live = torch.nonzero(act & (nid >= 0)).squeeze(1)
    while live.numel():
        if rounds is not None:
            rounds[live] += 1
        cid = nid[live]
        o_obj, d_obj = _transform_rays(inst, cid, origin[live], direction[live])
        root0 = roots[inst.mesh_id[cid]].to(torch.int32)
        tb = t_best[live]
        t, h_tri, hu, hv, hs, _, _ = trav(planar, o_obj, d_obj, tb, None, mode, cull, root0=root0)
        upd = h_tri >= 0
        tb = torch.where(upd, t, tb)
        t_best[live] = tb
        tri[live] = torch.where(upd, h_tri, tri[live])
        u[live] = torch.where(upd, hu, u[live])
        v[live] = torch.where(upd, hv, v[live])
        ibest[live] = torch.where(upd, cid, ibest[live])
        last_t[live] = nt[live]
        last_id[live] = cid
        steps[live] += hs + 1
        nt2, nid2 = next_cand(live, tb, nt[live], cid)
        nt[live] = nt2
        nid[live] = nid2
        keep = nid2 >= 0
        if any_hit:
            keep = keep & (tri[live] < 0)  # the first accepted hit occludes
        live = live[keep]
    return t_best, tri, u, v, ibest, steps


def _two_level_alpha_pass(accel, pack, origin, direction, t_max, seed, act, any_hit, cull,
                          subset="alp"):
    """Candidate rounds over the alpha subsets of the alpha-carrying
    instances (``subset`` "alp"; "full_alp": their full tables, the
    instance-level split), instance enumeration and stochastic window
    advance in one state machine: a live lane holds a candidate instance
    (entry-t order) and a window start ``t_lo`` inside it. A round
    traverses the instance's alpha BLAS in candidate mode over ``(t_lo,
    t_best)``; the nearest alpha surface takes one stochastic test
    (``traverse_alpha._alpha_accept``):
    pass records the hit and moves to the next instance, reject advances
    ``t_lo`` just past the surface and stays, a miss moves on; a ray stops
    after ``_A_MAX_ROUNDS`` rounds. Returns ``(t_best, tri, u, v, inst,
    seed, steps)``; ``tri`` is -1 (``t_best`` = ``t_max``) where no surface
    was accepted. CUDA tensors launch the alpha machine kernel (or raise),
    CPU tensors run the round loop."""
    _check_pair(cull, any_hit)
    if origin.device.type == "cuda":
        return _alpha_machine_cuda(accel, pack, origin, direction, t_max, seed, act, any_hit,
                                   cull, subset)
    if origin.device.type != "cpu":
        raise ValueError(f"no alpha machine for device {origin.device}")
    return _alpha_rounds(accel, pack, origin, direction, t_max, seed, act, any_hit, cull,
                         subset=subset)


def _alpha_rounds(accel, pack, origin, direction, t_max, seed, act, any_hit, cull,
                  trav=tf.traverse, rounds=None, scan=None, subset="alp"):
    """The alpha machine as a loop of rounds on the live lanes (the plain
    version of the alpha machine kernel) over ``subset`` ("alp" or
    "full_alp"): each round's candidate traversal is one ``trav`` call
    (``traverse_fused.traverse``: the per-round kernel with per-lane roots
    on CUDA tensors, the twin on CPU ones). ``rounds``, an optional (R,)
    integer tensor, counts each ray's rounds; ``scan`` picks the candidate
    enumeration (:func:`_candidates`)."""
    from .traverse_alpha import _ADV_ABS, _ADV_REL, _alpha_accept

    r, dev = origin.shape[0], origin.device
    planar, roots, view, mask = _subset(accel, subset)
    next_cand = _candidates(view, origin, direction, t_max, mask, scan)
    t_best = t_max.clone()
    tri = torch.full((r,), -1, dtype=torch.int64, device=dev)
    u = torch.zeros(r, device=dev)
    v = torch.zeros(r, device=dev)
    ibest = torch.zeros(r, dtype=torch.int64, device=dev)
    seed = seed.clone()
    steps = torch.zeros(r, dtype=torch.int32, device=dev)
    last_t = torch.full((r,), _NEG, device=dev)
    last_id = torch.full((r,), -1, dtype=torch.int64, device=dev)
    t_lo = torch.zeros(r, device=dev)
    nt, nid = next_cand(slice(None), t_max, last_t, last_id)
    live = torch.nonzero(act & (nid >= 0)).squeeze(1)
    n_rounds = 0
    while live.numel() and n_rounds < _A_MAX_ROUNDS:
        if rounds is not None:
            rounds[live] += 1
        cid = nid[live]
        tl = t_lo[live]
        d = direction[live]
        o_obj, d_obj = _transform_rays(accel.inst, cid, origin[live] + d * tl[:, None], d)
        root0 = roots[accel.inst.mesh_id[cid]].to(torch.int32)
        tb = t_best[live]
        t, h_tri, hu, hv, hs, uvu, uvv = trav(
            planar, o_obj, d_obj, torch.clamp(tb - tl, min=0.0), None,
            "candidate", cull, root0=root0,
        )
        cand = h_tri >= 0
        passed, seed[live] = _alpha_accept(pack, h_tri, uvu, uvv, seed[live], cand)
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
        t_lo[live] = torch.where(reject, t_abs * (1.0 + _ADV_REL) + _ADV_ABS, 0.0)
        steps[live] += hs + 1
        nt2, nid2 = next_cand(live, tb, lt, li)
        cid = torch.where(reject, cid, nid2)
        nt[live] = torch.where(reject, nt[live], nt2)
        nid[live] = cid
        n_rounds += 1
        keep = cid >= 0
        if any_hit:
            keep = keep & (tri[live] < 0)  # the first accepted surface occludes
        live = live[keep]
    return t_best, tri, u, v, ibest, seed, steps


def _instance_tables(inst: InstanceTable, roots, mask):
    """A round machine's instance table: (I, 6) world boxes (``inst``'s
    ``aabb_min``, ``aabb_max``: the pass's subset boxes), (I, 12)
    world-to-object rows and (I,) int32 BLAS roots ``roots[mesh]``, -1 for an
    instance outside ``mask`` (None: every instance)."""
    box = torch.cat([inst.aabb_min, inst.aabb_max], dim=1)
    w2o = inst.world_to_object.reshape(-1, 12)
    root = roots[inst.mesh_id.long()]
    if mask is not None:
        root = torch.where(mask.bool(), root, -1)
    return box.float().contiguous(), w2o.float().contiguous(), root.to(torch.int32).contiguous()


def _machine_tables(accel: InstancedAccel, subset: str):
    """The machine kernels' instance table over ``subset`` (:func:`_subset`),
    built once per accel and kept on it."""
    if subset not in accel._machine:
        _, roots, inst, mask = _subset(accel, subset)
        accel._machine[subset] = _instance_tables(inst, roots, mask)
    return accel._machine[subset]


def _check_tables(tables, dev):
    for name, x in zip(("instance boxes", "world_to_object", "roots"), tables):
        if x.device != dev:
            raise ValueError(f"{name}: on {x.device}, the rays on {dev}")


def _planar(accel: InstancedAccel, subset: str):
    """The BLAS row table of ``subset`` (:func:`_subset`) alone."""
    return accel.blas_planar if subset.startswith("full") else getattr(accel, f"blas_planar_{subset}")


def _opaque_machine_cuda(accel, subset, origin, direction, t_max, act, any_hit):
    """One launch of ``vkrt_opaque_machine``: every ray's opaque rounds, to
    its last instance, in one lane of a persistent warp."""
    planar = _planar(accel, subset)
    lib = tf._load(planar.width)
    r, dev = origin.shape[0], origin.device
    act = tf._check_rays(lib, planar, origin, direction, t_max, act)
    box, w2o, root = tables = _machine_tables(accel, subset)
    _check_tables(tables, dev)
    f = lambda: torch.empty(r, dtype=torch.float32, device=dev)  # noqa: E731
    i32 = lambda: torch.empty(r, dtype=torch.int32, device=dev)  # noqa: E731
    t, u, v, tri, ibest, steps = f(), f(), f(), i32(), i32(), i32()
    if r == 0:  # nothing to launch, and so nothing to count
        return t, tri.long(), u, v, ibest.long(), steps
    with tf.machine_state(lib, planar, dev, False, any_hit, root.shape[0]) as (
            scratch, slots, stream):
        err = lib.vkrt_opaque_machine(
            int(not any_hit), int(bool(any_hit)), planar.width, planar.rows.data_ptr(),
            planar.stack_depth, box.data_ptr(), w2o.data_ptr(), root.data_ptr(), root.shape[0],
            origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(), tf._ptr(act), r,
            scratch.data_ptr(), scratch.numel(), slots, t.data_ptr(), tri.data_ptr(),
            u.data_ptr(), v.data_ptr(), ibest.data_ptr(), steps.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"opaque machine kernel launch failed: cudaError {err}")
    tf.LAUNCHES[tf.launch_key("opaque_machine", planar.width)] += 1
    return t, tri.long(), u, v, ibest.long(), steps


def _alpha_machine_cuda(accel, pack, origin, direction, t_max, seed, act, any_hit, cull,
                        subset):
    """One launch of ``vkrt_alpha_machine``: every ray's rounds over
    ``subset``, to the end, in one lane of a persistent warp (closest hit
    with culling or any hit without)."""
    planar = _planar(accel, subset)
    lib = tf._load(planar.width)
    r, dev = origin.shape[0], origin.device
    act = tf._check_rays(lib, planar, origin, direction, t_max, act)
    tf._check("seed", seed, (r,), torch.int64, dev)
    box, w2o, root = tables = _machine_tables(accel, subset)
    _check_tables(tables, dev)
    n_inst = root.shape[0]
    tf._check("pack rows", pack.rows, (pack.rows.shape[0], 16), torch.float32, dev)
    tf._check("alpha plane", pack.alpha_plane, (pack.alpha_plane.numel(),), torch.uint8, dev)
    f = lambda: torch.empty(r, dtype=torch.float32, device=dev)  # noqa: E731
    i32 = lambda: torch.empty(r, dtype=torch.int32, device=dev)  # noqa: E731
    t, u, v, tri, inst, steps = f(), f(), f(), i32(), i32(), i32()
    seed_out = torch.empty_like(seed)
    if r == 0:  # nothing to launch, and so nothing to count
        return t, tri.long(), u, v, inst.long(), seed_out, steps
    with tf.machine_state(lib, planar, dev, True, any_hit, n_inst) as (scratch, slots, stream):
        err = lib.vkrt_alpha_machine(
            int(bool(cull)), int(bool(any_hit)), planar.width, planar.rows.data_ptr(),
            planar.stack_depth, box.data_ptr(), w2o.data_ptr(), root.data_ptr(), n_inst,
            pack.rows.data_ptr(), pack.rows.shape[0], pack.alpha_plane.data_ptr(),
            pack.alpha_plane.numel(), pack.atlas_width, origin.data_ptr(), direction.data_ptr(),
            t_max.data_ptr(), tf._ptr(act), seed.data_ptr(), r, _A_MAX_ROUNDS,
            scratch.data_ptr(), scratch.numel(), slots, t.data_ptr(), tri.data_ptr(),
            u.data_ptr(), v.data_ptr(), inst.data_ptr(), seed_out.data_ptr(), steps.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"alpha machine kernel launch failed: cudaError {err}")
    tf.LAUNCHES[tf.launch_key("alpha_machine", planar.width)] += 1
    return t, tri.long(), u, v, inst.long(), seed_out, steps


_WIDE_PARTS = ("all", "opaque", "alpha")


def _wide_mask(accel: InstancedAccel, part: str):
    """The instances of a wide pass: "all" (None), "opaque" (those without
    alpha triangles) or "alpha" (those with), the instance-level split."""
    if part not in _WIDE_PARTS:
        raise ValueError(f"no wide pass over {part!r}; the passes are {_WIDE_PARTS}")
    if part == "all":
        return None
    alpha = torch.as_tensor(accel.inst_alpha, device=accel.inst.aabb_min.device).bool()
    return alpha if part == "alpha" else ~alpha


def _wide_tables(accel: InstancedAccel, part: str):
    """The wide machine's instance table over ``part`` (:func:`_wide_mask`):
    the instances' world boxes, world-to-object rows and 8-wide BLAS roots
    (-1 outside the pass), built once per accel and kept on it."""
    key = ("wide", part)
    if key not in accel._machine:
        roots = torch.as_tensor(accel.mesh_root, device=accel.inst.aabb_min.device)
        accel._machine[key] = _instance_tables(accel.inst, roots, _wide_mask(accel, part))
    return accel._machine[key]


def _wide_machine_cuda(accel, pack, origin, direction, t_max, seed, act, part, any_hit):
    """One launch of ``vkrt_wide_machine``: every ray's wide rounds over the
    instances of ``part``, to its last instance, in one lane of a persistent
    warp."""
    from . import traverse_wide as tw

    lib = tw._load()
    blas = accel.blas
    r, dev = origin.shape[0], origin.device
    depth = tw.check_stack(blas)
    tf._check("rows", blas.rows, (blas.rows.shape[0], 64), torch.float32, dev)
    tf._check("origin", origin, (r, 3), torch.float32, dev)
    tf._check("direction", direction, (r, 3), torch.float32, dev)
    tf._check("t_max", t_max, (r,), torch.float32, dev)
    tf._check("seed", seed, (r,), torch.int64, dev)
    act = tw._check_active(act, r, dev)
    box, w2o, root = tables = _wide_tables(accel, part)
    _check_tables(tables, dev)
    n_inst = root.shape[0]
    alpha = tw._pack_args(pack, dev)
    f = lambda: torch.empty(r, dtype=torch.float32, device=dev)  # noqa: E731
    i32 = lambda: torch.empty(r, dtype=torch.int32, device=dev)  # noqa: E731
    t, u, v, tri, inst, steps = f(), f(), f(), i32(), i32(), i32()
    seed_out = torch.empty_like(seed)
    if r == 0:  # nothing to launch, and so nothing to count
        return t, tri.long(), u, v, inst.long(), seed_out, steps
    with tw._persistent(lib, (1, int(bool(any_hit)), int(pack is not None), n_inst), depth,
                        dev) as (scratch, slots, stream):
        err = lib.vkrt_wide_machine(
            int(bool(any_hit)), blas.rows.data_ptr(), depth, box.data_ptr(), w2o.data_ptr(),
            root.data_ptr(), n_inst, origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(),
            tf._ptr(act), seed.data_ptr(), *alpha, r, scratch.data_ptr(), scratch.numel(),
            slots, t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(), inst.data_ptr(),
            seed_out.data_ptr(), steps.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"wide machine kernel launch failed: cudaError {err}")
    tf.LAUNCHES["wide_machine"] += 1
    return t, tri.long(), u, v, inst.long(), seed_out, steps


def _wide_pass(accel, pack, origin, direction, t_max, seed, act, part, any_hit):
    """The wide back end's rounds over the instances of ``part`` ("all",
    "opaque" or "alpha", :func:`_wide_mask`; the reference's
    ``_two_level_pass`` with its XLA body): closest hit with culling or any
    hit without, the alpha test inline with ``pack``. Returns ``(t_best,
    tri, u, v, inst, seed, steps)``; ``t_best`` is ``t_max`` where nothing
    was hit. CUDA tensors launch the wide machine kernel once (or raise),
    CPU tensors run its plain version, the round loop :func:`_wide_rounds`."""
    if origin.device.type == "cuda":
        return _wide_machine_cuda(accel, pack, origin, direction, t_max, seed, act, part,
                                  any_hit)
    if origin.device.type != "cpu":
        raise ValueError(f"no wide machine for device {origin.device}")
    return _wide_rounds(accel, pack, origin, direction, t_max, seed, act, part, any_hit)


def _wide_rounds(accel, pack, origin, direction, t_max, seed, act, part, any_hit, rounds=None,
                 scan=None, seen=None, draws=None):
    """The wide machine as a loop of rounds on the live lanes (its plain
    version, on any device): each round traverses the candidate instance's
    8-wide BLAS from its mesh root with ``t_max = t_best`` by the plain
    traversal ``traverse_wide._traverse_wide_plain``, the seed carried,
    ``steps`` the round's nodes + 1. ``rounds``, an optional (R,) integer
    tensor, counts each ray's rounds; ``scan`` picks the candidate
    enumeration (:func:`_candidates`); ``seen`` (over the BLAS rows) and
    ``draws`` (per ray) go to the traversal's counters."""
    from .traverse_wide import _traverse_wide_plain

    r, dev = origin.shape[0], origin.device
    inst, roots = accel.inst, torch.as_tensor(accel.mesh_root, device=dev)
    next_cand = _candidates(inst, origin, direction, t_max, _wide_mask(accel, part), scan)
    t_best = t_max.clone()
    tri = torch.full((r,), -1, dtype=torch.int64, device=dev)
    u = torch.zeros(r, device=dev)
    v = torch.zeros(r, device=dev)
    ibest = torch.zeros(r, dtype=torch.int64, device=dev)
    seed = seed.clone()
    steps = torch.zeros(r, dtype=torch.int32, device=dev)
    last_t = torch.full((r,), _NEG, device=dev)
    last_id = torch.full((r,), -1, dtype=torch.int64, device=dev)
    nt, nid = next_cand(slice(None), t_max, last_t, last_id)
    live = torch.nonzero(act & (nid >= 0)).squeeze(1)
    while live.numel():
        if rounds is not None:
            rounds[live] += 1
        cid = nid[live]
        o_obj, d_obj = _transform_rays(inst, cid, origin[live], direction[live])
        root0 = roots[inst.mesh_id[cid].long()].to(torch.int32).contiguous()
        tb = t_best[live]
        dr = None if draws is None else torch.zeros_like(draws[live])
        t, h_tri, hu, hv, hs, seed[live] = _traverse_wide_plain(
            accel.blas, pack, o_obj, d_obj, tb, seed[live], None, any_hit, root0=root0,
            seen=seen, draws=dr)
        if draws is not None:
            draws[live] += dr
        upd = h_tri >= 0
        tb = torch.where(upd, t, tb)
        t_best[live] = tb
        tri[live] = torch.where(upd, h_tri, tri[live])
        u[live] = torch.where(upd, hu, u[live])
        v[live] = torch.where(upd, hv, v[live])
        ibest[live] = torch.where(upd, cid, ibest[live])
        last_t[live] = nt[live]
        last_id[live] = cid
        steps[live] += hs + 1
        nt2, nid2 = next_cand(live, tb, nt[live], cid)
        nt[live] = nt2
        nid[live] = nid2
        keep = nid2 >= 0
        if any_hit:
            keep = keep & (tri[live] < 0)  # the first accepted hit occludes
        live = live[keep]
    return t_best, tri, u, v, ibest, seed, steps


def _two_level_wide(accel, pack, origin, direction, t_max, seed, act, any_hit):
    """The wide back end over the instances: one pass over every instance
    without a pack (or without alpha-carrying instances); with one, the
    opaque instances first, then the alpha-carrying ones with the test
    inline, windowed by the opaque t (closest) or only for the rays still
    unoccluded (any)."""
    if accel.blas is None:
        raise ValueError("the wide back end needs the accel's 8-wide tables: "
                         "ops/tlas.with_wide(accel, geometry)")
    if pack is None or not accel._any_alpha():
        t_best, tri, u, v, ibest, seed, steps = _wide_pass(
            accel, None, origin, direction, t_max, seed, act, "all", any_hit)
        return Hit(torch.where(tri >= 0, t_best, INF), tri, u, v, steps, ibest), seed
    t_o, tri_o, u_o, v_o, i_o, seed, st_o = _wide_pass(
        accel, None, origin, direction, t_max, seed, act, "opaque", any_hit)
    if any_hit:
        t_a, tri_a, u_a, v_a, i_a, seed, st_a = _wide_pass(
            accel, pack, origin, direction, t_max, seed, act & (tri_o < 0), "alpha", any_hit)
        take_a = tri_o < 0
    else:
        t_a, tri_a, u_a, v_a, i_a, seed, st_a = _wide_pass(
            accel, pack, origin, direction, t_o, seed, act, "alpha", any_hit)
        take_a = (tri_a >= 0) & (t_a < t_o)
    tri = torch.where(take_a, tri_a, tri_o)
    t_best = torch.where(take_a, t_a, t_o)
    return Hit(
        t=torch.where(tri >= 0, t_best, INF), tri=tri,
        u=torch.where(take_a, u_a, u_o), v=torch.where(take_a, v_a, v_o),
        steps=st_o + st_a, inst=torch.where(take_a, i_a, i_o),
    ), seed


def _two_level(accel: InstancedAccel, pack, origin, direction, t_max, seed, cull, any_hit,
               active, backend="fused"):
    """Closest or any hit over the instances. Without an alpha pack, one
    pass over every instance's full table. With one, the opaque subsets
    first, then the alpha machine over the alpha subsets windowed by the
    opaque result. A pool without subsets is all opaque or all alpha-tested
    (the reference's instance-level split): all opaque, it takes the pass
    without a pack (the alpha pass would have no instance); all
    alpha-tested, the alpha machine alone over the full tables of the
    instances with alpha triangles (the opaque pass would have none but
    empty meshes)."""
    check_backend(backend)
    r, dev = origin.shape[0], origin.device
    if seed is None:
        seed = torch.zeros(r, dtype=torch.int64, device=dev)
    act = torch.ones(r, dtype=torch.bool, device=dev) if active is None else active
    if backend == "wide":
        _check_pair(cull, any_hit)
        return _two_level_wide(accel, pack, origin, direction, t_max, seed, act, any_hit)
    split = accel.blas_planar_opq is not None and accel.blas_planar_alp is not None
    if pack is None or not (split or accel._any_alpha()):
        t_best, tri, u, v, ibest, steps = _two_level_opaque_pass(
            accel, "full", origin, direction, t_max, act, cull, any_hit
        )
        return Hit(torch.where(tri >= 0, t_best, INF), tri, u, v, steps, ibest), seed
    if not split:
        t_a, tri_a, u_a, v_a, i_a, seed, st_a = _two_level_alpha_pass(
            accel, pack, origin, direction, t_max, seed, act, any_hit, cull, subset="full_alp"
        )
        return Hit(torch.where(tri_a >= 0, t_a, INF), tri_a, u_a, v_a, st_a, i_a), seed
    t_o, tri_o, u_o, v_o, i_o, st_o = _two_level_opaque_pass(
        accel, "opq", origin, direction, t_max, act, cull, any_hit
    )
    act_a = act & (tri_o < 0) if any_hit else act
    t_a, tri_a, u_a, v_a, i_a, seed, st_a = _two_level_alpha_pass(
        accel, pack, origin, direction, t_o, seed, act_a, any_hit, cull
    )
    # Any hit: the opaque result stands where it hit; closest: the alpha
    # surface wins where it is nearer.
    take_a = tri_o < 0 if any_hit else (tri_a >= 0) & (t_a < t_o)
    tri = torch.where(take_a, tri_a, tri_o)
    t_best = torch.where(take_a, t_a, t_o)
    return Hit(
        t=torch.where(tri >= 0, t_best, INF), tri=tri,
        u=torch.where(take_a, u_a, u_o), v=torch.where(take_a, v_a, v_o),
        steps=st_o + st_a, inst=torch.where(take_a, i_a, i_o),
    ), seed


def closest_hit_instanced(accel, pack, origin, direction, seed=None, active=None, t_max=None,
                          backend="fused"):
    """Nearest hit with backface culling by ``backend`` ("fused" or
    "wide"); with an alpha ``pack``, alpha surfaces pass their stochastic
    test. Returns ``(Hit, seed')``; the hit carries its instance in
    ``inst``."""
    if t_max is None:
        t_max = torch.full(origin.shape[:1], INF, device=origin.device)
    return _two_level(accel, pack, origin, direction, t_max, seed, True, False, active, backend)


def any_hit_instanced(accel, pack, origin, direction, t_max, seed=None, active=None,
                      backend="fused"):
    """Shadow-ray occlusion within ``t_max`` (no culling) by ``backend``.
    Returns ``(occluded, seed')``."""
    hit, seed = _two_level(accel, pack, origin, direction, t_max, seed, False, True, active,
                           backend)
    return hit.tri >= 0, seed
