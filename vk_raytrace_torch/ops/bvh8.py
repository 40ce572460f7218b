"""Acceleration structures (counterpart of the planar part of
``vk_raytrace_tpu/ops/bvh8.py::_build_accel_bundle_impl``).

The scene splits by the per-triangle alpha flag; each subset gets a native
binned-SAH build of planar rows from the native host builders
(:func:`vk_raytrace_torch.runtime.build_planar_rows`), with the subset's
triangles keeping their original ids. Rows are 16 wide (512 B) unless the
caller asks for 32 (1024 B); the reference picks the same width from
``VKRT_WIDE``, the port takes it as an argument.

The wide back end (``renderer="wide"``, ``ops/traverse_wide.py``) reads its
own 8-wide tables (:class:`WideScene`, 256-byte rows from the native
builder ``runtime.build_bvh8_rows``) over the same opaque and alpha
subsets. They are built at the back end's first use (:func:`with_wide`),
so a run on the planar tables alone pays nothing for them, and cached like
the planar ones. The reference's device LBVH and its host collapse
(``collapse_bvh8``), its fallback for a missing native builder, are not
ported: the port always builds natively.

Bundles are disk-cached (``utils/cache.py``), keyed by the geometry, the
row width and a digest of the builder's sources (the native builder, its
binding ``runtime.py`` and this module), so that a changed builder misses
every entry it did not make.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib

import numpy as np

from .. import runtime
from ..utils import cache
from .traverse_fused import PlanarScene
from .traverse_wide import AccelBundle


# The kernel's stack (csrc/traverse_wide.cu): the reference caps its own at
# twice its default of 32 entries; a tree that needs more raises.
WIDE_STACK_MAX = 64


@dataclasses.dataclass
class WideScene:
    """The wide back end's row table: ``rows`` (X, 64) f32, row 0 the root.

    Interior rows: lanes ``[6c .. 6c+5]`` child c's box (min xyz, max xyz;
    an empty slot has min > max), lane ``48+c`` its ref (>= 0 an interior
    row; < 0 a leaf, ``-(row*4 + count-1) - 1``), lanes 56-63 zero. Leaf
    rows: 4 triangles of 16 lanes, p0 p1 p2, uv0 uv1 uv2 and
    ``orig_tri_id*4 + flags`` (bit 0 double-sided, bit 1 alpha-tested).
    ``stack_depth`` is the tree's exact worst-case traversal stack need."""

    rows: object
    stack_depth: int

    def to(self, device) -> "WideScene":
        from ..models.schema import to_tensor

        return dataclasses.replace(self, rows=to_tensor(self.rows, device))


def stack_bound(rows: np.ndarray) -> int:
    """Exact worst-case stack need of an 8-wide table from row 0: pushing a
    node's other hit children costs (n_children - 1) entries that stay
    live while the deepest child subtree runs, so need(node) =
    (n_children - 1) + max(child needs) (``bvh8.py::_stack_bound``)."""
    need = np.zeros(len(rows), np.int32)
    todo = [(0, False)]
    while todo:
        ref, ready = todo.pop()
        if ref < 0:
            continue
        row = rows[ref]
        kids = [int(row[48 + c]) for c in range(8) if row[c * 6] <= row[c * 6 + 3]]
        if not ready:
            todo.append((ref, True))
            todo.extend((k, False) for k in kids if k >= 0)
        else:
            need[ref] = max(len(kids) - 1, 0) + max((need[k] for k in kids if k >= 0), default=0)
    return max(int(need[0]), 1)


def _wide(geom, indices, tri_flags, tri_ids) -> WideScene:
    rows = runtime.build_bvh8_rows(np.asarray(geom.positions), indices, np.asarray(geom.uv),
                                   tri_flags, tri_ids=tri_ids)
    return WideScene(rows=rows, stack_depth=stack_bound(rows))


def _planar(geom, indices, tri_flags, tri_ids, width) -> PlanarScene:
    rows, depth = runtime.build_planar_rows(
        np.asarray(geom.positions), indices, np.asarray(geom.uv), tri_flags, tri_ids=tri_ids,
        width=width,
    )
    return PlanarScene(rows=rows, stack_depth=depth, width=width)


# The sources whose content the cache key hashes: every file that decides
# what a build produces.
DIGEST_SOURCES = (runtime._SRC, runtime.__file__, __file__)


@functools.lru_cache(maxsize=None)
def builder_digest() -> str:
    """Content hash of :data:`DIGEST_SOURCES`."""
    h = hashlib.blake2b(digest_size=10)
    for path in DIGEST_SOURCES:
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def build_accel_bundle(geom, width: int = 16) -> AccelBundle:
    """Opaque and alpha planar trees of a world-space Geometry (host numpy),
    ``width`` (16 or 32) children per interior row; from the disk cache
    when an entry of the same geometry, width and builder is there."""
    key = cache.content_key("accel-v1", geom.positions, geom.indices, geom.uv, geom.tri_flags,
                            f"w{width}", builder_digest())
    hit = cache.load(key)
    if hit is not None:
        try:
            return _bundle_from_arrays(hit, width)
        except (KeyError, ValueError):
            cache.remove(key)
    bundle = _build(geom, width)
    cache.save(key, **_bundle_arrays(bundle))
    return bundle


def _bundle_arrays(bundle: AccelBundle) -> dict:
    out = {"opaque_rows": bundle.opaque_planar.rows,
           "opaque_depth": bundle.opaque_planar.stack_depth}
    if bundle.alpha_planar is not None:
        out.update(alpha_rows=bundle.alpha_planar.rows,
                   alpha_depth=bundle.alpha_planar.stack_depth)
    return out


def _bundle_from_arrays(z: dict, width: int) -> AccelBundle:
    def planar(name):
        rows = np.ascontiguousarray(z[f"{name}_rows"], np.float32)
        if rows.ndim != 2 or rows.shape[1] != width * 8:
            raise ValueError(f"cached {name} rows of shape {rows.shape} at width {width}")
        return PlanarScene(rows=rows, stack_depth=int(z[f"{name}_depth"]), width=width)

    return AccelBundle(planar("opaque"), planar("alpha") if "alpha_rows" in z else None)


def _split(geom, make):
    """``(opaque, alpha)`` trees by ``make(geom, indices, flags, tri_ids)``:
    the whole scene and None without alpha-tested triangles, else each
    subset, its triangles keeping their original ids."""
    flags = np.asarray(geom.tri_flags)
    alpha_mask = (flags & 2) != 0
    if not alpha_mask.any():
        return make(geom, np.asarray(geom.indices), flags, None), None

    def subset(mask):
        ids = np.where(mask)[0]
        idx = np.asarray(geom.indices)[ids]
        tf = flags[ids]
        if len(ids) < 2:  # the builder needs >= 2 triangles: pad degenerate
            pad = 2 - len(ids)
            idx = np.concatenate([idx, np.zeros((pad, 3), idx.dtype)])
            tf = np.concatenate([tf, np.zeros(pad, tf.dtype)])
            ids = np.concatenate([ids, np.zeros(pad, ids.dtype)])
        return make(geom, idx, tf, ids)

    return subset(~alpha_mask), subset(alpha_mask)


def _build(geom, width: int) -> AccelBundle:
    return AccelBundle(*_split(geom, lambda g, i, f, ids: _planar(g, i, f, ids, width)))


def host_geometry(geom):
    """The builder's inputs of ``geom`` (numpy or tensors on any device):
    positions, indices, uv and tri_flags as host numpy arrays."""
    import types

    import torch

    def arr(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    return types.SimpleNamespace(positions=arr(geom.positions), indices=arr(geom.indices),
                                 uv=arr(geom.uv), tri_flags=arr(geom.tri_flags))


def build_wide(geom):
    """The wide back end's ``(opaque, alpha)`` 8-wide trees of a
    world-space Geometry (numpy or tensors), alpha None without
    alpha-tested triangles; from the disk cache when an entry of the same
    geometry and builder is there."""
    geom = host_geometry(geom)
    key = cache.content_key("wide-v1", geom.positions, geom.indices, geom.uv, geom.tri_flags,
                            builder_digest())
    hit = cache.load(key)
    if hit is not None:
        try:
            return (WideScene(np.ascontiguousarray(hit["opaque_rows"], np.float32),
                              int(hit["opaque_depth"])),
                    WideScene(np.ascontiguousarray(hit["alpha_rows"], np.float32),
                              int(hit["alpha_depth"])) if "alpha_rows" in hit else None)
        except (KeyError, ValueError):
            cache.remove(key)
    opaque, alpha = _split(geom, _wide)
    arrays = {"opaque_rows": opaque.rows, "opaque_depth": opaque.stack_depth}
    if alpha is not None:
        arrays.update(alpha_rows=alpha.rows, alpha_depth=alpha.stack_depth)
    cache.save(key, **arrays)
    return opaque, alpha


def with_wide(bundle: AccelBundle, geom) -> AccelBundle:
    """``bundle`` with the wide back end's tables (built from ``geom`` by
    :func:`build_wide` when it has none), on the device of its planar rows."""
    if bundle.opaque is not None:
        return bundle
    import torch

    opaque, alpha = build_wide(geom)
    rows = bundle.opaque_planar.rows
    if isinstance(rows, torch.Tensor):
        opaque = opaque.to(rows.device)
        alpha = None if alpha is None else alpha.to(rows.device)
    return dataclasses.replace(bundle, opaque=opaque, alpha=alpha)
