"""Acceleration structures (counterpart of the planar part of
``vk_raytrace_tpu/ops/bvh8.py::_build_accel_bundle_impl``).

The scene splits by the per-triangle alpha flag; each subset gets a native
binned-SAH build of planar rows from the native host builders
(:func:`vk_raytrace_torch.runtime.build_planar_rows`), with the subset's
triangles keeping their original ids. Rows are 16 wide (512 B) unless the
caller asks for 32 (1024 B); the reference picks the same width from
``VKRT_WIDE``, the port takes it as an argument. The reference's 8-wide XLA
tables are not built.

Bundles are disk-cached (``utils/cache.py``), keyed by the geometry, the
row width and a digest of the native builder's source, so that a changed
builder misses every entry it did not make.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np

from .. import runtime
from ..utils import cache
from .traverse_fused import PlanarScene
from .traverse_wide import AccelBundle


def _planar(geom, indices, tri_flags, tri_ids, width) -> PlanarScene:
    rows, depth = runtime.build_planar_rows(
        np.asarray(geom.positions), indices, np.asarray(geom.uv), tri_flags, tri_ids=tri_ids,
        width=width,
    )
    return PlanarScene(rows=rows, stack_depth=depth, width=width)


@functools.lru_cache(maxsize=None)
def builder_digest() -> str:
    """Content hash of ``csrc/native.cpp``."""
    with open(runtime._SRC, "rb") as f:
        return hashlib.blake2b(f.read(), digest_size=10).hexdigest()


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


def _build(geom, width: int) -> AccelBundle:
    flags = np.asarray(geom.tri_flags)
    alpha_mask = (flags & 2) != 0
    if not alpha_mask.any():
        return AccelBundle(_planar(geom, np.asarray(geom.indices), flags, None, width))

    def subset(mask):
        ids = np.where(mask)[0]
        idx = np.asarray(geom.indices)[ids]
        tf = flags[ids]
        if len(ids) < 2:  # the builder needs >= 2 triangles: pad degenerate
            pad = 2 - len(ids)
            idx = np.concatenate([idx, np.zeros((pad, 3), idx.dtype)])
            tf = np.concatenate([tf, np.zeros(pad, tf.dtype)])
            ids = np.concatenate([ids, np.zeros(pad, ids.dtype)])
        return _planar(geom, idx, tf, ids, width)

    return AccelBundle(subset(~alpha_mask), subset(alpha_mask))
