"""Acceleration structures (counterpart of the planar part of
``vk_raytrace_tpu/ops/bvh8.py::_build_accel_bundle_impl``).

The scene splits by the per-triangle alpha flag; each subset gets a native
binned-SAH build of 16-wide, 512-byte planar rows from the native host
builders (:func:`vk_raytrace_torch.runtime.build_planar_rows`), with the
subset's triangles keeping their original ids. The reference's 8-wide XLA
tables are not built.
"""

from __future__ import annotations

import numpy as np

from .. import runtime
from .traverse_fused import PlanarScene
from .traverse_wide import AccelBundle


def _planar(geom, indices, tri_flags, tri_ids) -> PlanarScene:
    rows, depth = runtime.build_planar_rows(
        np.asarray(geom.positions), indices, np.asarray(geom.uv), tri_flags, tri_ids=tri_ids,
    )
    return PlanarScene(rows=rows, stack_depth=depth, width=16)


def build_accel_bundle(geom) -> AccelBundle:
    """Opaque and alpha planar trees of a world-space Geometry (host numpy)."""
    flags = np.asarray(geom.tri_flags)
    alpha_mask = (flags & 2) != 0
    if not alpha_mask.any():
        return AccelBundle(_planar(geom, np.asarray(geom.indices), flags, None))

    def subset(mask):
        ids = np.where(mask)[0]
        idx = np.asarray(geom.indices)[ids]
        tf = flags[ids]
        if len(ids) < 2:  # the builder needs >= 2 triangles: pad degenerate
            pad = 2 - len(ids)
            idx = np.concatenate([idx, np.zeros((pad, 3), idx.dtype)])
            tf = np.concatenate([tf, np.zeros(pad, tf.dtype)])
            ids = np.concatenate([ids, np.zeros(pad, ids.dtype)])
        return _planar(geom, idx, tf, ids)

    return AccelBundle(subset(~alpha_mask), subset(alpha_mask))
