"""Acceleration structures (counterpart of the planar part of
``vk_raytrace_tpu/ops/bvh8.py::_build_accel_bundle_impl``).

The scene splits by the per-triangle alpha flag; each subset gets a native
binned-SAH build of planar rows from the native host builders
(:func:`vk_raytrace_torch.runtime.build_planar_rows`), with the subset's
triangles keeping their original ids. Rows are 16 wide (512 B) unless the
caller asks for 32 (1024 B); the reference picks the same width from
``VKRT_WIDE``, the port takes it as an argument. The reference's 8-wide XLA
tables are not built.
"""

from __future__ import annotations

import numpy as np

from .. import runtime
from .traverse_fused import PlanarScene
from .traverse_wide import AccelBundle


def _planar(geom, indices, tri_flags, tri_ids, width) -> PlanarScene:
    rows, depth = runtime.build_planar_rows(
        np.asarray(geom.positions), indices, np.asarray(geom.uv), tri_flags, tri_ids=tri_ids,
        width=width,
    )
    return PlanarScene(rows=rows, stack_depth=depth, width=width)


def build_accel_bundle(geom, width: int = 16) -> AccelBundle:
    """Opaque and alpha planar trees of a world-space Geometry (host numpy),
    ``width`` (16 or 32) children per interior row."""
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
