"""Instance tables for two-level (TLAS/BLAS) acceleration, frozen for the
benchmark (a copy of ``vk_raytrace_torch/models/instances.py``).

Meshes stay in object space in one shared pool; an instance is a 3x4
transform and a mesh id. The traversal transforms rays into object space at
instance entry (``ops/tlas.py``), and the shading brings hit attributes back
to world space with the same per-instance rows. Host numpy only.

Winding: front-facing is evaluated in object space, as in Vulkan ray
tracing, so a mirrored instance flips its apparent world-space winding.
"""

from __future__ import annotations

import numpy as np

from .builder import GeometryBuilder
from .schema import ALPHA_OPAQUE, InstanceTable, MeshPool


class InstancedSceneBuilder:
    """Builds a :class:`MeshPool` and an :class:`InstanceTable`::

        b = InstancedSceneBuilder()
        tree = b.add_mesh(verts, idx, material, uv=...)
        b.add_instance(tree, transform)   # any number of times
        pool, instances = b.build()
    """

    def __init__(self) -> None:
        self._g = GeometryBuilder()
        self._ranges: list[tuple[int, int]] = []
        self._bounds: list[tuple[np.ndarray, np.ndarray]] = []
        self._tri_cursor = 0
        self._inst_mesh: list[int] = []
        self._inst_xf: list[np.ndarray] = []

    def add_mesh(self, positions, indices, material: int, *, normals=None, uv=None,
                 tangents=None, colors=None, double_sided: bool = False,
                 alpha_mode: int = ALPHA_OPAQUE) -> int:
        positions = np.asarray(positions, np.float64).reshape(-1, 3)
        indices = np.asarray(indices, np.int64).reshape(-1, 3)
        self._g.add_mesh(
            positions, indices, material, normals=normals, uv=uv, tangents=tangents,
            colors=colors, double_sided=double_sided, alpha_mode=alpha_mode,
        )
        nt = len(indices)
        self._ranges.append((self._tri_cursor, nt))
        self._bounds.append((positions.min(axis=0), positions.max(axis=0)))
        self._tri_cursor += nt
        return len(self._ranges) - 1

    def add_instance(self, mesh_id: int, transform) -> int:
        m = np.asarray(transform, np.float64)
        assert m.shape == (4, 4)
        self._inst_mesh.append(int(mesh_id))
        self._inst_xf.append(m)
        return len(self._inst_mesh) - 1

    def build(self) -> tuple[MeshPool, InstanceTable]:
        assert self._inst_mesh, "no instances"
        mmin = np.stack([b[0] for b in self._bounds])
        mmax = np.stack([b[1] for b in self._bounds])
        pool = MeshPool(
            geometry=self._g.build(),
            tri_start=np.asarray([r[0] for r in self._ranges], np.int64),
            tri_count=np.asarray([r[1] for r in self._ranges], np.int64),
            aabb_min=mmin.astype(np.float32),
            aabb_max=mmax.astype(np.float32),
        )
        n = len(self._inst_mesh)
        o2w = np.zeros((n, 3, 4), np.float32)
        w2o = np.zeros((n, 3, 4), np.float32)
        amin = np.zeros((n, 3), np.float32)
        amax = np.zeros((n, 3), np.float32)
        for i, (mid, m) in enumerate(zip(self._inst_mesh, self._inst_xf)):
            o2w[i] = m[:3, :4]
            w2o[i] = np.linalg.inv(m)[:3, :4]
            # World box of the transformed object box: centre through M,
            # half-extent through |M| per axis.
            c = (mmin[mid] + mmax[mid]) / 2.0
            e = (mmax[mid] - mmin[mid]) / 2.0
            cw = m[:3, :3] @ c + m[:3, 3]
            ew = np.abs(m[:3, :3]) @ e
            amin[i] = cw - ew
            amax[i] = cw + ew
        inst = InstanceTable(
            object_to_world=o2w,
            world_to_object=w2o,
            mesh_id=np.asarray(self._inst_mesh, np.int32),
            aabb_min=amin,
            aabb_max=amax,
        )
        return pool, inst
