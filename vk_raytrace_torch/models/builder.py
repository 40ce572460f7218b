"""Host-side scene assembly: meshes + transforms -> a world-space Geometry.

Counterpart of ``vk_raytrace_tpu/models/builder.py``. Oct encoding, RGBA8
packing and smooth normals run in the native host builders
(:mod:`vk_raytrace_torch.runtime`), which raise instead of falling back.
"""

from __future__ import annotations

import numpy as np

from .. import runtime
from .schema import ALPHA_OPAQUE, Geometry


class GeometryBuilder:
    """Accumulates meshes and emits a world-space :class:`Geometry`."""

    def __init__(self) -> None:
        self._pos: list[np.ndarray] = []
        self._nrm: list[np.ndarray] = []
        self._tan: list[np.ndarray] = []
        self._hand: list[np.ndarray] = []
        self._uv: list[np.ndarray] = []
        self._col: list[np.ndarray] = []
        self._idx: list[np.ndarray] = []
        self._mat: list[np.ndarray] = []
        self._flags: list[np.ndarray] = []
        self._voffset = 0

    def add_mesh(
        self,
        positions: np.ndarray,           # (V, 3)
        indices: np.ndarray,             # (T, 3)
        material: int,
        *,
        normals: np.ndarray | None = None,
        uv: np.ndarray | None = None,
        tangents: np.ndarray | None = None,   # (V, 4) xyz + handedness w
        colors: np.ndarray | None = None,     # (V, 4)
        transform: np.ndarray | None = None,  # (4, 4), p' = M @ [p, 1]
        double_sided: bool = False,
        alpha_mode: int = ALPHA_OPAQUE,
    ) -> None:
        positions = np.asarray(positions, np.float64).reshape(-1, 3)
        indices = np.asarray(indices, np.int64).reshape(-1, 3)
        nv = len(positions)
        nt = len(indices)

        if normals is None:
            normals = runtime.smooth_normals(positions, indices)
        normals = np.asarray(normals, np.float64).reshape(-1, 3)
        if uv is None:
            uv = np.zeros((nv, 2))
        if colors is None:
            colors = np.ones((nv, 4))
        if tangents is None:
            tangents = _default_tangents(normals)
        tangents = np.asarray(tangents, np.float64)
        if tangents.shape[1] == 3:
            tangents = np.concatenate([tangents, np.ones((nv, 1))], axis=1)

        if transform is not None:
            m = np.asarray(transform, np.float64)
            positions = positions @ m[:3, :3].T + m[:3, 3]
            nmat = np.linalg.inv(m[:3, :3]).T
            normals = normals @ nmat.T
            normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-20)
            t3 = tangents[:, :3] @ m[:3, :3].T
            t3 /= np.maximum(np.linalg.norm(t3, axis=1, keepdims=True), 1e-20)
            tangents = np.concatenate([t3, tangents[:, 3:4]], axis=1)
            if np.linalg.det(m[:3, :3]) < 0:
                indices = indices[:, [0, 2, 1]]  # keep winding for culling

        flags = (1 if double_sided else 0) | (2 if alpha_mode != ALPHA_OPAQUE else 0)

        self._pos.append(positions.astype(np.float32))
        self._nrm.append(normals.astype(np.float32))
        self._tan.append(tangents.astype(np.float32))
        self._hand.append(tangents[:, 3].astype(np.float32))
        self._uv.append(np.asarray(uv, np.float32).reshape(-1, 2))
        self._col.append(np.asarray(colors, np.float32).reshape(-1, 4))
        self._idx.append((indices + self._voffset).astype(np.int32))
        self._mat.append(np.full(nt, material, np.int32))
        self._flags.append(np.full(nt, flags, np.int32))
        self._voffset += nv

    def build(self) -> Geometry:
        assert self._pos, "empty scene"
        idx = np.concatenate(self._idx)
        mat = np.concatenate(self._mat)
        flags = np.concatenate(self._flags)
        # The BVH builders need >= 2 triangles; pad with a degenerate one.
        if len(idx) < 2:
            idx = np.concatenate([idx, idx[:1]])
            mat = np.concatenate([mat, mat[:1]])
            flags = np.concatenate([flags, np.zeros(1, np.int32)])
        tan = np.concatenate(self._tan)
        return Geometry(
            positions=np.concatenate(self._pos),
            normals=runtime.oct_encode(np.concatenate(self._nrm)),
            tangents=runtime.oct_encode(tan[:, :3]),
            tangent_handedness=np.concatenate(self._hand),
            uv=np.concatenate(self._uv),
            color=runtime.pack_rgba8(np.concatenate(self._col)),
            indices=idx,
            tri_material=mat,
            tri_flags=flags,
        )


def _default_tangents(normals: np.ndarray) -> np.ndarray:
    """Arbitrary orthonormal tangents (CreateTangent, shade_state.glsl:36-41)."""
    n = normals
    big_z = np.abs(n[:, 2]) > 0.99999
    t = np.where(
        big_z[:, None],
        np.stack([-n[:, 0] * n[:, 1], 1.0 - n[:, 1] ** 2, -n[:, 1] * n[:, 2]], axis=1),
        np.stack([-n[:, 0] * n[:, 2], -n[:, 1] * n[:, 2], 1.0 - n[:, 2] ** 2], axis=1),
    )
    t /= np.maximum(np.linalg.norm(t, axis=1, keepdims=True), 1e-20)
    return np.concatenate([t, np.ones((len(n), 1))], axis=1)
