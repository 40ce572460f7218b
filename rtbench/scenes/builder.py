"""Host-side scene assembly, frozen for the benchmark: meshes + transforms
-> a world-space Geometry.

A copy of ``vk_raytrace_torch/models/builder.py`` with its three native host
builders (``csrc/native.cpp``: smooth normals, octahedral encoding, RGBA8
packing) written out in numpy, operation for operation, so that the tables
are byte-identical to the port's (``rtbench/tests/test_rtbench_scenes.py``).
"""

from __future__ import annotations

import numpy as np

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
            normals = smooth_normals(positions, indices)
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
            normals=oct_encode(np.concatenate(self._nrm)),
            tangents=oct_encode(tan[:, :3]),
            tangent_handedness=np.concatenate(self._hand),
            uv=np.concatenate(self._uv),
            color=pack_rgba8(np.concatenate(self._col)),
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


def smooth_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals in float64: each triangle's cross product
    added to its three vertices in triangle order, then normalised ((0, 0,
    1) below a length of 1e-20)."""
    pos = np.asarray(positions, np.float64)
    idx = np.asarray(indices, np.int64)
    pa, pb, pc = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    e1, e2 = pb - pa, pc - pa
    n = np.stack([
        e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
        e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
        e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0],
    ], axis=1)
    out = np.zeros_like(pos)
    # np.add.at adds in index order: vertex a, b, c of triangle 0, then 1, ...
    np.add.at(out, idx.reshape(-1), np.repeat(n, 3, axis=0))
    length = np.sqrt(out[:, 0] * out[:, 0] + out[:, 1] * out[:, 1] + out[:, 2] * out[:, 2])
    small = length < 1e-20
    out = out / np.where(small, 1.0, length)[:, None]
    out[small] = (0.0, 0.0, 1.0)
    return out


def oct_encode(vecs: np.ndarray) -> np.ndarray:
    """Octahedral compression of unit vectors (n, 3) -> (n,) u32: 2x16-bit
    snorm in float32, round-half-even, the lower hemisphere folded in
    integer space."""
    v = np.ascontiguousarray(vecs, np.float32)
    ax, ay, az = np.abs(v[:, 0]), np.abs(v[:, 1]), np.abs(v[:, 2])
    with np.errstate(divide="ignore", invalid="ignore"):
        d = np.float32(32767.0) / ((ax + ay) + az)
        x = np.rint(v[:, 0] * d).astype(np.int64).astype(np.int32)
        y = np.rint(v[:, 1] * d).astype(np.int64).astype(np.int32)
    neg = v[:, 2] < 0.0
    mx, my = x >> 31, y >> 31
    tmp = 32767 + mx + my
    fx = (tmp - (y ^ my)) ^ mx
    fy = (tmp - (x ^ mx)) ^ my
    x = np.where(neg, fx, x)
    y = np.where(neg, fy, y)
    packed = ((y + 32767).astype(np.uint32) << np.uint32(16)) | (x + 32767).astype(np.uint32)
    return np.where(packed == 0xFFFFFFFF, np.uint32(0xFFFFFFFE), packed).astype(np.uint32)


def pack_rgba8(colors: np.ndarray) -> np.ndarray:
    """(n, 4) f32 in [0, 1] -> (n,) u32 RGBA8, each channel clamped and
    rounded half away from zero."""
    c = np.clip(np.ascontiguousarray(colors, np.float32), 0.0, 1.0) * np.float32(255.0)
    q = np.floor(c.astype(np.float64) + 0.5).astype(np.uint32)
    return (q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16) | (q[:, 3] << 24)).astype(np.uint32)
