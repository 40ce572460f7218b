"""Frozen copy of ``vk_raytrace_torch/ops/math.py`` for the benchmark's reference.

Shared vector math (counterpart of ``vk_raytrace_tpu/ops/math.py``).

Functions take float32 tensors with arbitrary leading batch shape; integer
bit tricks use int32/int64 tensors.
"""

from __future__ import annotations

import math

import torch


def normalize(v: torch.Tensor) -> torch.Tensor:
    """L2-normalize over the last axis (GLSL ``normalize``)."""
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def dot3(a, b):
    """Dot product over the last axis of 3, summed x, y, z in that order on
    every device (a reduction's order is not fixed on the card); on the CPU
    it equals ``dot``."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def normalize3(v: torch.Tensor) -> torch.Tensor:
    """``normalize`` with the sum of :func:`dot3`."""
    return v / torch.sqrt(dot3(v, v))[..., None]


def cross(a, b):
    return torch.cross(a, b, dim=-1)


def luminance(rgb):
    """CIE luminance (sun_and_sky.glsl:31-34)."""
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def firefly_luminance(rgb):
    """Luminance weights of the firefly clamp (pathtrace.glsl:380)."""
    return 0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1] + 0.072169 * rgb[..., 2]


def spherical_uv(v: torch.Tensor) -> torch.Tensor:
    """Direction -> lat-long UV (``GetSphericalUv``, common.glsl:67-74)."""
    gamma = torch.asin(-torch.clamp(v[..., 1], -1.0, 1.0))
    theta = torch.atan2(v[..., 2], v[..., 0])
    u = theta * (0.5 / math.pi) + 0.5
    w = gamma / math.pi + 0.5
    return torch.stack([u, w], dim=-1)


def make_coordinate_system(n: torch.Tensor):
    """Tangent/bitangent for normal ``n`` (common.glsl:80-92)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    big_z = torch.abs(nz) > 0.99999
    t = torch.where(
        big_z[..., None],
        torch.stack([-nx * ny, 1.0 - ny * ny, -ny * nz], dim=-1),
        torch.stack([-nx * nz, -ny * nz, 1.0 - nz * nz], dim=-1),
    )
    t = normalize(t)
    return t, cross(t, n)


def smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def power_heuristic(a, b):
    """MIS power heuristic, beta = 2."""
    t = a * a
    return t / (b * b + t)


def mat3_vec(m, v):
    """The 3x3 block of ``m`` (R, 3, 3 or 4) times ``v`` (R, 3), summed over
    j = 0, 1, 2 in that order: out_i = m_i0 v_0 + m_i1 v_1 + m_i2 v_2."""
    return m[:, :, 0] * v[:, 0:1] + m[:, :, 1] * v[:, 1:2] + m[:, :, 2] * v[:, 2:3]


def mat3t_vec(m, v):
    """The transposed 3x3 block of ``m`` times ``v``: out_j = m_0j v_0 +
    m_1j v_1 + m_2j v_2 (normals through the inverse transpose)."""
    return m[:, 0, 0:3] * v[:, 0:1] + m[:, 1, 0:3] * v[:, 1:2] + m[:, 2, 0:3] * v[:, 2:3]
