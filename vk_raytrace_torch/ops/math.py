"""Shared vector math (counterpart of ``vk_raytrace_tpu/ops/math.py``).

Functions take float32 tensors with arbitrary leading batch shape; integer
bit tricks use int32/int64 tensors.
"""

from __future__ import annotations

import math

import torch


def oct_decode(packed: torch.Tensor) -> torch.Tensor:
    """Octahedral uint32 (held in int64, or int32 bit pattern) -> unit
    vectors (..., 3); ``decompress_unit_vec`` (compress.glsl:149-180)."""
    packed = packed.long() & 0xFFFFFFFF
    x = (packed & 0xFFFF) - 32767
    y = (packed >> 16) - 32767
    maskx = -(x < 0).long()
    masky = -(y < 0).long()
    tmp0 = 32767 + maskx + masky
    ymask = y ^ masky
    tmp1 = tmp0 - (x ^ maskx)
    z = tmp1 - ymask
    xf = (tmp0 - ymask) ^ maskx
    yf = tmp1 ^ masky
    neg_z = z < 0
    x = torch.where(neg_z, xf, x)
    y = torch.where(neg_z, yf, y)
    vec = torch.stack([x.float(), y.float(), z.float()], dim=-1) * (1.0 / 32768.0)
    return normalize(vec)


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


def dot(a, b, keepdim: bool = False):
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def cross(a, b):
    return torch.cross(a, b, dim=-1)


def luminance(rgb):
    """CIE luminance (sun_and_sky.glsl:31-34)."""
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def firefly_luminance(rgb):
    """Luminance weights of the firefly clamp (pathtrace.glsl:380)."""
    return 0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1] + 0.072169 * rgb[..., 2]


def offset_ray(p: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Integer-ULP origin offset along ``n`` (common.glsl:98-113)."""
    of_i = (256.0 * n).to(torch.int32)
    p_bits = p.contiguous().view(torch.int32)
    p_i = (p_bits + torch.where(p < 0.0, -of_i, of_i)).view(torch.float32)
    return torch.where(torch.abs(p) < 1.0 / 32.0, p + (1.0 / 65536.0) * n, p_i)


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


def to_local(v, t, b, n):
    """World -> tangent-space components (dot with each basis vector)."""
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], dim=-1)


def from_local(v, t, b, n):
    """Tangent space -> world: ``x*T + y*B + z*N``."""
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def reflect(i, n):
    return i - 2.0 * dot(i, n, keepdim=True) * n


def refract(i, n, eta):
    """GLSL ``refract``; 0-vector on total internal reflection."""
    if eta.dim() and eta.shape[-1] != 1:
        eta = eta[..., None]
    cosi = dot(n, i, keepdim=True)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    out = eta * i - (eta * cosi + torch.sqrt(torch.clamp(k, min=0.0))) * n
    return torch.where(k < 0.0, torch.zeros_like(out), out)


def mix(a, b, t):
    return a + (b - a) * t


def smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def temperature(intensity):
    """Cold-hot heatmap ramp (``temperature``, common.glsl:48-62)."""

    def fade(low, high, value):
        mid = (low + high) * 0.5
        rng = (high - low) * 0.5
        x = 1.0 - torch.clamp(torch.abs(mid - value) / rng, 0.0, 1.0)
        return smoothstep(0.0, 1.0, x)

    def color(rgb):
        return torch.tensor(rgb, dtype=torch.float32, device=intensity.device)

    i = intensity[..., None]
    return (
        fade(-0.25, 0.25, i) * color([0.0, 0.0, 1.0])
        + fade(0.0, 0.5, i) * color([0.0, 1.0, 1.0])
        + fade(0.25, 0.75, i) * color([0.0, 1.0, 0.0])
        + fade(0.5, 1.0, i) * color([1.0, 1.0, 0.0])
        + smoothstep(0.75, 1.0, i) * color([1.0, 0.0, 0.0])
    )


def power_heuristic(a, b):
    """MIS power heuristic, beta = 2."""
    t = a * a
    return t / (b * b + t)


def srgb_to_linear(c):
    return torch.pow(torch.clamp(c, min=0.0), 2.2)


def linear_to_srgb(c):
    return torch.pow(torch.clamp(c, min=0.0), 1.0 / 2.2)


def mat3_vec(m, v):
    """The 3x3 block of ``m`` (R, 3, 3 or 4) times ``v`` (R, 3), summed over
    j = 0, 1, 2 in that order: out_i = m_i0 v_0 + m_i1 v_1 + m_i2 v_2."""
    return m[:, :, 0] * v[:, 0:1] + m[:, :, 1] * v[:, 1:2] + m[:, :, 2] * v[:, 2:3]


def mat3t_vec(m, v):
    """The transposed 3x3 block of ``m`` times ``v``: out_j = m_0j v_0 +
    m_1j v_1 + m_2j v_2 (normals through the inverse transpose)."""
    return m[:, 0, 0:3] * v[:, 0:1] + m[:, 1, 0:3] * v[:, 1:2] + m[:, 2, 0:3] * v[:, 2:3]
