"""Hemisphere and GGX samplers (counterpart of ``vk_raytrace_tpu/ops/sampling.py``).

Each takes uniform variates ``r1, r2`` and returns tangent-space directions
(z = normal).
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def cosine_sample_hemisphere(r1, r2):
    """Cosine-weighted hemisphere (pbr_disney.glsl:190-200)."""
    r = torch.sqrt(r1)
    phi = TWO_PI * r2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
    return torch.stack([x, y, z], dim=-1)


def ggx_sample(alpha, r1, r2):
    """GGX half-vector sample (pbr_gltf.glsl:189-199)."""
    a = torch.clamp(alpha, min=0.001)
    phi = r1 * TWO_PI
    cos_theta = torch.sqrt((1.0 - r2) / (1.0 + (a * a - 1.0) * r2))
    sin_theta = torch.clamp(torch.sqrt(1.0 - cos_theta * cos_theta), 0.0, 1.0)
    return torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], dim=-1
    )
