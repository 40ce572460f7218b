"""Hemisphere, sphere, GGX and GTR samplers (counterpart of
``vk_raytrace_tpu/ops/sampling.py``).

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


def uniform_sample_hemisphere(r1, r2):
    """Uniform hemisphere (pbr_disney.glsl:204-210)."""
    r = torch.sqrt(torch.clamp(1.0 - r1 * r1, min=0.0))
    phi = TWO_PI * r2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), r1], dim=-1)


def uniform_sample_sphere(r1, r2):
    """Uniform sphere (pbr_disney.glsl:214-221)."""
    z = 1.0 - 2.0 * r1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * r2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def ggx_sample(alpha, r1, r2):
    """GGX half-vector sample (pbr_gltf.glsl:189-199)."""
    a = torch.clamp(alpha, min=0.001)
    phi = r1 * TWO_PI
    cos_theta = torch.sqrt((1.0 - r2) / (1.0 + (a * a - 1.0) * r2))
    sin_theta = torch.clamp(torch.sqrt(1.0 - cos_theta * cos_theta), 0.0, 1.0)
    return torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], dim=-1
    )


def gtr1_sample(alpha, r1, r2):
    """GTR1 (clearcoat) half-vector sample (pbr_disney.glsl:68-81); like the
    reference, ``r1`` drives both phi and the cos-theta term."""
    a = torch.clamp(alpha, min=0.001)
    a2 = a * a
    phi = r1 * TWO_PI
    cos_theta = torch.sqrt((1.0 - torch.pow(a2, 1.0 - r1)) / (1.0 - a2))
    sin_theta = torch.clamp(torch.sqrt(1.0 - cos_theta * cos_theta), 0.0, 1.0)
    return torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], dim=-1
    )


def gtr2_aniso_sample(ax, ay, r1, r2):
    """Anisotropic GTR2 half-vector sample (pbr_disney.glsl:85-94),
    unnormalized (the caller normalizes the world-space vector)."""
    phi = r1 * TWO_PI
    sin_phi = ay * torch.sin(phi)
    cos_phi = ax * torch.cos(phi)
    tan_theta = torch.sqrt(r2 / torch.clamp(1.0 - r2, min=1e-12))
    return torch.stack([tan_theta * cos_phi, tan_theta * sin_phi, torch.ones_like(phi)], dim=-1)
