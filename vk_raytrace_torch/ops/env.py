"""Environment-light sampling (counterpart of ``vk_raytrace_tpu/ops/env.py``;
``Environment_sample`` / ``EnvSample`` of ``shaders/env_sampling.glsl``).

The environment is always a baked lat-long map with packed per-texel rows
(``render.with_env_rows``); the sun&sky path adds ``sun_disk=True``: the
baked, disk-less sky is alias-sampled, the analytic sun disk is a uniform
cone, and NEE draws from their 50/50 mixture with the mixture density.
"""

from __future__ import annotations

import math

import torch

from . import rng
from .math import make_coordinate_system, normalize, spherical_uv
from .sunsky import sun_disk_cone, sun_disk_radiance

M_PI = math.pi


def environment_sample(env, xi):
    """Alias-method sample of the lat-long map (env_sampling.glsl:38-99):
    ``(radiance, dir, pdf)``, radiance without the hdr multiplier."""
    h, w = env.image.shape[0], env.image.shape[1]
    size = h * w
    idx = torch.clamp((xi[..., 0] * size).long(), max=size - 1)
    arow = env.rows[idx]
    q = arow[..., 12]
    alias = arow[..., 13].long()
    take_self = xi[..., 1] < q
    env_idx = torch.where(take_self, idx, alias)
    xi_y = torch.where(
        take_self,
        xi[..., 1] / torch.clamp(q, min=1e-12),
        (xi[..., 1] - q) / torch.clamp(1.0 - q, min=1e-12),
    )
    pdf = torch.where(take_self, arow[..., 14], arow[..., 15])
    px = (env_idx % w).float()
    py = (env_idx // w).float()
    u = (px + xi_y) / w
    phi = u * (2.0 * M_PI) - M_PI
    step_theta = M_PI / h
    theta0 = py * step_theta
    cos_theta = torch.cos(theta0) * (1.0 - xi[..., 2]) + torch.cos(theta0 + step_theta) * xi[..., 2]
    theta = torch.acos(torch.clamp(cos_theta, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    v = theta * (1.0 / M_PI)
    direction = torch.stack(
        [torch.cos(phi) * sin_theta, cos_theta, torch.sin(phi) * sin_theta], dim=-1
    )
    radiance = _bilinear_packed(env.rows, h, w, torch.stack([u, v], dim=-1))
    return radiance, direction, pdf


def _cone_pdf(sun_sky, direction):
    """(q, p_cone(direction)) of the sun-cone half of the NEE mixture."""
    present, axis, cos_theta = sun_disk_cone(sun_sky)
    q = torch.where(present, 0.5, 0.0)
    solid_angle = 2.0 * M_PI * torch.clamp(1.0 - cos_theta, min=1e-12)
    inside = torch.sum(direction * axis, dim=-1) >= cos_theta - 1e-6
    return q, torch.where(inside, 1.0 / solid_angle, 0.0)


def environment_pdf(env, direction, sun_sky=None, sun_disk: bool = False):
    """Density of the env NEE strategy at ``direction`` (per steradian)."""
    h, w = env.image.shape[0], env.image.shape[1]
    uv = spherical_uv(direction)
    x = torch.clamp((uv[..., 0] * w).long(), 0, w - 1)
    y = torch.clamp((uv[..., 1] * h).long(), 0, h - 1)
    pdf = env.rows[y * w + x, 14]
    if sun_disk:
        q, p_cone = _cone_pdf(sun_sky, direction)
        pdf = (1.0 - q) * pdf + q * p_cone
    return pdf


def sample_env_mixture(env, sun_sky, u_mix, xi):
    """Sun-disk NEE mixture with pre-drawn variates: ``(radiance, dir,
    pdf)``, radiance the total env (baked + analytic disk)."""
    a_rad, a_dir, a_pdf = environment_sample(env, xi)
    present, axis, cos_theta = sun_disk_cone(sun_sky)
    q = torch.where(present, 0.5, 0.0)
    cz = 1.0 - xi[..., 1] * (1.0 - cos_theta)
    sz = torch.sqrt(torch.clamp(1.0 - cz * cz, min=0.0))
    phi = xi[..., 2] * (2.0 * M_PI)
    t, b = make_coordinate_system(axis.expand(xi.shape[:-1] + (3,)))
    c_dir = normalize(
        t * (sz * torch.cos(phi))[..., None]
        + b * (sz * torch.sin(phi))[..., None]
        + axis * cz[..., None]
    )
    take_cone = u_mix < q
    direction = torch.where(take_cone[..., None], c_dir, a_dir)
    _, p_cone_at = _cone_pdf(sun_sky, direction)
    p_alias_at = torch.where(take_cone, environment_pdf(env, c_dir), a_pdf)
    pdf = (1.0 - q) * p_alias_at + q * p_cone_at
    c_rad = _bilinear_packed(env.rows, env.image.shape[0], env.image.shape[1], spherical_uv(c_dir))
    radiance = torch.where(take_cone[..., None], c_rad, a_rad)
    return radiance + sun_disk_radiance(sun_sky, direction), direction, pdf


def env_sample(env, sun_sky, hdr_multiplier: float, seed, sun_disk: bool = False):
    """``EnvSample`` (env_sampling.glsl:105-135): ``(radiance, dir, pdf, seed')``."""
    if sun_disk:
        seed, u_mix = rng.rand(seed)
        seed, xi = rng.rand3(seed)
        radiance, direction, pdf = sample_env_mixture(env, sun_sky, u_mix, xi)
    else:
        seed, xi = rng.rand3(seed)
        radiance, direction, pdf = environment_sample(env, xi)
    return radiance * hdr_multiplier, direction, pdf, seed


def _bilinear_packed(rows, h: int, w: int, uv):
    """Bilinear env tap from the packed per-texel rows (one gather; U wraps,
    V clamps — matches ``sample_env``)."""
    px = uv[..., 0] * w - 0.5
    py = uv[..., 1] * h - 0.5
    x0 = torch.floor(px).long()
    y0 = torch.floor(py).long()
    fx = (px - x0.float())[..., None]
    fy = (py - y0.float())[..., None]
    row = rows[torch.clamp(y0, 0, h - 1) * w + torch.remainder(x0, w)]
    c00, c10 = row[..., 0:3], row[..., 3:6]
    c01, c11 = row[..., 6:9], row[..., 9:12]
    fy = torch.where((y0 < 0)[..., None], 0.0, fy)
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy


def env_radiance(env, sun_sky, hdr_multiplier: float, direction, sun_disk: bool = False):
    """Environment radiance along a miss direction (pathtrace.glsl:218-227)."""
    e = _bilinear_packed(env.rows, env.image.shape[0], env.image.shape[1], spherical_uv(direction))
    if sun_disk:
        e = e + sun_disk_radiance(sun_sky, direction)
    return e * hdr_multiplier
