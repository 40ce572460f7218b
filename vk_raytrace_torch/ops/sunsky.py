"""Procedural sun & sky (counterpart of ``vk_raytrace_tpu/ops/sunsky.py``).

Preetham-style analytic sky (``shaders/sun_and_sky.glsl``) evaluated over a
direction batch. The production path bakes it once into a lat-long map
without the sub-texel disk core (:func:`bake_environment`, ``disk=False``)
and adds the core back per ray with :func:`sun_disk_radiance`.
``SunSky`` fields are 0-d / (3,) float tensors on the batch's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .math import luminance, normalize, smoothstep

M_PI = math.pi


def _square_to_disk(x, y):
    """Concentric square->disk map (sun_and_sky.glsl:74-115), numpy scalars."""
    lx = 2.0 * x - 1.0
    ly = 2.0 * y - 1.0
    safe_lx = np.where(lx == 0.0, 1.0, lx)
    safe_ly = np.where(ly == 0.0, 1.0, ly)
    r1, p1 = lx, (np.pi / 4.0) * (1.0 + ly / safe_lx)
    r2, p2 = ly, (np.pi / 4.0) * (3.0 - lx / safe_ly)
    r3, p3 = -lx, (np.pi / 4.0) * (5.0 + ly / safe_lx)
    r4, p4 = -ly, (np.pi / 4.0) * (7.0 - lx / safe_ly)
    c1, c2, c3 = lx > -ly, lx > ly, lx < ly
    r = np.where(c1, np.where(c2, r1, r2), np.where(c3, r3, r4))
    p = np.where(c1, np.where(c2, p1, p2), np.where(c3, p3, p4))
    zero = (lx == 0.0) & (ly == 0.0)
    return np.where(zero, 0.0, r), np.where(zero, 0.0, p)


def _irrad_directions() -> np.ndarray:
    """The fixed 5x5 hemisphere directions of calc_irrad (:277-286)."""
    dirs = []
    u = 1.0 / 10.0
    while u < 1.0:
        v = 1.0 / 10.0
        while v < 1.0:
            r, phi = _square_to_disk(np.float64(u), np.float64(v))
            x = r * np.cos(phi)
            y = r * np.sin(phi)
            z2 = 1.0 - x * x - y * y
            dirs.append([x, y, np.sqrt(z2) if z2 > 0 else 0.0])
            v += 1.0 / 5.0
        u += 1.0 / 5.0
    return np.asarray(dirs)


_IRRAD_DIRS = _irrad_directions()


def _f(values, like):
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def _sun_color(sun_dir, turbidity):
    """Spectral sun attenuation (sun_and_sky.glsl:141-164), z-up frame."""
    ko = _f([12.0, 8.5, 0.9], sun_dir)
    wavelength = _f([0.610, 0.550, 0.470], sun_dir)
    sol_rad = _f(
        [1.0 * 127500 / 0.9878, 0.992 * 127500 / 0.9878, 0.911 * 127500 / 0.9878],
        sun_dir,
    )
    z = sun_dir[..., 2]
    zc = torch.clamp(z, 1e-4, 1.0)
    m = 1.0 / (
        zc + 0.15 * torch.pow(
            torch.clamp(93.885 - torch.acos(zc) * 180.0 / M_PI, min=1e-3), -1.253
        )
    )
    beta = 0.04608 * turbidity - 0.04586
    ta = torch.exp(-m[..., None] * beta[..., None] * torch.pow(wavelength, -1.3))
    to = torch.exp(-m[..., None] * ko * 0.0035)
    tr = torch.exp(-m[..., None] * 0.008735 * torch.pow(wavelength, -4.08))
    color = tr * ta * to * sol_rad
    return torch.where((z > 0.0)[..., None], color, 0.0)


def _perez(cos_theta, gamma, cos_gamma, cos_theta_sun, theta_sun, a, b, c, d, e):
    num = (1.0 + a * torch.exp(b / torch.clamp(cos_theta, min=1e-4))) * (
        1.0 + c * torch.exp(d * gamma) + e * cos_gamma * cos_gamma
    )
    den = (1.0 + a * torch.exp(b)) * (
        1.0 + c * torch.exp(d * theta_sun) + e * cos_theta_sun * cos_theta_sun
    )
    return num / den


def _sky_luminance(direction, sun_pos, turbidity):
    """(sun_and_sky.glsl:224-250)"""
    cos_gamma = torch.clamp(torch.sum(sun_pos * direction, dim=-1), min=0.0)
    cos_gamma = torch.where(cos_gamma > 1.0, 2.0 - cos_gamma, cos_gamma)
    gamma = torch.acos(torch.clamp(cos_gamma, -1.0, 1.0))
    cos_theta = direction[..., 2]
    cos_theta_sun = sun_pos[..., 2]
    theta_sun = torch.acos(torch.clamp(cos_theta_sun, -1.0, 1.0))
    t = turbidity
    return _perez(
        cos_theta, gamma, cos_gamma, cos_theta_sun, theta_sun,
        0.178721 * t - 1.463037, -0.355402 * t + 0.427494,
        -0.022669 * t + 5.325056, 0.120647 * t - 2.577052,
        -0.066967 * t + 0.370275,
    )


def _sky_color_xyz(direction, sun_pos, turbidity, lum):
    """(sun_and_sky.glsl:167-221)"""
    cos_gamma = torch.sum(sun_pos * direction, dim=-1)
    cos_gamma = torch.where(cos_gamma > 1.0, 2.0 - cos_gamma, cos_gamma)
    gamma = torch.acos(torch.clamp(cos_gamma, -1.0, 1.0))
    cos_theta = direction[..., 2]
    cos_theta_sun = sun_pos[..., 2]
    theta_sun = torch.acos(torch.clamp(cos_theta_sun, -1.0, 1.0))
    t = turbidity
    t2 = t * t
    ts = theta_sun
    ts2 = ts * ts
    ts3 = ts2 * ts
    zenith_x = (
        (0.001650 * ts3 - 0.003742 * ts2 + 0.002088 * ts + 0.0) * t2
        + (-0.029028 * ts3 + 0.063773 * ts2 - 0.032020 * ts + 0.003948) * t
        + (0.116936 * ts3 - 0.211960 * ts2 + 0.060523 * ts + 0.258852)
    )
    zenith_y = (
        (0.002759 * ts3 - 0.006105 * ts2 + 0.003162 * ts + 0.0) * t2
        + (-0.042149 * ts3 + 0.089701 * ts2 - 0.041536 * ts + 0.005158) * t
        + (0.153467 * ts3 - 0.267568 * ts2 + 0.066698 * ts + 0.266881)
    )
    perez = lambda a, b, c, d, e: _perez(
        cos_theta, gamma, cos_gamma, cos_theta_sun, theta_sun, a, b, c, d, e
    )
    x = perez(
        -0.019257 * t - (0.29 - torch.sqrt(torch.clamp(cos_theta_sun, min=0.0)) * 0.09),
        -0.066513 * t + 0.000818, -0.000417 * t + 0.212479,
        -0.064097 * t - 0.898875, -0.003251 * t + 0.045178,
    )
    y = perez(
        -0.016698 * t - 0.260787, -0.094958 * t + 0.009213,
        -0.007928 * t + 0.210230, -0.044050 * t - 1.653694,
        -0.010922 * t + 0.052919,
    )
    x = zenith_x * x
    y = zenith_y * y
    y_safe = torch.clamp(y, min=1e-6)
    return torch.stack([(x / y_safe) * lum, lum * torch.ones_like(x), ((1.0 - x - y) / y_safe) * lum], dim=-1)


def _env_color(sun_dir, direction, turbidity):
    """Sky radiance for a direction (sun_and_sky.glsl:253-267)."""
    theta_sun = torch.acos(torch.clamp(sun_dir[..., 2], -1.0, 1.0))
    chi = (4.0 / 9.0 - turbidity / 120.0) * (M_PI - 2.0 * theta_sun)
    lum = 1000.0 * ((4.0453 * turbidity - 4.9710) * torch.tan(chi) - 0.2155 * turbidity + 2.4192)
    lum = lum * _sky_luminance(direction, sun_dir, turbidity)
    xyz = _sky_color_xyz(direction, sun_dir, turbidity, lum)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    rgb = torch.stack(
        [
            3.241 * x - 1.537 * y - 0.499 * z,
            -0.969 * x + 1.876 * y + 0.042 * z,
            0.056 * x - 0.204 * y + 1.057 * z,
        ],
        dim=-1,
    )
    return rgb * M_PI


def _calc_irrad(sun_dir, turbidity):
    """Hemisphere irradiance estimate (sun_and_sky.glsl:269-289)."""
    dirs = torch.tensor(_IRRAD_DIRS, dtype=torch.float32, device=sun_dir.device)
    cols = _env_color(sun_dir[..., None, :], dirs, turbidity[..., None])
    return torch.mean(cols, dim=-2)


def _tweak_saturation(saturation, haze):
    """(sun_and_sky.glsl:292-308)"""
    lowsat = torch.pow(torch.clamp(saturation, min=0.0), 3.0)
    lh = torch.clamp((haze - 2.0) / 15.0, 0.0, 1.0) ** 3
    mixed = saturation * (1.0 - lh) + lowsat * lh
    return torch.where(saturation <= 1.0, mixed, torch.ones_like(mixed))


def _vector_tweak(d, y_is_up, horiz_height):
    """Swap to z-up and bend for horizon height (sun_and_sky.glsl:311-324)."""
    d_sw = torch.stack([d[..., 0], d[..., 2], d[..., 1]], dim=-1)
    d = torch.where(y_is_up == 1, d_sw, d)
    dz = d[..., 2] - horiz_height
    bent = normalize(torch.stack([d[..., 0], d[..., 1], dz], dim=-1))
    return torch.where(horiz_height != 0.0, bent, d)


def _color_tweak(tint, saturation, redness):
    """(sun_and_sky.glsl:327-356)"""
    inten = luminance(tint)[..., None]
    desat = tint * saturation + inten * (1.0 - saturation)
    out = torch.where(saturation <= 0.0, inten * torch.ones_like(tint), desat)
    return out * torch.stack([1.0 + redness, torch.ones_like(redness), 1.0 - redness], dim=-1)


def _night_adjustment(sun_dir):
    """(sun_and_sky.glsl:441-450)"""
    lmt = 0.30901699437494742
    f = torch.clamp((sun_dir[..., 2] + lmt) / lmt, min=0.0)
    f = f * f
    f = f * f
    return torch.where(sun_dir[..., 2] <= -lmt, torch.zeros_like(f), f)


def _physical_scale(sun_disk_scale, sun_glow_intensity, sun_disk_intensity):
    """(sun_and_sky.glsl:359-438). Returns (disk_scale, glow_scale)."""
    sun_disk_radius = 0.00465 * sun_disk_scale
    r = sun_disk_radius * 10.0
    glow_integral = sun_glow_intensity * (
        (4.0 * M_PI) - (24.0 * M_PI) / (r * r) + (24.0 * M_PI) * torch.sin(r) / (r * r * r)
    )
    target = sun_disk_intensity * M_PI
    max_glow = 0.5 * target
    over = glow_integral > max_glow
    glow_scale = torch.where(
        over, max_glow / torch.clamp(glow_integral, min=1e-12), torch.ones_like(max_glow)
    )
    target = torch.where(over, target - max_glow, target - glow_integral)
    area = 2.0 * M_PI * (1.0 - torch.cos(sun_disk_radius))
    target_intensity = target / torch.clamp(area, min=1e-12)
    actual_intensity = sun_disk_intensity * 100.0
    disk_scale = torch.where(
        target_intensity == 0.0,
        torch.zeros_like(target_intensity),
        target_intensity / torch.clamp(actual_intensity, min=1e-12),
    )
    return disk_scale, glow_scale


def _rgb_scale(ss):
    return torch.where(
        luminance(ss.rgb_unit_conversion) < 0.0,
        torch.full_like(ss.rgb_unit_conversion, 1.0 / 80000.0),
        ss.rgb_unit_conversion,
    ) * ss.multiplier


def _with_z_floor(d):
    return normalize(torch.cat([d[..., :2], torch.clamp(d[..., 2:3], min=0.001)], dim=-1))


def bake_environment(ss, height: int = 512, width: int = 1024, disk: bool = True):
    """Evaluate the sky into an (H, W, 3) lat-long map on ``ss``'s device,
    on the grid of ``GetSphericalUv``."""
    dev = ss.multiplier.device
    us = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width
    vs = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) / height
    theta = (us - 0.5) * (2.0 * M_PI)
    gamma = (vs - 0.5) * M_PI
    cg = torch.cos(gamma)[:, None]
    y = -torch.sin(gamma)[:, None] * torch.ones((1, width), device=dev)
    x = cg * torch.cos(theta)[None, :]
    z = cg * torch.sin(theta)[None, :]
    dirs = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    out = sun_and_sky(ss, dirs, disk=disk).reshape(height, width, 3)
    return torch.clamp(out, min=0.0)


def sun_and_sky(ss, direction, disk: bool = True):
    """Sky radiance along ``direction`` (..., 3) (sun_and_sky.glsl:453-601);
    ``disk=False`` drops only the hard disk core term."""
    horiz_height = ss.horizon_height / 10.0
    d = _vector_tweak(direction, ss.y_is_up, horiz_height)
    local_haze = torch.clamp(2.0 + ss.haze, min=2.0)
    local_sat = _tweak_saturation(ss.saturation, local_haze)
    rgb_scale = _rgb_scale(ss)

    downness = d[..., 2]
    real_dir = d
    d_up = _with_z_floor(d)

    sun_dir0 = _vector_tweak(normalize(ss.sun_direction), ss.y_is_up, horiz_height)
    factor = torch.where(
        sun_dir0[..., 2] < 0.0, _night_adjustment(sun_dir0), torch.ones_like(sun_dir0[..., 2])
    )
    real_sun = sun_dir0
    sun_dir = _with_z_floor(sun_dir0)

    tint = _env_color(sun_dir, d_up, local_haze) * torch.clamp(factor, max=1.0)[..., None]
    tint = torch.where((factor > 0.0)[..., None], tint, 0.0)

    sun_color = _sun_color(sun_dir, torch.where(downness > 0.0, local_haze, 2.0))

    cosang = torch.clamp(torch.sum(real_dir * real_sun, dim=-1), -1.0, 1.0)
    sun_angle = torch.acos(cosang)
    sun_radius = 0.00465 * ss.sun_disk_scale * 10.0
    in_disk = (sun_angle < sun_radius) & (ss.sun_disk_intensity > 0.0) & (ss.sun_disk_scale > 0.0)
    disk_scale, glow_scale = _physical_scale(
        ss.sun_disk_scale, ss.sun_glow_intensity, ss.sun_disk_intensity
    )
    one = torch.ones_like(disk_scale)
    disk_scale = torch.where(ss.physically_scaled_sun == 1, disk_scale, one)
    glow_scale = torch.where(ss.physically_scaled_sun == 1, glow_scale, one)
    sf = (1.0 - sun_angle / torch.clamp(sun_radius, min=1e-9)) * 10.0
    sun_factor = (
        torch.pow(torch.clamp(sf, min=0.0) / 10.0, 3.0) * 2.0 * ss.sun_glow_intensity * glow_scale
    )
    if disk:
        sun_factor = sun_factor + (
            smoothstep(8.5, 9.5 + local_haze / 50.0, sf)
            * 100.0 * ss.sun_disk_intensity * disk_scale
        )
    tint = tint + torch.where(in_disk[..., None], sun_color * sun_factor[..., None], 0.0)
    out_color = tint * rgb_scale

    # Ground hemisphere
    irrad = _calc_irrad(sun_dir, torch.full_like(local_haze, 2.0))
    downcolor = ss.ground_color * (irrad + sun_color * sun_dir[..., 2:3]) * rgb_scale
    downcolor = downcolor * torch.clamp(factor, max=1.0)

    hor_blur = ss.horizon_blur / 10.0
    dness = torch.clamp(-downness / torch.clamp(hor_blur, min=1e-9), 0.0, 1.0)
    dness = smoothstep(0.0, 1.0, dness)
    below = downness <= 0.0
    blended = out_color * (1.0 - dness[..., None]) + downcolor * dness[..., None]
    night_factor = torch.where(
        below,
        torch.where(hor_blur > 0.0, 1.0 - dness, torch.zeros_like(dness)),
        torch.ones_like(dness),
    )
    out_color = torch.where(
        below[..., None],
        torch.where(hor_blur > 0.0, blended, downcolor),
        out_color,
    )
    out_color = _color_tweak(out_color, local_sat, ss.redblueshift)
    night = ss.night_color * night_factor[..., None]
    result = torch.maximum(out_color, torch.where(night_factor[..., None] > 0.0, night, 0.0))
    result = result * M_PI
    return torch.where(ss.multiplier <= 0.0, torch.zeros_like(result), result)


def sun_disk_radiance(ss, direction):
    """The exact term dropped by ``sun_and_sky(..., disk=False)``: the disk
    core (sun_and_sky.glsl:543-548), horizon-blended and color-tweaked."""
    horiz_height = ss.horizon_height / 10.0
    d = _vector_tweak(direction, ss.y_is_up, horiz_height)
    local_haze = torch.clamp(2.0 + ss.haze, min=2.0)
    local_sat = _tweak_saturation(ss.saturation, local_haze)
    rgb_scale = _rgb_scale(ss)

    downness = d[..., 2]
    sun_dir0 = _vector_tweak(normalize(ss.sun_direction), ss.y_is_up, horiz_height)
    cosang = torch.clamp(torch.sum(d * sun_dir0, dim=-1), -1.0, 1.0)
    sun_angle = torch.acos(cosang)
    sun_radius = 0.00465 * ss.sun_disk_scale * 10.0
    in_disk = (
        (sun_angle < sun_radius)
        & (ss.sun_disk_intensity > 0.0)
        & (ss.sun_disk_scale > 0.0)
    )
    disk_scale, _ = _physical_scale(
        ss.sun_disk_scale, ss.sun_glow_intensity, ss.sun_disk_intensity
    )
    disk_scale = torch.where(
        ss.physically_scaled_sun == 1, disk_scale, torch.ones_like(disk_scale)
    )
    sf = (1.0 - sun_angle / torch.clamp(sun_radius, min=1e-9)) * 10.0
    disk_term = (
        smoothstep(8.5, 9.5 + local_haze / 50.0, sf)
        * 100.0 * ss.sun_disk_intensity * disk_scale
    )
    sun_color = _sun_color(
        _with_z_floor(sun_dir0), torch.where(downness > 0.0, local_haze, 2.0)
    )
    delta = torch.where(in_disk[..., None], sun_color * disk_term[..., None], 0.0)
    delta = delta * rgb_scale

    hor_blur = ss.horizon_blur / 10.0
    dness = smoothstep(
        0.0, 1.0, torch.clamp(-downness / torch.clamp(hor_blur, min=1e-9), 0.0, 1.0)
    )
    h_scale = torch.where(
        downness <= 0.0,
        torch.where(hor_blur > 0.0, 1.0 - dness, torch.zeros_like(dness)),
        torch.ones_like(dness),
    )
    delta = delta * h_scale[..., None]
    delta = _color_tweak(delta, local_sat, ss.redblueshift)
    delta = delta * M_PI
    return torch.where(ss.multiplier <= 0.0, torch.zeros_like(delta), delta)


def sun_disk_cone(ss):
    """Sampling cone of the analytic disk: ``(present, axis, cos_theta)``."""
    axis = normalize(ss.sun_direction)
    theta = 0.15 * (0.00465 * ss.sun_disk_scale * 10.0) * 1.25
    cos_theta = torch.cos(torch.clamp(theta, max=M_PI))
    present = (
        (ss.multiplier > 0.0)
        & (ss.sun_disk_intensity > 0.0)
        & (ss.sun_disk_scale > 0.0)
    )
    return present, axis, cos_theta
