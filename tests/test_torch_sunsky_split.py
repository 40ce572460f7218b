"""The sun disk's constants split (``ops/sunsky.py``): ``sun_disk_consts``
once per scene, ``sun_disk_at`` per direction. On the CPU the split gives
the same bits as the formulas it replaced, kept here as the oracle
(``_before_*``, the port's code before the split), on random directions and
directions near the sun, for skies that take each branch: y up or z up,
a horizon height, a physically scaled disk, haze, saturation at and below
zero, redness, horizon blur, a dark sky. Also the packing of the constants
and of the light rows that the stage kernel reads (``csrc/shade.cu`` enums
SunLane and LightLane).
"""

import dataclasses
import math
import os
import re

import numpy as np
import pytest
import torch

from vk_raytrace_torch import cuda_build
from vk_raytrace_torch import render as R
from vk_raytrace_torch.integrator import shade_fused as sf
from vk_raytrace_torch.models.hdr import build_environment
from vk_raytrace_torch.models.schema import default_sun_sky
from vk_raytrace_torch.ops import env as penv
from vk_raytrace_torch.ops import sunsky
from vk_raytrace_torch.ops.math import make_coordinate_system, normalize, smoothstep, spherical_uv
from vk_raytrace_torch.ops.sunsky import (
    _color_tweak, _physical_scale, _rgb_scale, _sun_color, _tweak_saturation, _vector_tweak,
    _with_z_floor,
)

M_PI = math.pi


def _before_sun_disk_radiance(ss, direction):
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
    in_disk = (sun_angle < sun_radius) & (ss.sun_disk_intensity > 0.0) & (ss.sun_disk_scale > 0.0)
    disk_scale, _ = _physical_scale(ss.sun_disk_scale, ss.sun_glow_intensity,
                                    ss.sun_disk_intensity)
    disk_scale = torch.where(ss.physically_scaled_sun == 1, disk_scale, torch.ones_like(disk_scale))
    sf_ = (1.0 - sun_angle / torch.clamp(sun_radius, min=1e-9)) * 10.0
    disk_term = (smoothstep(8.5, 9.5 + local_haze / 50.0, sf_)
                 * 100.0 * ss.sun_disk_intensity * disk_scale)
    sun_color = _sun_color(_with_z_floor(sun_dir0), torch.where(downness > 0.0, local_haze, 2.0))
    delta = torch.where(in_disk[..., None], sun_color * disk_term[..., None], 0.0)
    delta = delta * rgb_scale
    hor_blur = ss.horizon_blur / 10.0
    dness = smoothstep(0.0, 1.0, torch.clamp(-downness / torch.clamp(hor_blur, min=1e-9), 0.0, 1.0))
    h_scale = torch.where(downness <= 0.0,
                          torch.where(hor_blur > 0.0, 1.0 - dness, torch.zeros_like(dness)),
                          torch.ones_like(dness))
    delta = delta * h_scale[..., None]
    delta = _color_tweak(delta, local_sat, ss.redblueshift)
    delta = delta * M_PI
    return torch.where(ss.multiplier <= 0.0, torch.zeros_like(delta), delta)


def _before_cone(ss):
    axis = normalize(ss.sun_direction)
    theta = 0.15 * (0.00465 * ss.sun_disk_scale * 10.0) * 1.25
    cos_theta = torch.cos(torch.clamp(theta, max=M_PI))
    present = (ss.multiplier > 0.0) & (ss.sun_disk_intensity > 0.0) & (ss.sun_disk_scale > 0.0)
    return present, axis, cos_theta


def _before_cone_pdf(ss, direction):
    present, axis, cos_theta = _before_cone(ss)
    q = torch.where(present, 0.5, 0.0)
    solid_angle = 2.0 * M_PI * torch.clamp(1.0 - cos_theta, min=1e-12)
    inside = torch.sum(direction * axis, dim=-1) >= cos_theta - 1e-6
    return q, torch.where(inside, 1.0 / solid_angle, 0.0)


def _before_environment_pdf(env, direction, ss=None, sun_disk=False):
    h, w = env.image.shape[0], env.image.shape[1]
    uv = spherical_uv(direction)
    x = torch.clamp((uv[..., 0] * w).long(), 0, w - 1)
    y = torch.clamp((uv[..., 1] * h).long(), 0, h - 1)
    pdf = env.rows[y * w + x, 14]
    if sun_disk:
        q, p_cone = _before_cone_pdf(ss, direction)
        pdf = (1.0 - q) * pdf + q * p_cone
    return pdf


def _before_sample_env_mixture(env, ss, u_mix, xi):
    a_rad, a_dir, a_pdf = penv.environment_sample(env, xi)
    present, axis, cos_theta = _before_cone(ss)
    q = torch.where(present, 0.5, 0.0)
    cz = 1.0 - xi[..., 1] * (1.0 - cos_theta)
    sz = torch.sqrt(torch.clamp(1.0 - cz * cz, min=0.0))
    phi = xi[..., 2] * (2.0 * M_PI)
    t, b = make_coordinate_system(axis.expand(xi.shape[:-1] + (3,)))
    c_dir = normalize(t * (sz * torch.cos(phi))[..., None] + b * (sz * torch.sin(phi))[..., None]
                      + axis * cz[..., None])
    take_cone = u_mix < q
    direction = torch.where(take_cone[..., None], c_dir, a_dir)
    _, p_cone_at = _before_cone_pdf(ss, direction)
    p_alias_at = torch.where(take_cone, _before_environment_pdf(env, c_dir), a_pdf)
    pdf = (1.0 - q) * p_alias_at + q * p_cone_at
    c_rad = penv._bilinear_packed(env.rows, env.image.shape[0], env.image.shape[1],
                                  spherical_uv(c_dir))
    radiance = torch.where(take_cone[..., None], c_rad, a_rad)
    return radiance + _before_sun_disk_radiance(ss, direction), direction, pdf


def _t(x, dtype=torch.float32):
    return torch.tensor(x, dtype=dtype)


SKIES = {
    "default": {},
    "z_up_horizon": dict(y_is_up=_t(0, torch.int64), horizon_height=_t(0.5)),
    "physical_hazy": dict(physically_scaled_sun=_t(1, torch.int64), haze=_t(3.0),
                          saturation=_t(0.5), redblueshift=_t(0.2), horizon_blur=_t(0.3)),
    "grey_big_disk": dict(saturation=_t(-0.5), sun_disk_scale=_t(4.0), horizon_blur=_t(0.0)),
    "dark": dict(multiplier=_t(0.0)),
}


def _sky(name):
    ss = default_sun_sky(True).to("cpu")
    return dataclasses.replace(ss, **SKIES[name])


def _directions(ss, n, seed):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3))
    axis = normalize(ss.sun_direction).numpy()
    k = n // 2
    d[:k] = axis + rng.normal(0.0, 0.02, (k, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.tensor(d, dtype=torch.float32)


@pytest.fixture(scope="module")
def env():
    y = np.linspace(0.2, 1.5, 16)[:, None, None] * np.linspace(0.5, 1.0, 32)[None, :, None]
    img = torch.tensor(y * np.array([1.0, 0.9, 0.7]), dtype=torch.float32)
    return R.with_env_rows(build_environment(img)).to("cpu")


@pytest.mark.parametrize("n", [7, 4099])
@pytest.mark.parametrize("sky", list(SKIES))
def test_disk_radiance_split_is_bit_exact(sky, n):
    ss = _sky(sky)
    d = _directions(ss, n, seed=n)
    before = _before_sun_disk_radiance(ss, d)
    assert torch.equal(sunsky.sun_disk_radiance(ss, d), before)
    sd = sunsky.sun_disk_consts(ss)
    assert torch.equal(sunsky.sun_disk_at(sd, d), before)
    if sky == "default":
        assert (before > 0).any(), "no direction inside the disk"


@pytest.mark.parametrize("sky", list(SKIES))
def test_env_mixture_split_is_bit_exact(env, sky):
    ss = _sky(sky)
    rng = np.random.default_rng(3)
    n = 4099
    xi = torch.tensor(rng.random((n, 3)), dtype=torch.float32)
    u_mix = torch.tensor(rng.random(n), dtype=torch.float32)
    before = _before_sample_env_mixture(env, ss, u_mix, xi)
    sd = sunsky.sun_disk_consts(ss)
    after = penv.sample_env_mixture(env, sd, u_mix, xi)
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    assert torch.equal(penv.environment_pdf(env, before[1], sd),
                       _before_environment_pdf(env, before[1], ss, True))
    assert torch.equal(penv.env_radiance(env, sd, 1.5, before[1]),
                       (penv._bilinear_packed(env.rows, 16, 32, spherical_uv(before[1]))
                        + _before_sun_disk_radiance(ss, before[1])) * 1.5)


def _enum(name):
    with open(os.path.join(cuda_build.CSRC, "shade.cu")) as f:
        body = re.search(r"enum %s \{(.*?)\};" % name, f.read(), re.S).group(1)
    return [int(v) for v in re.findall(r"k\w+ = (\d+)", body)]


def test_sun_lanes_match_the_kernel():
    """The kernel's SunLane offsets are the SunDisk fields' in order; the
    packed vector holds each field's values there."""
    sd = sunsky.sun_disk_consts(_sky("physical_hazy"))
    sizes = [x.numel() for x in sd]
    offsets = list(np.cumsum([0] + sizes))
    assert _enum("SunLane") == offsets
    lanes = sf.sun_lanes(sd)
    assert lanes.shape == (sf.SUN_LANES,) == (offsets[-1],)
    for x, o in zip(sd, offsets):
        assert torch.equal(lanes[o:o + x.numel()], x.float().reshape(-1))


def test_light_rows_match_the_kernel():
    from vk_raytrace_torch.models import procedural

    lights = procedural.atrium_scene(bays_x=2, bays_z=2, column_segments=16, column_rows=12)[2]
    lights = lights.to("cpu")
    rows = sf.light_rows(lights)
    pos, ldir, color, inten, rng_, inner, outer, typ, width = _enum("LightLane")
    assert rows.shape == (lights.type.shape[0], width)
    assert torch.equal(rows[:, pos:pos + 3], lights.position)
    assert torch.equal(rows[:, ldir:ldir + 3], lights.direction)
    assert torch.equal(rows[:, color:color + 3], lights.color)
    for k, x in ((inten, lights.intensity), (rng_, lights.range), (inner, lights.inner_cone_cos),
                 (outer, lights.outer_cone_cos), (typ, lights.type.float())):
        assert torch.equal(rows[:, k], x.float())
