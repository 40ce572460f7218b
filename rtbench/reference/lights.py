"""Frozen copy of ``vk_raytrace_torch/ops/lights.py`` for the benchmark's reference.

Punctual lights (counterpart of ``vk_raytrace_tpu/ops/lights.py``;
``shaders/punctual.glsl`` and the light half of ``DirectLight``)."""

from __future__ import annotations

import torch

from ..scenes.schema import LIGHT_DIRECTIONAL, LIGHT_SPOT
from .vecmath import dot3, normalize3, smoothstep


def range_attenuation(light_range, distance):
    """(punctual.glsl:28-36): unlimited when range <= 0."""
    d2 = torch.clamp(distance * distance, min=1e-12)
    win = torch.clamp(1.0 - (distance / torch.clamp(light_range, min=1e-9)) ** 4, 0.0, 1.0)
    return torch.where(light_range <= 0.0, 1.0 / d2, win / d2)


def spot_attenuation(point_to_light, spot_direction, outer_cone_cos, inner_cone_cos):
    """(punctual.glsl:39-51)"""
    actual_cos = dot3(normalize3(spot_direction), normalize3(-point_to_light))
    ramp = smoothstep(outer_cone_cos, inner_cone_cos, actual_cos)
    full = torch.where(actual_cos < inner_cone_cos, ramp, 1.0)
    return torch.where(actual_cos > outer_cone_cos, full, 0.0)


def sample_light(lights, light_index, position):
    """One punctual light toward each shading point (pathtrace.glsl:119-152):
    ``(intensity (R,3), light_dir (R,3), light_dist (R,))``, pdf 1. Sums
    over x, y, z run in that order, as ``csrc/shade.cu`` sums."""
    i = light_index
    ltype = lights.type[i]
    is_dir = ltype == LIGHT_DIRECTIONAL
    ldirection = lights.direction[i]
    point_to_light = torch.where(is_dir[..., None], -ldirection, lights.position[i] - position)
    light_dist = torch.sqrt(torch.clamp(dot3(point_to_light, point_to_light), min=1e-20))
    light_dist = torch.where(is_dir, 1e32, light_dist)
    r_att = torch.where(is_dir, 1.0, range_attenuation(lights.range[i], light_dist))
    s_att = torch.where(
        ltype == LIGHT_SPOT,
        spot_attenuation(point_to_light, ldirection, lights.outer_cone_cos[i], lights.inner_cone_cos[i]),
        1.0,
    )
    intensity = (r_att * s_att * lights.intensity[i])[..., None] * lights.color[i]
    return intensity, normalize3(point_to_light), light_dist
