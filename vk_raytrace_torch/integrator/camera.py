"""Camera rays with subpixel jitter and thin-lens depth of field
(counterpart of ``vk_raytrace_tpu/integrator/camera.py``;
``samplePixel``'s ray setup, pathtrace.glsl:348-374)."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops import rng
from ..ops.math import normalize

TWO_PI = 2.0 * math.pi


def with_aspect(cam, width: int, height: int):
    """Re-derive the projection's x scale for the render aspect ratio
    (host numpy): ``proj_inverse[0,0] = aspect * |proj_inverse[1,1]|``."""
    pi = np.array(np.asarray(cam.proj_inverse), np.float32)
    pi[0, 0] = (width / height) * abs(float(pi[1, 1]))
    return dataclasses.replace(cam, proj_inverse=pi)


def generate_rays_for_pixels(cam, width: int, height: int, pix, frame: int, seed):
    """Primary rays for flat row-major pixel ids ``pix`` (int64). Frame 0
    shoots through pixel centers. Returns ``(origin, direction, seed')``."""
    px = (pix % width).float()
    py = (pix // width).float()
    seed, jit = rng.rand2(seed)
    if frame == 0:
        jit = torch.full_like(jit, 0.5)
    u = (px + jit[..., 0]) / width * 2.0 - 1.0
    v = (py + jit[..., 1]) / height * 2.0 - 1.0

    vi, pinv = cam.view_inverse, cam.proj_inverse
    ones = torch.ones_like(u)
    ndc = torch.stack([u, v, ones, ones], dim=-1)
    # target = proj_inverse @ ndc, written out per row (no matmul kernels)
    target = torch.stack(
        [
            pinv[k, 0] * ndc[:, 0] + pinv[k, 1] * ndc[:, 1]
            + pinv[k, 2] * ndc[:, 2] + pinv[k, 3] * ndc[:, 3]
            for k in range(3)
        ],
        dim=-1,
    )
    tdir = normalize(target)
    direction = torch.stack(
        [vi[k, 0] * tdir[:, 0] + vi[k, 1] * tdir[:, 1] + vi[k, 2] * tdir[:, 2] for k in range(3)],
        dim=-1,
    )

    seed, r1 = rng.rand(seed)
    seed, r2 = rng.rand(seed)
    focal_point = cam.focal_dist * direction
    ang = r1 * TWO_PI
    rad = r2 * cam.aperture
    aperture_pos = (
        torch.cos(ang)[..., None] * vi[:3, 0] + torch.sin(ang)[..., None] * vi[:3, 1]
    ) * torch.sqrt(rad)[..., None]
    direction = normalize(focal_point - aperture_pos)
    origin = vi[:3, 3] + aperture_pos
    return origin, direction, seed
