"""Tonemapping + post chain (counterpart of ``vk_raytrace_tpu/ops/tonemap.py``;
``shaders/post.frag`` with the curves of ``shaders/tonemapping.glsl``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import rng
from .math import linear_to_srgb, srgb_to_linear

TM_UNCHARTED = 0
TM_HEJLRICHARD = 1
TM_ACES = 2
TM_LINEAR = 3

_RGB2Y = (0.2126, 0.7152, 0.0722)
_XYZ_Y = (0.2126729, 0.7151522, 0.0721750)  # Y row of RGB->XYZ (post.frag:56)


def _wsum(c, wts):
    return c[..., 0] * wts[0] + c[..., 1] * wts[1] + c[..., 2] * wts[2]


def _uncharted2_impl(c):
    a, b, cc, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((c * (a * c + cc * b) + d * e) / (c * (a * c + b) + d * f)) - e / f


def tone_map(color, exposure, mode: int = TM_UNCHARTED):
    """``toneMap`` (tonemapping.glsl:88-105)."""
    color = color * exposure
    if mode == TM_UNCHARTED:
        white = _uncharted2_impl(torch.full((3,), 11.2, device=color.device))
        return linear_to_srgb(_uncharted2_impl(color * 2.0) * (1.0 / white))
    if mode == TM_HEJLRICHARD:
        c = torch.clamp(color - 0.004, min=0.0)
        return (c * (6.2 * c + 0.5)) / (c * (6.2 * c + 1.7) + 0.06)
    if mode == TM_ACES:
        a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
        return linear_to_srgb(
            torch.clamp((color * (a * color + b)) / (color * (c * color + d) + e), 0.0, 1.0)
        )
    return linear_to_srgb(color)


def tone_exposure(rgb, log_avg_lum, key, ywhite):
    """Global photographic exposure (post.frag:62-70)."""
    yc = _wsum(rgb, _XYZ_Y)
    y = (key / torch.clamp(log_avg_lum, min=1e-9)) * yc
    yd = (y * (1.0 + y / (ywhite * ywhite))) / (1.0 + y)
    return rgb * (yd / torch.clamp(yc, min=1e-9))[..., None]


def luminance_pyramid(rgb, levels: int = 8):
    """Luminance mip chain, each level linearly upsampled back to full size."""
    lum = _wsum(rgb, _RGB2Y)
    h, w = lum.shape
    out = [lum]
    cur = lum[None, None]
    for _ in range(1, levels):
        nh, nw = max(1, cur.shape[2] // 2), max(1, cur.shape[3] // 2)
        cur = F.interpolate(cur, size=(nh, nw), mode="bilinear", antialias=True, align_corners=False)
        out.append(F.interpolate(cur, size=(h, w), mode="bilinear", align_corners=False)[0, 0])
    return out


def tone_local_exposure(rgb, log_avg_lum, key, ywhite, mips):
    """Local-adaptation exposure (post.frag:72-95)."""
    epsilon, phi = 0.05, 2.0
    yc = _wsum(rgb, _XYZ_Y)
    factor = key / torch.clamp(log_avg_lum, min=1e-9)
    y = factor * yc
    v = [m * factor for m in mips]
    la = v[7]
    for i in reversed(range(7)):
        scale = float(1 << i)
        denom = (key * (2.0 ** phi) / (scale * scale)) + v[i]
        la = torch.where(torch.abs(v[i] - v[i + 1]) / denom > epsilon, v[i], la)
    return rgb * ((y / (1.0 + la)) / torch.clamp(yc, min=1e-9))[..., None]


def _dither(linear_color, noise, quant):
    """(post.frag:46-54)"""
    c0 = torch.floor(linear_to_srgb(linear_color) / quant) * quant
    c1 = c0 + quant
    discr = srgb_to_linear(c0) + (srgb_to_linear(c1) - srgb_to_linear(c0)) * noise
    return torch.where(discr < linear_color, c1, c0)


def apply_post(hdr, tm, mode: int = TM_UNCHARTED):
    """Full post chain of ``post.frag:98-147``; (H, W, 3) in [0, 1].
    ``tm`` fields are tensors on ``hdr``'s device."""
    h, w = hdr.shape[0], hdr.shape[1]
    dev = hdr.device
    rgb = hdr
    auto = int(tm.auto_exposure)
    if auto & 1:
        avg_lum2 = _wsum(torch.mean(rgb.reshape(-1, 3), dim=0), _RGB2Y)
        if auto & 2:
            rgb = tone_local_exposure(rgb, avg_lum2, tm.key, tm.ywhite, luminance_pyramid(rgb))
        else:
            rgb = tone_exposure(rgb, avg_lum2, tm.key, tm.ywhite)
    color = tone_map(rgb, tm.avg_lum, mode)

    yy = torch.arange(h, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, device=dev)[None, :].expand(h, w)
    if int(tm.dither) > 0:
        r3 = rng.pcg3d(torch.stack([xx, yy, torch.zeros_like(xx)], dim=-1))
        color = _dither(srgb_to_linear(color), rng.bits_to_unit_float(r3), 1.0 / 255.0)

    color = torch.clamp(0.5 + (color - 0.5) * tm.contrast, 0.0, 1.0)
    color = torch.pow(torch.clamp(color, min=0.0), 1.0 / tm.brightness)
    grey = _wsum(color, (0.299, 0.587, 0.114))[..., None]
    color = grey + (color - grey) * tm.saturation
    uv = torch.stack([(xx.float() + 0.5) / w, (yy.float() + 0.5) / h], dim=-1) * tm.rendering_ratio
    duv = (uv - 0.5) * 2.0
    vig = 1.0 - torch.sum(duv * duv, dim=-1) * tm.vignette
    return torch.clamp(color * vig[..., None], 0.0, 1.0)
