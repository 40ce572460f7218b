"""Atlas texture helpers (counterpart of ``vk_raytrace_tpu/ops/texture.py``).

Host side (numpy): the mip-strip layout, the 2x2 box downsample and the
per-texel footprint rows. Device side (torch): the per-texture wrap modes,
the plain bilinear atlas tap (the transmission and clearcoat textures read
it) and the plain bilinear tap of the lat-long environment (the reference
that the packed env rows of ``ops/env.py`` reproduce).
"""

from __future__ import annotations

import numpy as np
import torch

WRAP_REPEAT = 0
WRAP_CLAMP = 1
WRAP_MIRROR = 2


def n_mip_levels(w0, h0):
    """Levels above the base: floor(log2(min(w0, h0)))."""
    m = np.minimum(np.asarray(w0), np.asarray(h0)).astype(np.int64)
    return np.where(m > 0, np.floor(np.log2(np.maximum(m, 1))), 0).astype(np.int32)


def downsample_2x2(img: np.ndarray) -> np.ndarray:
    """One mip step: 2x2 box average (rounded), edge clamp on odd dims."""
    h, w = img.shape[:2]
    h2, w2 = max(h // 2, 1), max(w // 2, 1)
    a = img.astype(np.uint16)
    x0 = np.minimum(np.arange(w2) * 2, w - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    y0 = np.minimum(np.arange(h2) * 2, h - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    s = (
        a[y0][:, x0].astype(np.uint32) + a[y0][:, x1]
        + a[y1][:, x0] + a[y1][:, x1]
    )
    return ((s + 2) // 4).astype(np.uint8)


def build_tap_rows(atlas) -> np.ndarray:
    """(H*W, 4) u32: row ``y*W + x`` holds the RGBA8 words [c00, c10, c01,
    c11] of the bilinear footprint based at texel (x, y), the +1 neighbours
    wrapped per texture (REPEAT: modulo; CLAMP and MIRROR: clamp), for the
    base level and every mip level."""
    data = np.asarray(atlas.data)
    h_a, w_a = data.shape[:2]
    u32 = (
        data[..., 0].astype(np.uint32)
        | (data[..., 1].astype(np.uint32) << 8)
        | (data[..., 2].astype(np.uint32) << 16)
        | (data[..., 3].astype(np.uint32) << 24)
    )
    rows = np.zeros((h_a * w_a, 4), np.uint32)

    def neighbor(i, size, mode):
        if mode == WRAP_REPEAT:
            return (i + 1) % size
        return np.minimum(i + 1, size - 1)

    def fill_rect(ox, oy, w, h, ws_mode, wt_mode):
        xs = np.arange(w)
        ys = np.arange(h)
        nx = neighbor(xs, w, ws_mode)
        ny = neighbor(ys, h, wt_mode)
        sub = u32[oy : oy + h, ox : ox + w]
        flat = ((oy + ys)[:, None] * w_a + (ox + xs)[None, :]).ravel()
        rows[flat, 0] = sub.ravel()
        rows[flat, 1] = sub[:, nx].ravel()
        rows[flat, 2] = sub[ny, :].ravel()
        rows[flat, 3] = sub[ny][:, nx].ravel()

    xs_t, ys_t = np.asarray(atlas.x), np.asarray(atlas.y)
    ws_t, hs_t = np.asarray(atlas.width), np.asarray(atlas.height)
    wraps, wrapt = np.asarray(atlas.wrap_s), np.asarray(atlas.wrap_t)
    mx_t = np.asarray(atlas.mip_x) if atlas.mip_x is not None else None
    my_t = np.asarray(atlas.mip_y) if atlas.mip_y is not None else None
    for t in range(len(xs_t)):
        ox, oy = int(xs_t[t]), int(ys_t[t])
        w, h = int(ws_t[t]), int(hs_t[t])
        if w <= 0 or h <= 0:
            continue
        fill_rect(ox, oy, w, h, int(wraps[t]), int(wrapt[t]))
        if mx_t is not None and mx_t[t] >= 0:
            for lvl in range(1, int(n_mip_levels(w, h)) + 1):
                lx = int(mx_t[t]) + w - (w >> (lvl - 1))
                lw, lh = max(w >> lvl, 1), max(h >> lvl, 1)
                fill_rect(lx, int(my_t[t]), lw, lh, int(wraps[t]), int(wrapt[t]))
    return rows


def _wrap(coord, size, mode):
    """Per-texture wrap mode (REPEAT / CLAMP / MIRROR) on integer texel
    coords; ``size`` >= 1 (int tensors)."""
    rep = torch.remainder(coord, size)
    clm = torch.minimum(torch.clamp(coord, min=0), size - 1)
    period = 2 * size
    m = torch.remainder(coord, period)
    mir = torch.where(m >= size, period - 1 - m, m)
    return torch.where(mode == WRAP_REPEAT, rep, torch.where(mode == WRAP_CLAMP, clm, mir))


def sample_atlas(atlas, tex_id, uv):
    """Bilinear RGBA fetch of texture ``tex_id`` (...,) at ``uv`` (..., 2)
    from the atlas: (..., 4) raw values in [0, 1]; ids < 0 give white."""
    tid = torch.clamp(tex_id, 0, atlas.x.shape[0] - 1)
    w = torch.clamp(atlas.width[tid], min=1)
    h = torch.clamp(atlas.height[tid], min=1)
    ox, oy = atlas.x[tid], atlas.y[tid]
    ws, wt = atlas.wrap_s[tid], atlas.wrap_t[tid]
    px = uv[..., 0] * atlas.width[tid].float() - 0.5
    py = uv[..., 1] * atlas.height[tid].float() - 0.5
    x0 = torch.floor(px).long()
    y0 = torch.floor(py).long()
    fx = (px - x0.float())[..., None]
    fy = (py - y0.float())[..., None]
    aw = atlas.data.shape[1]
    flat = atlas.data.reshape(-1, 4)

    def tap(xi, yi):
        texel = flat[(_wrap(yi, h, wt) + oy) * aw + _wrap(xi, w, ws) + ox]
        return texel.float() * (1.0 / 255.0)

    c00, c10 = tap(x0, y0), tap(x0 + 1, y0)
    c01, c11 = tap(x0, y0 + 1), tap(x0 + 1, y0 + 1)
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    out = top + (bot - top) * fy
    return torch.where((tex_id < 0)[..., None], torch.ones_like(out), out)


def sample_env(image, uv):
    """Bilinear fetch from the lat-long env map: U wraps, V clamps."""
    h, w = image.shape[0], image.shape[1]
    px = uv[..., 0] * w - 0.5
    py = uv[..., 1] * h - 0.5
    x0 = torch.floor(px).long()
    y0 = torch.floor(py).long()
    fx = (px - x0.float())[..., None]
    fy = (py - y0.float())[..., None]
    flat = image.reshape(-1, image.shape[-1])

    def tap(xi, yi):
        return flat[torch.clamp(yi, 0, h - 1) * w + torch.remainder(xi, w)]

    c00, c10 = tap(x0, y0), tap(x0 + 1, y0)
    c01, c11 = tap(x0, y0 + 1), tap(x0 + 1, y0 + 1)
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy
