"""HDR environments (counterpart of ``vk_raytrace_tpu/models/hdr.py``):
Radiance ``.hdr`` (RGBE) decoding in numpy, the analytic test sky, and the
importance sampling tables, built with torch on the env image's device.

The Walker alias table is the reference's parallel cascade: each round
routes every still-unaliased below-average texel's deficit into the
cumulative-excess intervals of the above-average texels (prefix sums +
``searchsorted``) and repeats with the over-consumed ones; 8 rounds leave
the sampled distribution at numerical-noise distance from the target.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .schema import EnvAccel, Environment


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 RGBE -> (..., 3) float32."""
    rgbe = rgbe.astype(np.int32)
    e = rgbe[..., 3]
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)  # 2^(e-128-8)
    return (rgbe[..., :3].astype(np.float32) * scale[..., None]).astype(np.float32)


def load_hdr(path: str) -> np.ndarray:
    """Decode a Radiance .hdr file (flat or new-RLE scanlines, ``-Y h +X
    w``) to (H, W, 3) float32 linear radiance, in numpy."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise IOError("not a radiance file")
    # The header ends at a blank line; then the resolution line.
    pos = data.index(b"\n\n") + 2
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise IOError(f"unsupported resolution line: {res!r}")
    h, w = int(res[1]), int(res[3])
    buf = np.frombuffer(data[eol + 1:], np.uint8)
    out = np.empty((h, w, 4), np.uint8)
    ptr = 0
    for y in range(h):
        if w < 8 or w > 0x7FFF or buf[ptr] != 2 or buf[ptr + 1] != 2:
            # A flat scanline: w RGBE pixels as they are.
            out[y] = buf[ptr:ptr + w * 4].reshape(w, 4)
            ptr += w * 4
            continue
        if (int(buf[ptr + 2]) << 8 | int(buf[ptr + 3])) != w:
            raise IOError("scanline width mismatch")
        ptr += 4
        for c in range(4):
            x = 0
            while x < w:
                count = int(buf[ptr])
                ptr += 1
                if count > 128:  # a run
                    out[y, x:x + count - 128, c] = buf[ptr]
                    ptr += 1
                    x += count - 128
                else:  # literals
                    out[y, x:x + count, c] = buf[ptr:ptr + count]
                    ptr += count
                    x += count
    return _rgbe_to_float(out)


def procedural_sky_hdr(h: int = 64, w: int = 128, sun_dir=(0.3, 0.8, 0.5)) -> np.ndarray:
    """Small analytic gradient + sun HDR (H, W, 3) float32, for scenes
    without an environment file."""
    ys = (np.arange(h) + 0.5) / h
    xs = (np.arange(w) + 0.5) / w
    theta = ys * np.pi
    phi = xs * 2 * np.pi - np.pi
    dy = np.cos(theta)[:, None] * np.ones((1, w))
    dx = np.cos(phi)[None, :] * np.sin(theta)[:, None]
    dz = np.sin(phi)[None, :] * np.sin(theta)[:, None]
    d = np.stack([dx, dy, dz], -1)
    sd = np.asarray(sun_dir, np.float64)
    sd /= np.linalg.norm(sd)
    cosg = np.clip((d * sd).sum(-1), -1, 1)
    horizon = np.clip(dy * 0.5 + 0.5, 0, 1)
    sky = (
        np.stack([0.35, 0.5, 0.85], 0)[None, None] * horizon[..., None]
        + np.stack([0.9, 0.7, 0.5], 0)[None, None] * (1 - horizon[..., None]) * 0.4
    )
    sun = np.exp((cosg - 1.0) * 600.0)[..., None] * np.array([500.0, 450.0, 380.0])
    return (sky + sun).astype(np.float32)


_ALIAS_ROUNDS = 8


def build_alias_table(importance: torch.Tensor):
    """Walker alias table from unnormalized weights (N,): ``(q, alias,
    integral)`` with the semantics of ``HdrSampling::buildAliasmap``, on
    the device of ``importance``. It is built on the CPU and then moved
    there: on CUDA, torch's float32 ``cumsum`` and ``index_add_`` with
    repeated targets add in no fixed order, and the table is chaotic under
    ulp changes, so two builds of one environment on the card gave other
    tables (and images); the CPU's order is fixed."""
    dev = importance.device
    q, alias, total = _alias_table(importance.cpu())
    return q.to(dev), alias.to(dev), total.to(dev)


def _alias_table(importance: torch.Tensor):
    """:func:`build_alias_table` on ``importance``'s own device."""
    n = importance.shape[0]
    dev = importance.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    total = torch.sum(importance)
    q = importance * (n / torch.clamp(total, min=1e-30))
    alias = idx
    big = torch.tensor(3e38, dtype=torch.float32, device=dev)
    for _ in range(_ALIAS_ROUNDS):
        small = (q < 1.0) & (alias == idx)
        large = q >= 1.0
        any_pair = torch.any(small) & torch.any(large)

        deficit = torch.where(small, 1.0 - q, 0.0)
        d_before = torch.cumsum(deficit, 0) - deficit
        excess = torch.where(large, q - 1.0, 0.0)
        cum_excess = torch.cumsum(excess, 0)
        large_rank = torch.cumsum(large.long(), 0) - 1
        n_large = torch.clamp(torch.sum(large.long()), min=1)
        perm = torch.argsort(torch.where(large, large_rank, n + 1), stable=True)
        ce_compact = torch.where(large, cum_excess, big)[perm]
        large_ids = idx[perm]

        j = torch.searchsorted(ce_compact, d_before, right=True)
        j = torch.minimum(torch.clamp(j, min=0), n_large - 1)
        target = large_ids[j]
        route = small & any_pair
        new_alias = torch.where(route, target, alias)
        routed = torch.zeros(n + 1, dtype=q.dtype, device=dev).index_add_(
            0, torch.where(route, target, n), torch.where(route, deficit, 0.0)
        )[:n]
        q = q - routed
        alias = new_alias
    return q.float(), alias, total


def pack_env_rows(img: torch.Tensor, accel: EnvAccel) -> torch.Tensor:
    """(H*W, 16) per-texel rows: [self rgb | right | down | diag | q,
    alias, pdf, alias_pdf], U wrapping and V clamping."""
    h, w = img.shape[0], img.shape[1]
    right = torch.roll(img, -1, dims=1)
    down = torch.cat([img[1:], img[-1:]], dim=0)
    diag = torch.roll(down, -1, dims=1)
    n = h * w
    return torch.cat(
        [
            img.reshape(n, 3), right.reshape(n, 3),
            down.reshape(n, 3), diag.reshape(n, 3),
            accel.q[:, None], accel.alias.float()[:, None],
            accel.pdf[:, None], accel.alias_pdf[:, None],
        ],
        dim=1,
    )


def build_environment(image) -> Environment:
    """Importance + alias table + pdfs (``createEnvironmentAccel``,
    hdr_sampling.cpp:190-248) of an (H, W, 3) image, a numpy array or a
    tensor (built on its device)."""
    img = torch.as_tensor(image).float()
    h, w = img.shape[0], img.shape[1]
    ys = torch.arange(h, dtype=torch.float32, device=img.device)
    step_theta = math.pi / h
    step_phi = 2.0 * math.pi / w
    area = (torch.cos(ys * step_theta) - torch.cos((ys + 1.0) * step_theta)) * step_phi
    max_ch = torch.amax(img, dim=-1)
    importance = (max_ch * area[:, None]).reshape(-1)
    lum = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
    average = torch.mean(lum)

    q, alias, integral = build_alias_table(importance)
    pdf = max_ch.reshape(-1) / torch.clamp(integral, min=1e-30)
    accel = EnvAccel(alias=alias, q=q, pdf=pdf, alias_pdf=pdf[alias])
    assert h * w < 2**23, "env too large for exact-f32 alias ids"
    return Environment(
        image=img, accel=accel, integral=integral, average=average,
        rows=pack_env_rows(img, accel),
    )
