"""The environment's importance table, frozen for the benchmark's reference:
a copy of ``build_environment`` and its alias table from
``vk_raytrace_torch/models/hdr.py`` (built on the CPU, where the order of
every sum is fixed), with plain containers in place of the port's table
classes.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch


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


def pack_env_rows(img: torch.Tensor, accel) -> torch.Tensor:
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


def build_environment(image):
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
    accel = SimpleNamespace(alias=alias, q=q, pdf=pdf, alias_pdf=pdf[alias])
    assert h * w < 2**23, "env too large for exact-f32 alias ids"
    return SimpleNamespace(
        image=img, accel=accel, integral=integral, average=average,
        rows=pack_env_rows(img, accel),
    )

