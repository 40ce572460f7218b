"""Alpha-tested surfaces by candidate rounds (counterpart of
``vk_raytrace_tpu/ops/traverse_alpha.py``).

Each round traverses the alpha tree in candidate mode (kernel mode c) over
the window ``(t_lo, t_limit)``, stochastically tests the one nearest
candidate per ray, and advances ``t_lo`` just past rejected candidates.
Testing candidates in t order is distribution-identical to testing them in
encounter order. Rays are compacted to the live set before every round.
"""

from __future__ import annotations

import torch

from ..models.schema import ALPHA_MASK
from . import rng
from .texture import _wrap
from .traverse_fused import INF, Hit, candidate_hit_fused, root_prefilter

_MAX_ROUNDS = 24          # bound on rejected candidates along one ray
_ADV_REL = 1e-4           # window advance past a rejected candidate
_ADV_ABS = 1e-5


def _alpha_accept(pack, tri, uvu, uvv, seed, cand):
    """One stochastic alpha test per candidate ray; a random number is drawn
    only on candidate rays. Returns ``(passed, seed')``."""
    arow = pack.rows[torch.clamp(tri, 0, pack.rows.shape[0] - 1)]
    ut = uvu * arow[:, 4] + uvv * arow[:, 6] + arow[:, 8]
    vt = uvu * arow[:, 5] + uvv * arow[:, 7] + arow[:, 9]
    tw = torch.clamp(arow[:, 12].long(), min=1)
    th = torch.clamp(arow[:, 13].long(), min=1)
    xi = torch.floor(ut * tw.float()).long()
    yi = torch.floor(vt * th.float()).long()

    xw = _wrap(xi, tw, arow[:, 14].long()) + arow[:, 10].long()
    yw = _wrap(yi, th, arow[:, 15].long()) + arow[:, 11].long()
    flat = torch.clamp(yw * pack.atlas_width + xw, 0, pack.alpha_plane.shape[0] - 1)
    texel_a = pack.alpha_plane[flat].float() * (1.0 / 255.0)
    a = arow[:, 0] * torch.where(arow[:, 3] >= 0.0, texel_a, 1.0)
    is_mask = arow[:, 1] == float(ALPHA_MASK)
    opacity = torch.where(is_mask, (a > arow[:, 2]).float(), a)
    seed2, rnd = rng.rand(seed)
    return rnd <= opacity, torch.where(cand, seed2, seed)


def _rounds_core(planar, pack, origin, direction, t_limit, seed, need, cull):
    """Candidate rounds over a batch whose rays all need testing."""
    r = origin.shape[0]
    dev = origin.device
    t_lo = torch.zeros(r, device=dev)
    bt = torch.full((r,), INF, device=dev)
    btri = torch.full((r,), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros(r, device=dev)
    bv = torch.zeros(r, device=dev)
    steps = torch.zeros(r, dtype=torch.int32, device=dev)
    seed = seed.clone()
    idx = torch.nonzero(need).squeeze(1)
    for _ in range(_MAX_ROUNDS):
        if idx.numel() == 0:
            break
        tl = t_lo[idx]
        d = direction[idx]
        o2 = origin[idx] + d * tl[:, None]
        win = torch.clamp(t_limit[idx] - tl, min=0.0)
        hit, uvu, uvv = candidate_hit_fused(planar, o2, d, win, cull=cull)
        cand = hit.tri >= 0
        if pack is not None:
            passed, s2 = _alpha_accept(pack, hit.tri, uvu, uvv, seed[idx], cand)
            seed[idx] = s2
        else:
            passed = torch.ones_like(cand)
        accept = cand & passed
        t_abs = tl + hit.t
        bt[idx] = torch.where(accept, t_abs, bt[idx])
        btri[idx] = torch.where(accept, hit.tri, btri[idx])
        bu[idx] = torch.where(accept, hit.u, bu[idx])
        bv[idx] = torch.where(accept, hit.v, bv[idx])
        steps[idx] += hit.steps
        again = cand & ~passed
        t_lo[idx] = torch.where(again, t_abs * (1.0 + _ADV_REL) + _ADV_ABS, tl)
        idx = idx[again]
    return bt, btri, bu, bv, seed, steps


def _alpha_rounds(planar, pack, origin, direction, t_limit, seed, active, cull):
    """Rays that can reach the alpha tree within (0, t_limit) — per-child
    root prefilter — run the candidate rounds. Returns ``(Hit, seed')``."""
    r = origin.shape[0]
    if seed is None:
        seed = torch.zeros(r, dtype=torch.int64, device=origin.device)
    need0 = torch.ones(r, dtype=torch.bool, device=origin.device) if active is None else active
    need0 = need0 & (t_limit > 0.0) & root_prefilter(planar, origin, direction, t_limit)
    bt, btri, bu, bv, seed, steps = _rounds_core(
        planar, pack, origin, direction, t_limit, seed, need0, cull
    )
    hit = Hit(t=torch.where(btri >= 0, bt, INF), tri=btri, u=bu, v=bv, steps=steps)
    return hit, seed


def closest_hit_alpha(planar, pack, origin, direction, t_limit, seed=None, active=None):
    """Nearest alpha surface within (0, t_limit) that passes its test."""
    return _alpha_rounds(planar, pack, origin, direction, t_limit, seed, active, cull=True)


def any_hit_alpha(planar, pack, origin, direction, t_max, seed=None, active=None):
    """Shadow-ray occlusion by the alpha set (no culling)."""
    hit, seed = _alpha_rounds(planar, pack, origin, direction, t_max, seed, active, cull=False)
    return hit.tri >= 0, seed
