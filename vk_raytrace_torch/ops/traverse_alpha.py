"""Alpha-tested surfaces by candidate rounds (counterpart of
``vk_raytrace_tpu/ops/traverse_alpha.py``).

Each round traverses the alpha tree in candidate mode (kernel mode c) over
the window ``(t_lo, t_limit)``, stochastically tests the one nearest
candidate per ray, and advances ``t_lo`` just past rejected candidates.
Testing candidates in t order is distribution-identical to testing them in
encounter order.

On the card the alpha pass is one launch of ``vkrt_alpha_rounds``
(``csrc/traverse.cu``): persistent warps, in which a lane takes a ray, runs
the pass's need line on it (the reference's root prefilter,
``traverse_fused.alpha_need``), runs its rounds to the end, its state in
registers, and takes a new ray when its ray ends, with no host sync. The
plain versions run the CPU tensors: ``alpha_need``'s, then the round loop
:func:`_rounds_core`, which compacts the rays to the live set before every
round.
"""

from __future__ import annotations

import torch

from ..models.schema import ALPHA_MASK
from . import rng
from . import traverse_fused as tf
from .texture import _wrap
from .traverse_fused import INF, Hit

_MAX_ROUNDS = 24          # bound on rejected candidates along one ray
_ADV_REL = 1e-4           # window advance past a rejected candidate
_ADV_ABS = 1e-5


def _alpha_opacity(pack, tri, uvu, uvv):
    """Opacity of each candidate (triangle ``tri`` at texture uv ``(uvu,
    uvv)``): its alpha factor times the nearest atlas texel's alpha, or the
    mask cutoff's 0 / 1."""
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
    return torch.where(is_mask, (a > arow[:, 2]).float(), a)


def _alpha_accept(pack, tri, uvu, uvv, seed, cand):
    """One stochastic alpha test per candidate ray; a random number is drawn
    only on candidate rays. Returns ``(passed, seed')``."""
    opacity = _alpha_opacity(pack, tri, uvu, uvv)
    seed2, rnd = rng.rand(seed)
    return rnd <= opacity, torch.where(cand, seed2, seed)


def _rounds_core(planar, pack, origin, direction, t_limit, seed, need, cull, trav=tf.traverse,
                 rounds=None):
    """Candidate rounds over a batch whose rays all need testing, as a loop
    of rounds on the live lanes (the plain version of the
    ``vkrt_alpha_rounds`` kernel): each round's candidate traversal is one
    ``trav`` call (``traverse_fused.traverse``: the per-round kernel on CUDA
    tensors, the twin on CPU ones). ``rounds``, an optional (R,) integer
    tensor, counts each ray's rounds."""
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
        if rounds is not None:
            rounds[idx] += 1
        tl = t_lo[idx]
        d = direction[idx]
        o2 = origin[idx] + d * tl[:, None]
        win = torch.clamp(t_limit[idx] - tl, min=0.0)
        t, tri, u, v, hs, uvu, uvv = trav(planar, o2, d, win, None, "candidate", cull)
        cand = tri >= 0
        if pack is not None:
            passed, s2 = _alpha_accept(pack, tri, uvu, uvv, seed[idx], cand)
            seed[idx] = s2
        else:
            passed = torch.ones_like(cand)
        accept = cand & passed
        t_abs = tl + t
        bt[idx] = torch.where(accept, t_abs, bt[idx])
        btri[idx] = torch.where(accept, tri, btri[idx])
        bu[idx] = torch.where(accept, u, bu[idx])
        bv[idx] = torch.where(accept, v, bv[idx])
        steps[idx] += hs
        again = cand & ~passed
        t_lo[idx] = torch.where(again, t_abs * (1.0 + _ADV_REL) + _ADV_ABS, tl)
        idx = idx[again]
    return bt, btri, bu, bv, seed, steps


def _rounds(planar, pack, origin, direction, t_limit, seed, need, cull):
    """The candidate rounds on the rays of ``need`` (the pass's need mask):
    CUDA tensors launch the ``vkrt_alpha_rounds`` kernel with ``need`` as
    its ``active`` (its intake's need line keeps every such ray) or raise,
    CPU tensors run the round loop. Returns ``(t, tri, u, v, seed',
    steps)``, ``t`` ``INF`` where no surface was accepted."""
    if origin.device.type == "cuda":
        return _alpha_rounds_cuda(planar, pack, origin, direction, t_limit, seed, need, cull)
    if origin.device.type != "cpu":
        raise ValueError(f"no alpha rounds for device {origin.device}")
    return _rounds_core(planar, pack, origin, direction, t_limit, seed, need, cull)


def _alpha_rounds_cuda(planar, pack, origin, direction, t_limit, seed, active, cull):
    """One launch of ``vkrt_alpha_rounds``: the pass's need line at each
    ray's intake (``active``, all rays where None; ``t_limit > 0``; a root
    child hit within ``(0, t_limit)``: :func:`traverse_fused.alpha_need`),
    then every needing ray's rounds, to the end or to ``_MAX_ROUNDS``, in
    one lane of a persistent warp (its grid and scratch from
    ``traverse_fused.machine_state``). A ray that needs nothing gets the
    outputs of a masked ray. A need mask given as ``active`` gives the same
    outputs: every ray it holds hits a root child. The cap is each ray's
    own: the loop counts rounds for the whole batch, but a lane that is live
    stays live without a gap until it ends, so its rounds are the batch's."""
    lib = tf._load(planar.width)
    r, dev = origin.shape[0], origin.device
    active = tf._check_rays(lib, planar, origin, direction, t_limit, active)
    tf._check("seed", seed, (r,), torch.int64, dev)
    if pack is not None:
        tf._check("pack rows", pack.rows, (pack.rows.shape[0], 16), torch.float32, dev)
        tf._check("alpha plane", pack.alpha_plane, (pack.alpha_plane.numel(),), torch.uint8, dev)
    f = lambda: torch.empty(r, dtype=torch.float32, device=dev)  # noqa: E731
    t, u, v = f(), f(), f()
    tri = torch.empty(r, dtype=torch.int32, device=dev)
    steps = torch.empty(r, dtype=torch.int32, device=dev)
    seed_out = torch.empty_like(seed)
    if r == 0:  # nothing to launch, and so nothing to count
        return t, tri.long(), u, v, seed_out, steps
    # A null pack: every candidate passes and no seed moves.
    alpha = (None, 0, None, 0, 0) if pack is None else (
        pack.rows.data_ptr(), pack.rows.shape[0], pack.alpha_plane.data_ptr(),
        pack.alpha_plane.numel(), pack.atlas_width)
    with tf.machine_state(lib, planar, dev, tf.ROUNDS, not cull, 0) as (scratch, slots, stream):
        err = lib.vkrt_alpha_rounds(
            int(bool(cull)), planar.width, planar.rows.data_ptr(), planar.stack_depth,
            origin.data_ptr(), direction.data_ptr(), t_limit.data_ptr(), tf._ptr(active),
            seed.data_ptr(), *alpha, r, _MAX_ROUNDS, scratch.data_ptr(), scratch.numel(),
            slots, t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
            seed_out.data_ptr(), steps.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"alpha rounds kernel launch failed: cudaError {err}")
    tf.LAUNCHES[tf.launch_key("alpha_rounds", planar.width)] += 1
    return t, tri.long(), u, v, seed_out, steps


def _alpha_rounds(planar, pack, origin, direction, t_limit, seed, active, cull):
    """The alpha pass: the rays that can reach the alpha tree within (0,
    t_limit) (the reference's per-child root prefilter) run the candidate
    rounds. CUDA tensors: one launch of ``vkrt_alpha_rounds``, whose ray
    intake runs that need line on ``active``; CPU tensors:
    ``traverse_fused.alpha_need`` (its plain version), then the round loop.
    Returns ``(Hit, seed')``."""
    r = origin.shape[0]
    if seed is None:
        seed = torch.zeros(r, dtype=torch.int64, device=origin.device)
    if origin.device.type == "cuda":
        out = _alpha_rounds_cuda(planar, pack, origin, direction, t_limit, seed, active, cull)
    else:
        need0 = tf.alpha_need(planar, origin, direction, t_limit, active)
        out = _rounds(planar, pack, origin, direction, t_limit, seed, need0, cull)
    bt, btri, bu, bv, seed, steps = out
    hit = Hit(t=bt, tri=btri, u=bu, v=bv, steps=steps)
    return hit, seed


def closest_hit_alpha(planar, pack, origin, direction, t_limit, seed=None, active=None):
    """Nearest alpha surface within (0, t_limit) that passes its test."""
    return _alpha_rounds(planar, pack, origin, direction, t_limit, seed, active, cull=True)


def any_hit_alpha(planar, pack, origin, direction, t_max, seed=None, active=None):
    """Shadow-ray occlusion by the alpha set (no culling)."""
    hit, seed = _alpha_rounds(planar, pack, origin, direction, t_max, seed, active, cull=False)
    return hit.tri >= 0, seed
