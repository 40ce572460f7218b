"""Planar-row fetches per ray: the tree-quality metric of the port's
traversal (counterpart of ``vk_raytrace_tpu/utils/stepcount.py``).

A numpy traversal of the planar tables (``PlanarScene.rows``, 16 or 32
children a row) that counts the rows a ray fetches, interior and leaf, in
the kernels' schedule: children visited near to far, pruning by the best t
at pop time, Moller-Trumbore leaves. :func:`count_rows` runs closest hit,
:func:`count_rows_anyhit` the early-exit occlusion query of the shadow
rays, :func:`secondary_rays` diffuse bounce rays from the primary hits, and
:func:`primary_rays` the camera rays of a pixel subgrid through the port's
camera (``integrator/camera.py``, on the CPU). Host only: no device is
used.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _quiet_overflow(fn):
    """Empty slots carry inverted 3e38 boxes: their slab products overflow
    to inf by design."""

    @functools.wraps(fn)
    def wrapped(*args, **kw):
        with np.errstate(over="ignore"):
            return fn(*args, **kw)

    return wrapped


def primary_rays(scene, width, height, res_w, res_h):
    """Camera rays (numpy float32 origins and directions) through the
    centres of a ``res_w`` x ``res_h`` pixel subgrid of the ``width`` x
    ``height`` frame; ``scene.camera`` is the port's ``Camera``."""
    from ..integrator.camera import generate_rays_for_pixels

    xs = np.arange(res_w, dtype=np.int64) * (width // res_w)
    ys = np.arange(res_h, dtype=np.int64) * (height // res_h)
    pix = torch.from_numpy((ys[:, None] * width + xs[None, :]).reshape(-1))
    seed = torch.zeros(len(pix), dtype=torch.int64)
    o, d, _ = generate_rays_for_pixels(scene.camera.to("cpu"), width, height, pix, 0, seed)
    return o.numpy(), d.numpy()


@_quiet_overflow
def count_rows(rows: np.ndarray, width: int, o: np.ndarray, d: np.ndarray,
               return_t: bool = False):
    """Closest-hit traversal of one planar table; returns rows-fetched per
    ray. Matches the fused kernel's schedule: distance-ordered children,
    pop-time t_best pruning, Moller-Trumbore leaves."""
    W = width
    L = W // 2
    inv_all = np.where(np.abs(d) > 1e-12, 1.0 / np.where(d == 0, 1, d), 1e30)
    inv_all = np.where(d < 0, -np.abs(inv_all), np.abs(inv_all))
    n_rays = len(o)
    counts = np.zeros(n_rays, np.int32)
    t_out = np.full(n_rays, np.float32(3.0e38)) if return_t else None

    # Pre-split planes for speed.
    bmin = rows[:, 0 * W:3 * W].reshape(-1, 3, W)
    bmax = rows[:, 3 * W:6 * W].reshape(-1, 3, W)
    refs = rows[:, 6 * W:7 * W]

    for i in range(n_rays):
        oi = o[i]
        inv = inv_all[i]
        t_best = np.float32(3.0e38)
        stack = [(0.0, 0)]  # (entry_t, interior row)
        n_fetch = 0
        while stack:
            t_ent, ref = stack.pop()
            if t_ent >= t_best:
                continue
            r = int(ref)
            n_fetch += 1
            t0 = (bmin[r] - oi[:, None]) * inv[:, None]   # (3, W)
            t1 = (bmax[r] - oi[:, None]) * inv[:, None]
            tn = np.minimum(t0, t1).max(axis=0)
            tf = np.maximum(t0, t1).min(axis=0)
            tn = np.maximum(tn, 0.0)
            hit = (tn <= tf) & (tn < t_best)
            for c in np.argsort(-tn):  # far-to-near push => near pops first
                if not hit[c]:
                    continue
                cref = refs[r, c]
                if cref >= 0.5:  # interior (root is row 0; empty slots ref 0
                    stack.append((tn[c], int(cref)))  # and never slab-hit)
                elif cref < 0:
                    # leaf: fetch + intersect
                    code = int(-cref) - 1
                    lrow = code // L
                    cnt = code % L + 1
                    n_fetch += 1
                    lr = rows[lrow]
                    p = lr[: 9 * L].reshape(9, L)[:, :cnt]
                    p0 = p[0:3]
                    e1 = p[3:6] - p0
                    e2 = p[6:9] - p0
                    dv = d[i]
                    pv = np.cross(dv, e2.T).T
                    det = (e1 * pv).sum(0)
                    ok = np.abs(det) > 1e-12
                    invd = 1.0 / np.where(ok, det, 1.0)
                    tv = oi[:, None] - p0
                    u = (tv * pv).sum(0) * invd
                    qv = np.cross(tv.T, e1.T).T
                    v = (dv[:, None] * qv).sum(0) * invd
                    t = (e2 * qv).sum(0) * invd
                    good = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-4) & (t < t_best)
                    if good.any():
                        t_best = t[good].min()
        counts[i] = n_fetch
        if return_t:
            t_out[i] = t_best
    if return_t:
        return counts, t_out
    return counts


def secondary_rays(rows, width, o, d, rng_seed=7):
    """Diffuse bounce rays: trace primaries, spawn cosine-ish hemisphere
    directions from the hit points (rays that missed are dropped)."""
    _, t_best = count_rows(rows, width, o, d, return_t=True)
    hit = np.isfinite(t_best) & (t_best < 3.0e37)
    p = o[hit] + d[hit] * t_best[hit][:, None] * 0.999
    rng = np.random.default_rng(rng_seed)
    nd = rng.normal(size=(len(p), 3)).astype(np.float32)
    nd /= np.linalg.norm(nd, axis=1, keepdims=True)
    # flip to the hemisphere away from the incoming ray
    flip = (nd * d[hit]).sum(1) > 0
    nd[flip] *= -1.0
    return p.astype(np.float32), nd


@_quiet_overflow
def count_rows_anyhit(rows, width, o, d):
    """Early-exit occlusion traversal: rows fetched until ANY hit (or
    exhaustion) — models the NEE shadow pass."""
    W = width
    L = W // 2
    inv_all = np.where(np.abs(d) > 1e-12, 1.0 / np.where(d == 0, 1, d), 1e30)
    inv_all = np.where(d < 0, -np.abs(inv_all), np.abs(inv_all))
    counts = np.zeros(len(o), np.int32)
    occluded = np.zeros(len(o), bool)
    bmin = rows[:, 0 * W:3 * W].reshape(-1, 3, W)
    bmax = rows[:, 3 * W:6 * W].reshape(-1, 3, W)
    refs = rows[:, 6 * W:7 * W]
    for i in range(len(o)):
        oi = o[i]
        inv = inv_all[i]
        stack = [0]
        n_fetch = 0
        done = False
        while stack and not done:
            r = stack.pop()
            n_fetch += 1
            t0 = (bmin[r] - oi[:, None]) * inv[:, None]
            t1 = (bmax[r] - oi[:, None]) * inv[:, None]
            tn = np.maximum(np.minimum(t0, t1).max(axis=0), 0.0)
            tf = np.maximum(t0, t1).min(axis=0)
            hit = tn <= tf
            for c in np.where(hit)[0]:
                cref = refs[r, c]
                if cref >= 0.5:
                    stack.append(int(cref))
                elif cref < 0:
                    code = int(-cref) - 1
                    lrow = code // L
                    cnt = code % L + 1
                    n_fetch += 1
                    lr = rows[lrow]
                    p = lr[: 9 * L].reshape(9, L)[:, :cnt]
                    p0, e1, e2 = p[0:3], p[3:6] - p[0:3], p[6:9] - p[0:3]
                    dv = d[i]
                    pv = np.cross(dv, e2.T).T
                    det = (e1 * pv).sum(0)
                    ok = np.abs(det) > 1e-12
                    invd = 1.0 / np.where(ok, det, 1.0)
                    tv = oi[:, None] - p0
                    u = (tv * pv).sum(0) * invd
                    qv = np.cross(tv.T, e1.T).T
                    v = (dv[:, None] * qv).sum(0) * invd
                    t = (e2 * qv).sum(0) * invd
                    if (ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-4) & (t < 1e30)).any():
                        occluded[i] = True
                        done = True
                        break
        counts[i] = n_fetch
    return counts, occluded


