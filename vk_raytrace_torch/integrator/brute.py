"""BVH-free brute-force tracer: the correctness anchor (counterpart of
``vk_raytrace_tpu/integrator/brute.py``).

Every ray is intersected with every triangle (Moller-Trumbore, O(T R)), with
no acceleration structure, no rows and no stack, so a render through it
checks the whole BVH path (build, planar rows, kernels, alpha split) against
code whose only shared ingredient is the intersection formula. Plain torch
on the tensors' device; an oracle, never a main path.

Semantics are the traversal's (``ClosestHit`` / ``AnyHit``,
traceray_rq.glsl:108-185): closest hit culls back faces except on
double-sided triangles; any hit tests both faces and reports any hit closer
than ``t_max``. Opaque geometry only: a stochastic alpha test would need
the traversal's order of draws.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.traverse_fused import INF, Hit

# The anchor's criterion (``tests/test_anchor.py::_assert_images_match``):
# pixels within 2% of the image mean on every channel count as matched;
# at least 98.5% must match, and the RMSE over the matched set must stay
# under 1% of the mean.
MATCH_PIXEL, MATCH_SHARE, MATCH_RMSE = 0.02, 0.985, 0.01
_EPS_DET = 1e-12
# Ray-triangle pairs per chunk: each (chunk, T) float32 intermediate stays
# at 8 MiB, a (chunk, T, 3) one at 24 MiB.
MAX_PAIRS = 1 << 21


def _cross(a, b):
    """a x b, each component as a*b - c*d."""
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


class BruteTracer:
    """Drop-in ``tracer`` for :func:`integrator.path.trace_paths` over a
    ``Geometry`` whose tables are tensors on the rays' device. Rays run in
    chunks of at most ``max_pairs`` ray-triangle pairs."""

    def __init__(self, geom, max_pairs: int = MAX_PAIRS):
        idx = geom.indices.long()
        pos = geom.positions
        self.p0 = pos[idx[:, 0]]
        self.e1 = pos[idx[:, 1]] - self.p0
        self.e2 = pos[idx[:, 2]] - self.p0
        self.double_sided = (geom.tri_flags & 1) != 0
        self.chunk = max(1, max_pairs // idx.shape[0])

    def _intersect(self, o, d, cull_backface: bool):
        """(C, T) masks and t, u, v of C rays against every triangle."""
        pvec = _cross(d[:, None, :], self.e2[None])
        det = _dot(self.e1[None], pvec)
        det_ok = torch.abs(det) > _EPS_DET
        facing_ok = (self.double_sided | (det > _EPS_DET)) if cull_backface else det_ok
        inv_det = 1.0 / torch.where(det_ok, det, 1.0)
        tvec = o[:, None, :] - self.p0[None]
        uu = _dot(tvec, pvec) * inv_det
        qvec = _cross(tvec, self.e1[None])
        vv = _dot(d[:, None, :], qvec) * inv_det
        tt = _dot(self.e2[None], qvec) * inv_det
        ok = det_ok & facing_ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0) & (tt > 0.0)
        return ok, tt, uu, vv

    def closest(self, origin, direction, seed, active):
        """Nearest hit of each ray: ``(Hit, seed)``; rays outside ``active``
        miss."""
        parts = []
        for s in range(0, origin.shape[0], self.chunk):
            ok, tt, uu, vv = self._intersect(origin[s:s + self.chunk], direction[s:s + self.chunk], True)
            tt = torch.where(ok, tt, INF)
            best = torch.argmin(tt, dim=1, keepdim=True)
            t = tt.gather(1, best)[:, 0]
            tri = torch.where(t < INF, best[:, 0], -1)
            parts.append((t, tri, uu.gather(1, best)[:, 0], vv.gather(1, best)[:, 0]))
        t, tri, u, v = (torch.cat(x) for x in zip(*parts))
        if active is not None:
            tri = torch.where(active, tri, -1)
            t = torch.where(active, t, INF)
        return Hit(t=t, tri=tri, u=u, v=v, steps=torch.zeros_like(tri, dtype=torch.int32)), seed

    def occluded(self, origin, direction, t_max, seed, active):
        """Whether anything lies within ``t_max`` of each ray: ``(mask,
        seed)``; rays outside ``active`` are unoccluded."""
        parts = []
        for s in range(0, origin.shape[0], self.chunk):
            sl = slice(s, s + self.chunk)
            ok, tt, _, _ = self._intersect(origin[sl], direction[sl], False)
            parts.append(torch.any(ok & (tt < t_max[sl, None]), dim=1))
        occ = torch.cat(parts)
        if active is not None:
            occ = occ & active
        return occ, seed


def images_match(a, b, scale=None):
    """The anchor's comparison of two (H, W, 3) numpy images, modulo the
    tie-breaks of shared quad edges (a ray that meets two triangles at one
    t may take either, and its path diverges after): ``(ok, matched share,
    matched-set RMSE / scale)``, ``scale`` the mean of ``b`` by default."""
    if scale is None:
        scale = max(float(np.mean(b)), 1e-9)
    matched = np.abs(a - b).max(axis=-1) < MATCH_PIXEL * scale
    share = float(np.mean(matched))
    rmse = float(np.sqrt(np.mean((a[matched] - b[matched]) ** 2))) / scale
    return share >= MATCH_SHARE and rmse < MATCH_RMSE, share, rmse


def anchor_render(scene, packed, cfg, frames: int, features, tracer=None):
    """The anchor's progressive render: the running mean of ``frames``
    whole-image frames of the unrolled integrator, through ``packed`` or
    through ``tracer``, with identical random streams either way. ``scene``
    lies on its device with the camera's aspect set; returns (H, W, 3)."""
    from ..render import render_strip_impl

    accum = None
    for frame in range(frames):
        img, _ = render_strip_impl(scene, packed, cfg, 0, cfg.height, frame, features=features,
                                   tracer=tracer)
        accum = img if accum is None else accum + (img - accum) / (frame + 1)
    return accum
