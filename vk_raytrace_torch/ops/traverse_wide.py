"""Closest/any hit over an accel bundle (counterpart of the planar dispatch in
``vk_raytrace_tpu/ops/traverse_wide.py:522-616``) and the alpha-test tables
(``AlphaPack``, ``:29-72``).

The opaque tree runs traversal mode a (closest) or b (any); the alpha tree
runs candidate rounds (mode c, ``ops/traverse_alpha.py``) pruned by the
opaque result.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import traverse_fused as tf
from .traverse_fused import Hit


@dataclasses.dataclass
class AlphaPack:
    """Gather-minimal alpha-test tables: one 16-lane row per triangle
    (a_factor, mode, cutoff, tex_id, uvT 3x2, atlas x/y/w/h, wrap_s/t) and
    the atlas alpha channel, flat."""

    rows: torch.Tensor
    alpha_plane: torch.Tensor
    atlas_width: int


def make_alpha_pack(materials, atlas, tri_material=None) -> AlphaPack:
    """Per-triangle alpha rows (per-material when ``tri_material`` is None)
    from the device material and atlas tables."""
    m, at = materials, atlas
    t = m.uv_transform
    tex = torch.clamp(m.base_color_texture, 0, at.x.shape[0] - 1)
    rows = torch.stack(
        [
            m.base_color_factor[:, 3],
            m.alpha_mode.float(),
            m.alpha_cutoff,
            m.base_color_texture.float(),
            t[:, 0, 0], t[:, 0, 1], t[:, 1, 0], t[:, 1, 1], t[:, 2, 0], t[:, 2, 1],
            at.x[tex].float(), at.y[tex].float(),
            at.width[tex].float(), at.height[tex].float(),
            at.wrap_s[tex].float(), at.wrap_t[tex].float(),
        ],
        dim=1,
    )
    if tri_material is not None:
        rows = rows[torch.clamp(tri_material, 0, rows.shape[0] - 1)]
    return AlphaPack(
        rows=rows,
        alpha_plane=at.data[:, :, 3].reshape(-1).contiguous(),  # read by the alpha machine kernel
        atlas_width=int(at.data.shape[1]),
    )


@dataclasses.dataclass
class AccelBundle:
    """Opaque and alpha planar trees (``alpha_planar`` None when the scene
    has no alpha-tested triangles)."""

    opaque_planar: tf.PlanarScene
    alpha_planar: Optional[tf.PlanarScene] = None

    def to(self, device) -> "AccelBundle":
        return AccelBundle(
            self.opaque_planar.to(device),
            None if self.alpha_planar is None else self.alpha_planar.to(device),
        )


def closest_hit_bundle(bundle, pack, origin, direction, seed, active=None):
    """Opaque closest hit, then the nearest alpha surface in front of it
    that passes its stochastic test. Returns ``(Hit, seed')``; rays outside
    ``active`` (an optional (R,) bool mask) miss and keep their seed."""
    from . import traverse_alpha as ta

    hit_o = tf.closest_hit_fused(bundle.opaque_planar, origin, direction, active=active)
    if bundle.alpha_planar is None:
        return hit_o, seed
    hit_a, seed = ta.closest_hit_alpha(
        bundle.alpha_planar, pack, origin, direction, hit_o.t, seed=seed, active=active
    )
    take_a = hit_a.tri >= 0
    return Hit(
        t=torch.where(take_a, hit_a.t, hit_o.t),
        tri=torch.where(take_a, hit_a.tri, hit_o.tri),
        u=torch.where(take_a, hit_a.u, hit_o.u),
        v=torch.where(take_a, hit_a.v, hit_o.v),
        steps=hit_o.steps + hit_a.steps,
    ), seed


def any_hit_bundle(bundle, pack, origin, direction, t_max, seed, active=None):
    """Shadow-ray occlusion: opaque any hit, then alpha candidate rounds for
    the rays still unoccluded. Returns ``(occluded, seed')``."""
    from . import traverse_alpha as ta

    occ = tf.any_hit_fused(bundle.opaque_planar, origin, direction, t_max, active=active)
    if bundle.alpha_planar is None:
        return occ, seed
    still = active & ~occ if active is not None else ~occ
    occ_a, seed = ta.any_hit_alpha(
        bundle.alpha_planar, pack, origin, direction, t_max, seed=seed, active=still
    )
    return occ | occ_a, seed
