"""Texture atlas packing (counterpart of ``vk_raytrace_tpu/models/textures.py``).

All textures go into one uint8 atlas plus a placement table, with each
texture's mip chain packed as a (w, h/2) strip; shelf packing by height, so
the layout is deterministic and byte-identical to the reference's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..ops.texture import (
    WRAP_CLAMP,
    WRAP_MIRROR,
    WRAP_REPEAT,
    downsample_2x2,
    n_mip_levels,
)
from .schema import TextureAtlas

# glTF sampler wrap enums
_GL_WRAPS = {10497: WRAP_REPEAT, 33071: WRAP_CLAMP, 33648: WRAP_MIRROR}


class AtlasBuilder:
    def __init__(self, max_dim: int = 8192):
        self._images: list[np.ndarray] = []
        self._wraps: list[tuple[int, int]] = []
        self.max_dim = max_dim

    def add(self, image: Optional[np.ndarray], sampler: dict) -> int:
        """Register an (H, W, 4) uint8 image + glTF sampler; returns its slot
        id. ``None`` becomes a 1x1 white dummy."""
        if image is None:
            image = np.full((1, 1, 4), 255, np.uint8)
        if image.ndim == 2:
            image = np.stack([image] * 3 + [np.full_like(image, 255)], axis=-1)
        if image.shape[-1] == 3:
            image = np.concatenate(
                [image, np.full(image.shape[:2] + (1,), 255, np.uint8)], axis=-1
            )
        ws = _GL_WRAPS.get(sampler.get("wrapS", 10497), WRAP_REPEAT)
        wt = _GL_WRAPS.get(sampler.get("wrapT", 10497), WRAP_REPEAT)
        self._images.append(np.ascontiguousarray(image, np.uint8))
        self._wraps.append((ws, wt))
        return len(self._images) - 1

    def build(self, mips: bool = True) -> TextureAtlas:
        """Pack the atlas; ``mips`` also packs each texture's mip strip."""
        assert self._images, "no textures added"
        n = len(self._images)
        rects = [im.shape[:2] for im in self._images]  # (h, w)
        strips: list[np.ndarray | None] = [None] * n
        if mips:
            for i, im in enumerate(self._images):
                h, w = im.shape[:2]
                levels = int(n_mip_levels(w, h))
                if levels < 1:
                    continue
                strip = np.zeros((max(h // 2, 1), w, 4), np.uint8)
                cur = im
                for lvl in range(1, levels + 1):
                    cur = downsample_2x2(cur)
                    lx = w - (w >> (lvl - 1))
                    strip[: cur.shape[0], lx : lx + cur.shape[1]] = cur
                strips[i] = strip
                rects.append(strip.shape[:2])

        order = sorted(range(len(rects)), key=lambda i: -rects[i][0])
        atlas_w = min(
            self.max_dim,
            max(1 << int(np.ceil(np.log2(max(r[1] for r in rects)))), 256),
        )
        m = len(rects)
        xs = np.zeros(m, np.int64)
        ys = np.zeros(m, np.int64)
        shelf_y = shelf_h = cur_x = 0
        for i in order:
            h, w = rects[i]
            assert w <= atlas_w, f"rect {i} wider than atlas ({w} > {atlas_w})"
            if cur_x + w > atlas_w:
                shelf_y += shelf_h
                cur_x = 0
                shelf_h = 0
            xs[i], ys[i] = cur_x, shelf_y
            cur_x += w
            shelf_h = max(shelf_h, h)
        atlas_h = int(np.ceil((shelf_y + shelf_h) / 8)) * 8

        data = np.zeros((atlas_h, atlas_w, 4), np.uint8)
        for i, im in enumerate(self._images):
            h, w = im.shape[:2]
            data[ys[i] : ys[i] + h, xs[i] : xs[i] + w] = im
        mip_x = np.full(n, -1, np.int64)
        mip_y = np.full(n, -1, np.int64)
        j = n
        for i, strip in enumerate(strips):
            if strip is None:
                continue
            h, w = strip.shape[:2]
            data[ys[j] : ys[j] + h, xs[j] : xs[j] + w] = strip
            mip_x[i], mip_y[i] = xs[j], ys[j]
            j += 1
        no_chains = j == n
        return TextureAtlas(
            data=data,
            x=np.asarray(xs[:n], np.int32),
            y=np.asarray(ys[:n], np.int32),
            width=np.asarray([im.shape[1] for im in self._images], np.int32),
            height=np.asarray([im.shape[0] for im in self._images], np.int32),
            wrap_s=np.asarray([w[0] for w in self._wraps], np.int32),
            wrap_t=np.asarray([w[1] for w in self._wraps], np.int32),
            mip_x=None if no_chains else np.asarray(mip_x, np.int32),
            mip_y=None if no_chains else np.asarray(mip_y, np.int32),
        )
