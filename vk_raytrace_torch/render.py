"""Renderer: scene ownership, progressive accumulation, post (counterpart of
``vk_raytrace_tpu/render.py``).

``Renderer(scene, cfg, device=...)`` builds the acceleration structures and
the sun&sky environment, uploads every table once, and renders progressive
frames with the pooled wavefront: ``accum = mix(accum, new, 1/(frame+1))``
(pathtrace.rgen:96-107). The device is always explicit.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .integrator import shade_fused
from .integrator.camera import with_aspect
from .integrator.shade import build_shade_rows, mat_features
from .integrator.wavefront import render_units_pooled
from .models.schema import SceneData, default_sun_sky, default_tonemapper, dummy_atlas, dummy_environment
from .ops.bvh8 import build_accel_bundle
from .ops.tlas import InstancedAccel
from .ops.texture import build_tap_rows
from .ops.tonemap import TM_UNCHARTED, apply_post
from .ops.traverse_wide import make_alpha_pack


def build_scene(geometry, materials, lights, camera, *, env=None, sun_sky=None,
                atlas=None) -> SceneData:
    """Assemble a renderable SceneData (host numpy tables); lights of zero
    intensity (the empty table's placeholder) do not count."""
    n_lights = int(np.count_nonzero(np.asarray(lights.intensity) > 0.0))
    atlas_r = atlas if atlas is not None else dummy_atlas()
    return SceneData(
        geometry=geometry,
        materials=materials,
        lights=lights,
        n_lights=n_lights,
        atlas=atlas_r,
        env=with_env_rows(env if env is not None else dummy_environment()),
        camera=camera,
        sun_sky=sun_sky if sun_sky is not None else default_sun_sky(),
        shade_rows=build_shade_rows(geometry, materials, atlas_r),
        tap_rows=build_tap_rows(atlas) if atlas is not None else None,
    )


def build_instanced_scene(pool, instances, materials, lights, camera, *, env=None,
                          sun_sky=None, atlas=None, width: int = 16) -> SceneData:
    """Assemble a two-level SceneData: ``pool`` is a ``models.instances.
    MeshPool`` of object-space meshes, ``instances`` its ``InstanceTable``;
    the instanced acceleration structure (``width``-wide planar rows, 16 or
    32) is built here and rides in ``SceneData.instances``."""
    from .ops.tlas import build_instanced_accel

    scene = build_scene(pool.geometry, materials, lights, camera, env=env, sun_sky=sun_sky,
                        atlas=atlas)
    return dataclasses.replace(scene, instances=build_instanced_accel(pool, instances, width))


def with_env_rows(env):
    """The environment with its packed per-texel rows (the integrator reads
    the alias table and bilinear taps only through them)."""
    if env.rows is not None:
        return env
    from .models.hdr import pack_env_rows

    rows = pack_env_rows(torch.from_numpy(np.asarray(env.image, np.float32)), env.accel.to("cpu"))
    return dataclasses.replace(env, rows=rows.numpy())


def prepare_sun_sky(scene: SceneData, cfg, device):
    """With ``cfg.use_sun_sky``: bake the sky without its disk core on
    ``device``, build its alias table, and switch the config to the baked
    environment plus the analytic disk (``sun_disk``). Returns
    ``(scene', cfg')`` with the environment as tensors on ``device``."""
    if not cfg.use_sun_sky:
        return scene, cfg
    from .models.hdr import build_environment
    from .ops.sunsky import bake_environment

    img = bake_environment(scene.sun_sky.to(device), disk=False)
    env = build_environment(img)
    return (
        dataclasses.replace(scene, env=env),
        dataclasses.replace(cfg, use_sun_sky=False, sun_disk=True),
    )


# Paths per wavefront call (a 1080p frame at 1 spp is one call) and lanes
# in the pool, as in the reference.
MAX_PATHS_PER_DISPATCH = 1 << 21
POOL_LANES = 1 << 18


class Renderer:
    """Progressive path tracer over one scene on an explicit device."""

    def __init__(self, scene: SceneData, cfg, device, packed=None, fused_shade: bool = False):
        """``packed`` reuses a prebuilt AccelBundle or InstancedAccel; a
        two-level scene brings its own in ``scene.instances``. The renderer
        keeps the structure in ``self.packed`` only. ``fused_shade`` runs
        each bounce's shading as one kernel launch where the scene allows it
        (``integrator/shade_fused.py::supported``); off by default."""
        self.cfg = cfg
        self.fused_shade = fused_shade
        self.device = torch.device(device)
        self.build_times: dict[str, float] = {}
        scene = dataclasses.replace(scene, camera=with_aspect(scene.camera, cfg.width, cfg.height))
        t0 = time.time()
        scene, self._run_cfg = prepare_sun_sky(scene, cfg, self.device)
        self._sync()
        self.build_times["sky_bake_s"] = time.time() - t0
        t0 = time.time()
        if packed is None:
            packed = scene.instances
        if packed is None:
            packed = build_accel_bundle(scene.geometry)
        self.packed = packed
        scene = dataclasses.replace(scene, instances=None)
        self.build_times["accel_s"] = time.time() - t0
        self.features = mat_features(scene.materials)
        has_alpha = bool(np.any(np.asarray(scene.geometry.tri_flags) & 2))
        t0 = time.time()
        self.scene = scene.to(self.device)
        self.packed = self.packed.to(self.device)
        self.alpha_pack = (
            make_alpha_pack(self.scene.materials, self.scene.atlas, self.scene.geometry.tri_material)
            if has_alpha
            else None
        )
        self.tonemapper = default_tonemapper().to(self.device)
        # The fused shading stage's tables (light rows, sun-disk constants,
        # instance rows), built once here where that stage runs.
        self._shade_tables = None
        if shade_fused.supported(fused_shade, self._run_cfg, self.scene, self.features):
            inst = self.packed.inst if isinstance(self.packed, InstancedAccel) else None
            self._shade_tables = shade_fused.stage_tables(self.scene, inst)
        self._sync()
        self.build_times["upload_s"] = time.time() - t0
        self.last_rays = 0
        self.reset()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def converged(self) -> bool:
        return self.frame >= self.cfg.max_frames

    def reset(self) -> None:
        self.frame = 0
        self.accum = torch.zeros((self.cfg.height, self.cfg.width, 3), device=self.device)

    def step(self) -> None:
        """Render one progressive frame into the running mean."""
        if self.converged:
            return
        new = self._frame_pooled(self.frame)
        self.accum = self.accum + (new - self.accum) * (1.0 / (self.frame + 1.0))
        self.frame += 1

    def _frame_pooled(self, frame: int) -> torch.Tensor:
        h, w = self.cfg.height, self.cfg.width
        cfg = self._run_cfg
        total_px = h * w
        px_per_dispatch = max(1, MAX_PATHS_PER_DISPATCH // max(cfg.max_samples, 1))
        n = max(1, -(-total_px // px_per_dispatch))
        while total_px % n:
            n += 1
        n_pix = total_px // n
        pool = min(POOL_LANES, max(1024, n_pix * cfg.max_samples))
        parts, rays = [], 0
        for i in range(n):
            img, r = render_units_pooled(
                self.scene, self.packed, cfg, frame, i * n_pix, n_pix, pool,
                alpha_pack=self.alpha_pack, features=self.features,
                fused_shade=self.fused_shade, shade_tables=self._shade_tables,
            )
            parts.append(img)
            rays = rays + r
        self.last_rays = int(rays)
        return torch.cat(parts, dim=0).reshape(h, w, 3)

    def render(self, frames: int = 1) -> np.ndarray:
        """Accumulate ``frames`` frames; the post-processed (H, W, 3) image."""
        for _ in range(frames):
            self.step()
        return self.postprocess().cpu().numpy()

    def postprocess(self, mode: int = TM_UNCHARTED) -> torch.Tensor:
        """Tonemap + post chain of the running mean, (H, W, 3) in [0, 1]."""
        return apply_post(self.accum, self.tonemapper, mode=mode)
