"""Renderer: scene ownership, progressive accumulation, post (counterpart of
``vk_raytrace_tpu/render.py``).

``Renderer(scene, cfg, device=...)`` builds the acceleration structures and
the sun&sky environment, uploads every table once, and renders progressive
frames: ``accum = mix(accum, new, 1/(frame+1))`` (pathtrace.rgen:96-107).
A frame runs the pooled wavefront; a debug render mode runs the unrolled
integrator over row strips (:func:`render_strip_impl`). The device is
always explicit. ``pick`` traces one camera ray; ``save_state`` /
``load_state`` checkpoint the accumulation; :func:`write_png` writes the
post-processed image without Pillow (``utils/png.py``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .integrator import shade_fused
from .integrator.camera import generate_rays_for_pixels, with_aspect
from .integrator.path import sample_pixels
from .integrator.shade import build_shade_rows, mat_features
from .integrator.wavefront import render_units_pooled
from .models.schema import DEBUG_NONE, SceneData, default_sun_sky, default_tonemapper, dummy_atlas, dummy_environment
from .ops import rng
from .ops.bvh8 import build_accel_bundle
from .ops.bvh8 import with_wide as bvh8_with_wide
from .ops.tlas import InstancedAccel, closest_hit_instanced
from .ops.tlas import with_wide as tlas_with_wide
from .ops.texture import build_tap_rows
from .ops.tonemap import TM_UNCHARTED, apply_post
from .ops.traverse_wide import check_backend, closest_hit_bundle, make_alpha_pack
from .utils import png


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
# Rays per strip of the unrolled integrator, which carries every ray of a
# strip through every bounce: the cap bounds its state.
MAX_RAYS_PER_DISPATCH = 1 << 19


def progressive_update(accum: torch.Tensor, new: torch.Tensor, frame: int) -> torch.Tensor:
    """The running mean after frame ``frame`` (0-based) adds ``new``: the
    progressive update of ``Renderer.step`` and of the sharded steps."""
    return accum + (new - accum) * (1.0 / (frame + 1.0))


def dispatch_split(n_pix: int, spp: int, pool=None):
    """``(dispatches, pixels each, pool lanes)`` of a frame's ``n_pix``
    pixels: at most ``MAX_PATHS_PER_DISPATCH`` paths a wavefront call, in
    equal parts; the pool (unless given) at most ``POOL_LANES``."""
    per_dispatch = max(1, MAX_PATHS_PER_DISPATCH // max(spp, 1))
    n = max(1, -(-n_pix // per_dispatch))
    while n_pix % n:
        n += 1
    part = n_pix // n
    return n, part, pool if pool is not None else min(POOL_LANES, max(1024, part * spp))


def strip_rows_for(cfg) -> int:
    """Rows per strip: about ``MAX_RAYS_PER_DISPATCH`` rays, at least 8
    rows, in equal strips that divide the image."""
    rows = min(max(8, MAX_RAYS_PER_DISPATCH // max(cfg.width, 1)), cfg.height)
    n = -(-cfg.height // rows)
    while cfg.height % n:
        n += 1
    return cfg.height // n


def render_strip_impl(scene, packed, cfg, row0: int, n_rows: int, frame: int, alpha_pack=None,
                      features=None, tracer=None, stream=None, backend="fused"):
    """``cfg.max_samples`` paths per pixel of image rows ``[row0, row0 +
    n_rows)`` through the unrolled integrator, averaged: ``(image (n_rows,
    W, 3), rays)``, ``rays`` the closest-hit and shadow rays traced (0-d).
    ``tracer``: a traversal back end in place of ``packed``
    (``integrator/path.py::trace_paths``); ``backend`` the traversal back end
    over ``packed``, "fused" or "wide". Sample ``s`` of a pixel draws
    from ``rng.tea(pixel, stream * spp + s)``; ``stream`` defaults to
    ``frame``, which also drives the camera jitter."""
    w = cfg.width
    dev = scene.shade_rows.device
    pix = torch.arange(n_rows * w, dtype=torch.int64, device=dev) + row0 * w
    total = torch.zeros(n_rows * w, 3, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    stream = frame if stream is None else stream
    for s in range(cfg.max_samples):
        seed = rng.tea(pix, stream * cfg.max_samples + s)
        o, d, seed = generate_rays_for_pixels(scene.camera, w, cfg.height, pix, frame, seed)
        radiance, _, st = sample_pixels(
            scene, packed, cfg, o, d, seed, alpha_pack=alpha_pack, tracer=tracer,
            features=features, backend=backend,
        )
        total = total + radiance
        rays = rays + st.rays.sum()
    return (total / cfg.max_samples).reshape(n_rows, w, 3), rays


class Renderer:
    """Progressive path tracer over one scene on an explicit device."""

    def __init__(self, scene: SceneData, cfg, device, packed=None, fused_shade: bool = False,
                 tonemapper=None, renderer: str = "fused"):
        """``packed`` reuses a prebuilt AccelBundle or InstancedAccel; a
        two-level scene brings its own in ``scene.instances``. The renderer
        keeps the structure in ``self.packed`` only. ``fused_shade`` runs
        each bounce's shading as one kernel launch where the scene allows it
        (``integrator/shade_fused.py::supported``); off by default.
        ``stage`` says which shading stage the frames run: ``"fused"`` or
        ``"eager"``. ``tonemapper``: the post chain's ``Tonemapper`` table
        (default ``default_tonemapper()``). ``renderer``: the traversal
        back end of every ray (frames, debug strips, picks), "fused" (the
        planar trees, ``csrc/traverse.cu``) or "wide" (the 8-wide trees
        with the alpha test inside the traversal, ``csrc/traverse_wide.cu``;
        the reference's ``--renderer``); the wide tables are built here, at
        the back end's first use, unless ``packed`` already holds them.
        ``fused_shade`` is independent of it."""
        check_backend(renderer)
        self.renderer = renderer
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
        if renderer == "wide":
            packed = (tlas_with_wide if isinstance(packed, InstancedAccel) else bvh8_with_wide)(
                packed, scene.geometry)
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
        self.tonemapper = (default_tonemapper() if tonemapper is None else tonemapper).to(self.device)
        # The fused shading stage's tables (light rows, sun-disk constants,
        # instance rows), built once here where that stage runs.
        self._shade_tables = None
        self.stage = "eager"
        if shade_fused.supported(fused_shade, self._run_cfg, self.scene, self.features):
            inst = self.packed.inst if isinstance(self.packed, InstancedAccel) else None
            self._shade_tables = shade_fused.stage_tables(self.scene, inst)
            self.stage = "fused"
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
        """Render one progressive frame into the running mean: the pooled
        wavefront, or with a debug render mode the unrolled integrator,
        which carries the first-hit debug outputs, over row strips."""
        if self.converged:
            return
        self.accum = progressive_update(self.accum, self.render_frame(self.frame), self.frame)
        self.frame += 1

    def render_frame(self, frame: int) -> torch.Tensor:
        """Frame ``frame``'s radiance (H, W, 3), not yet in the running mean;
        ``last_rays`` its rays. Leaves ``accum`` and ``frame`` as they are."""
        if self._run_cfg.debug_mode == DEBUG_NONE:
            return self._frame_pooled(frame)
        return self._frame_strips(frame)

    def _frame_pooled(self, frame: int) -> torch.Tensor:
        h, w = self.cfg.height, self.cfg.width
        cfg = self._run_cfg
        n, n_pix, pool = dispatch_split(h * w, cfg.max_samples)
        parts, rays = [], 0
        for i in range(n):
            img, r = render_units_pooled(
                self.scene, self.packed, cfg, frame, i * n_pix, n_pix, pool,
                alpha_pack=self.alpha_pack, features=self.features,
                fused_shade=self.fused_shade, shade_tables=self._shade_tables,
                backend=self.renderer,
            )
            parts.append(img)
            rays = rays + r
        self.last_rays = int(rays)
        return torch.cat(parts, dim=0).reshape(h, w, 3)

    def _frame_strips(self, frame: int) -> torch.Tensor:
        rows = strip_rows_for(self.cfg)
        strips, rays = [], 0
        for row0 in range(0, self.cfg.height, rows):
            img, r = render_strip_impl(
                self.scene, self.packed, self._run_cfg, row0, rows, frame,
                alpha_pack=self.alpha_pack, features=self.features, backend=self.renderer,
            )
            strips.append(img)
            rays = rays + r
        self.last_rays = int(rays)
        return torch.cat(strips, dim=0)

    def hdr(self) -> torch.Tensor:
        """The accumulated radiance image (H, W, 3), before the post chain."""
        return self.accum

    def render(self, frames: int = 1) -> np.ndarray:
        """Accumulate ``frames`` frames; the post-processed (H, W, 3) image."""
        for _ in range(frames):
            self.step()
        return self.postprocess().cpu().numpy()

    def postprocess(self, mode: int = TM_UNCHARTED) -> torch.Tensor:
        """Tonemap + post chain of the running mean, (H, W, 3) in [0, 1]."""
        return apply_post(self.accum, self.tonemapper, mode=mode)

    def pick(self, x: int, y: int):
        """Trace the camera ray through the centre of pixel (x, y): None on
        a miss, else a dict of the hit's ``triangle``, ``material``, ``t``,
        world ``position`` and ``barycentrics`` (and ``instance`` in a
        two-level scene). As in the reference, the ray runs without an
        alpha test: every alpha-tested triangle counts as opaque, on the
        single-level path (the alpha rounds with a null pack accept each
        candidate) and on the two-level one (one pass over every
        instance's full table)."""
        return self.pick_many([x], [y])[0]

    def pick_many(self, xs, ys) -> list:
        """:meth:`pick` of the pixels (xs[i], ys[i]), their rays traced in
        one call (each ray's result is its own)."""
        w, h = self.cfg.width, self.cfg.height
        pix = torch.as_tensor(np.asarray(ys, np.int64) * w + np.asarray(xs, np.int64),
                              device=self.device)
        o, d, _ = generate_rays_for_pixels(self.scene.camera, w, h, pix, 0, rng.tea(pix, 0))
        if isinstance(self.packed, InstancedAccel):
            hit, _ = closest_hit_instanced(self.packed, None, o, d, backend=self.renderer)
        else:
            hit, _ = closest_hit_bundle(self.packed, None, o, d, torch.zeros_like(pix),
                                        backend=self.renderer)
        tri = hit.tri.cpu().numpy()
        mat = self.scene.geometry.tri_material[torch.clamp(hit.tri, min=0)].cpu().numpy()
        t, u, v = (a.cpu().numpy() for a in (hit.t, hit.u, hit.v))
        pos = (o + d * hit.t[:, None]).cpu().numpy()
        inst = None if hit.inst is None else hit.inst.cpu().numpy()
        out = []
        for i in range(len(tri)):
            if tri[i] < 0:
                out.append(None)
                continue
            p = {"triangle": int(tri[i]), "material": int(mat[i]), "t": float(t[i]),
                 "position": pos[i], "barycentrics": (float(u[i]), float(v[i]))}
            if inst is not None:
                p["instance"] = int(inst[i])
            out.append(p)
        return out

    def save_state(self) -> dict:
        """The checkpoint: ``accum`` (H, W, 3) float32 numpy and ``frame``."""
        return {"accum": self.accum.cpu().numpy(), "frame": self.frame}

    def load_state(self, state) -> None:
        """Resume from a checkpoint (numpy or a tensor on any device): the
        accumulation becomes a float32 tensor on this renderer's device."""
        accum = torch.as_tensor(state["accum"])
        want = (self.cfg.height, self.cfg.width, 3)
        if tuple(accum.shape) != want:
            raise ValueError(f"checkpoint accumulation of shape {tuple(accum.shape)}, "
                             f"the renderer's is {want}")
        self.accum = accum.to(self.device, torch.float32, copy=True)
        self.frame = int(state["frame"])


def write_png(path: str, img01) -> None:
    """Write a [0, 1] float image (numpy or a tensor) to PNG: 8 bits,
    ``clip(x * 255 + 0.5, 0, 255)`` as in the reference."""
    if isinstance(img01, torch.Tensor):
        img01 = img01.cpu().numpy()
    png.write_png(path, img01)
