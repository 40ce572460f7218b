"""The benchmark's plain reference: a progressive path tracer in plain torch.

It renders chosen (pixel, frame) paths of a configuration's scene with the
semantics of the port's main path (``Renderer.step``: the pooled wavefront,
the fused shading stage, sun&sky with its analytic disk), so that the
benchmark can judge what the timed path produced. Each path's random
stream is ``tea(pixel, frame * spp + sample)`` and frame ``f``'s camera
jitter comes from it as in the port, so a path is the port's path, draw for
draw. It imports nothing of the port and takes nothing the port made: the
sky is baked, its alias table, the shade rows, the texel footprints, the
alpha rows and the trees are all worked out here from the scene's arrays
(``rtbench/scenes``), by frozen copies of the port's plain versions
(``shading.py``, ``sunsky.py``, ``env.py``, ``hdr.py``, ``lights.py``,
``rng.py``, ``vecmath.py``) and by trees of its own (``accel.py``).

``state_dtype=torch.bfloat16`` gives the check's control: the same paths
with their state (rays, hits, throughput, radiance, the shadow ray) held
in bfloat16 between the stages, the precision below the configuration's
float32.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import torch

from . import rng
from .accel import SingleLevel, TwoLevel, make_alpha_pack
from .hdr import build_environment
from .shading import (
    _stage_plain, build_shade_rows, build_tap_rows, mat_features, mip_lod_enabled, pixel_spread,
)
from .sunsky import bake_environment
from .vecmath import firefly_luminance, normalize

TWO_PI = 2.0 * math.pi


def _tensor(a, device):
    """A host array as the port uploads it: float -> float32, other
    integers -> int64, uint32 bit patterns as int32."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype.kind == "f":
        a = a.astype(np.float32)
    elif a.dtype.kind in "iu" and a.dtype != np.uint8:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a)).to(device)


def _tables(obj, device):
    """A dataclass of host arrays with every field on ``device``."""
    return SimpleNamespace(**{f.name: None if getattr(obj, f.name) is None else
                              _tensor(getattr(obj, f.name), device)
                              for f in dataclasses.fields(obj)})


def with_aspect(cam, width: int, height: int):
    """The projection's x scale re-derived for the render's aspect ratio."""
    pi = np.array(np.asarray(cam.proj_inverse), np.float32)
    pi[0, 0] = (width / height) * abs(float(pi[1, 1]))
    return dataclasses.replace(cam, proj_inverse=pi)


def camera_rays(cam, width: int, height: int, pix, frame, seed):
    """Primary rays of pixels ``pix`` in frames ``frame`` (one per ray; a
    frame 0 ray goes through its pixel's centre): ``(origin, direction,
    seed')``, the port's ``generate_rays_for_pixels`` lane for lane."""
    px = (pix % width).float()
    py = (pix // width).float()
    seed, a = rng.rand(seed)
    seed, b = rng.rand(seed)
    jit = torch.where((frame == 0)[:, None], 0.5, torch.stack([a, b], dim=-1))
    u = (px + jit[..., 0]) / width * 2.0 - 1.0
    v = (py + jit[..., 1]) / height * 2.0 - 1.0
    vi, pinv = cam.view_inverse, cam.proj_inverse
    ones = torch.ones_like(u)
    ndc = torch.stack([u, v, ones, ones], dim=-1)
    target = torch.stack(
        [pinv[k, 0] * ndc[:, 0] + pinv[k, 1] * ndc[:, 1] + pinv[k, 2] * ndc[:, 2]
         + pinv[k, 3] * ndc[:, 3] for k in range(3)], dim=-1)
    tdir = normalize(target)
    direction = torch.stack(
        [vi[k, 0] * tdir[:, 0] + vi[k, 1] * tdir[:, 1] + vi[k, 2] * tdir[:, 2] for k in range(3)],
        dim=-1)
    seed, r1 = rng.rand(seed)
    seed, r2 = rng.rand(seed)
    focal_point = cam.focal_dist * direction
    ang = r1 * TWO_PI
    rad = r2 * cam.aperture
    aperture_pos = (torch.cos(ang)[..., None] * vi[:3, 0]
                    + torch.sin(ang)[..., None] * vi[:3, 1]) * torch.sqrt(rad)[..., None]
    direction = normalize(focal_point - aperture_pos)
    origin = vi[:3, 3] + aperture_pos
    return origin, direction, seed


class Reference:
    """A configuration's scene under one render set-up, ready to trace
    paths. ``scene``: ``rtbench.scenes.Scene``; ``render``: the
    configuration's render settings; ``width``, ``height``, ``depth``,
    ``spp``: the traffic's."""

    def __init__(self, scene, render: dict, width: int, height: int, depth: int, spp: int,
                 device, state_dtype=torch.float32):
        if render["pbr_mode"] != "gltf" or not render["use_sun_sky"]:
            raise ValueError("the reference follows the fused glTF stage under a baked sun&sky")
        self.device = torch.device(device)
        self.width, self.height, self.depth, self.spp = width, height, depth, spp
        self.clamp = float(render["firefly_clamp"])
        self.full_mis = bool(render["full_mis"])
        self.hdr_mult = float(render["hdr_multiplier"])
        self.p_select_light = 0.5 if self.hdr_mult > 0.0 else 1.0
        self.state_dtype = state_dtype
        dev = self.device
        cam = with_aspect(scene.camera, width, height)
        geom, mats, atlas = scene.geometry, scene.materials, scene.atlas
        self.features = mat_features(mats)
        sun_sky = _tables(render_sun_sky(), dev)
        env = build_environment(bake_environment(sun_sky, disk=False))
        n_lights = int(np.count_nonzero(np.asarray(scene.lights.intensity) > 0.0))
        self.scene = SimpleNamespace(
            shade_rows=torch.as_tensor(build_shade_rows(geom, mats, atlas), device=dev),
            tap_rows=_tensor(build_tap_rows(atlas), dev), atlas=_tables(atlas, dev),
            env=env, lights=_tables(scene.lights, dev), n_lights=n_lights, sun_sky=sun_sky,
            camera=_tables(cam, dev),
        )
        self.use_mips = mip_lod_enabled(self.scene, SimpleNamespace(mip_sample=True))
        self.spread = pixel_spread(self.scene, height) if self.use_mips else None
        has_alpha = bool(np.any(np.asarray(geom.tri_flags) & 2))
        pack = make_alpha_pack(mats, atlas, geom.tri_material, dev) if has_alpha else None
        if scene.instanced:
            self.accel = TwoLevel(scene.pool, scene.instances, pack, dev)
            self.instances = SimpleNamespace(object_to_world=self.accel.o2w,
                                             world_to_object=self.accel.w2o)
        else:
            self.accel = SingleLevel(geom, pack, dev)
            self.instances = None

    def _q(self, *xs):
        """The path state as the set-up holds it between stages."""
        if self.state_dtype == torch.float32:
            return xs if len(xs) > 1 else xs[0]
        out = tuple(x.to(self.state_dtype).float() for x in xs)
        return out if len(out) > 1 else out[0]

    def paths(self, pix: torch.Tensor, frame: torch.Tensor, sample: int = 0):
        """Sample ``sample`` of pixels ``pix`` (int64) in frames ``frame``
        (int64, one per path): ``(radiance (P, 3) after the firefly clamp,
        rays traced (0-d))``."""
        dev = self.device
        n = pix.shape[0]
        seed = rng.tea(pix, frame * self.spp + sample)
        origin, direction, seed = camera_rays(self.scene.camera, self.width, self.height, pix,
                                              frame, seed)
        origin, direction = self._q(origin, direction)
        radiance = torch.zeros(n, 3, device=dev)
        throughput = torch.ones(n, 3, device=dev)
        absorption = torch.zeros(n, 3, device=dev)
        bsdf_pdf = torch.zeros(n, device=dev)
        tdist = torch.zeros(n, device=dev)
        depth = torch.zeros(n, dtype=torch.int64, device=dev)
        active = torch.ones(n, dtype=torch.bool, device=dev)
        out = torch.zeros(n, 3, device=dev)
        rays = torch.zeros((), dtype=torch.int64, device=dev)
        while bool(active.any()):
            hit, seed = self.accel.closest(origin, direction, seed, active)
            hit.t, hit.u, hit.v = self._q(hit.t, hit.u, hit.v)
            b = _stage_plain(
                self.scene, self.features, self.full_mis, self.p_select_light, self.hdr_mult,
                hit, origin, direction, seed, active, radiance, throughput, absorption, bsdf_pdf,
                self.instances, True, (self.spread, None) if self.use_mips else None, tdist)
            nee, light_dir, light_dist, new_origin = self._q(
                b["nee"], b["light_dir"], b["light_dist"], b["new_origin"])
            occluded, seed = self.accel.occluded(new_origin, light_dir, light_dist, b["seed"],
                                                 b["visible"])
            # the bounce's epilogue (``pool._retire_plain`` under the port's
            # defaults, Russian roulette from depth 0): the shadow ray's
            # light, Russian roulette, the depth gate, the firefly clamp
            alive, visible = b["alive"], b["visible"]
            rr_pcont = b["rr_pcont"]
            radiance = b["radiance"] + torch.where((visible & ~occluded)[..., None], nee, 0.0)
            seed, u_rr = rng.rand(seed)
            alive = alive & ~(u_rr >= rr_pcont)
            throughput = torch.where(
                alive[..., None], b["throughput"] / torch.clamp(rr_pcont, min=1e-9)[..., None],
                b["throughput"])
            depth = depth + active.long()
            alive = alive & (depth < self.depth)
            died = active & ~alive
            lum = firefly_luminance(radiance)
            scale = torch.where(lum > self.clamp, self.clamp / torch.clamp(lum, min=1e-20), 1.0)
            out = torch.where(died[:, None], radiance * scale[..., None], out)
            rays = rays + active.sum() + visible.sum()
            bsdf_pdf = torch.where(alive, b["pdf_b"], bsdf_pdf)
            origin, direction = self._q(new_origin, b["new_dir"])
            radiance, throughput, absorption = self._q(radiance, throughput, b["absorption"])
            tdist = self._q(b["tdist"])
            active = alive
        return out, rays


def render_sun_sky():
    """The scene's sun&sky: the defaults of the reference application
    (``sample_example.hpp:175-192``), as both configurations use them."""
    from ..scenes.schema import default_sun_sky

    return default_sun_sky()
