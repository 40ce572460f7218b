"""The unrolled path integrator and the helpers it shares with the pooled
wavefront (counterpart of ``vk_raytrace_tpu/integrator/path.py``).

:func:`trace_paths` carries every ray of a batch through ``cfg.max_depth``
bounces, each bounce one dense masked stage over the whole batch (closest
hit, shade state and material, NEE with MIS, BSDF sample, shadow any-hit,
Russian roulette), as ``samplePixel`` / ``PathTrace`` of
``shaders/pathtrace.glsl`` do per pixel. It is the path of the debug render
modes (``DEBUG_*``: the first hit's state, the last throughput or ray
direction, the traversal step heatmap) and of the BVH-free anchor
(``tracer=``, :mod:`integrator.brute`). Its closest and any hits are the
port's traversal entries with an ``active`` mask: on CUDA tensors the
hand-written kernels (modes a/b, the alpha rounds, the two-level
machines). The helpers: the one-sample NEE strategy density, the BSDF-side
env MIS weight and the ray-cone texture LOD.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.schema import (
    DEBUG_ALPHA, DEBUG_BASECOLOR, DEBUG_EMISSIVE, DEBUG_HEATMAP, DEBUG_METALLIC, DEBUG_NONE,
    DEBUG_NORMAL, DEBUG_RADIANCE, DEBUG_RAYDIR, DEBUG_ROUGHNESS, DEBUG_TANGENT, DEBUG_TEXCOORD,
    DEBUG_WEIGHT, PBR_DISNEY,
)
from ..ops import rng
from ..ops.bsdf_disney import disney_eval, disney_sample
from ..ops.bsdf_gltf import pbr_eval, pbr_sample
from ..ops.env import env_radiance, env_sample, environment_pdf
from ..ops.lights import sample_light
from ..ops.math import dot, firefly_luminance, offset_ray, power_heuristic, temperature
from ..ops.sunsky import SunDisk, sun_disk_consts
from .shade import get_shade_state, resolve_material


def nee_strategy_pdf(full_mis: bool, n_lights: int, use_light, e_pdf, p_select_light: float):
    """Effective pdf of the NEE strategy: with full MIS, P(pick lights)/n for
    punctual lights and P(pick env)*alias_pdf for the environment."""
    if not full_mis:
        return torch.where(use_light, 1.0, e_pdf)
    n_lf = float(max(n_lights, 1))
    p_light_sel = p_select_light if n_lights > 0 else 0.0
    return torch.where(use_light, p_light_sel / n_lf, (1.0 - p_light_sel) * e_pdf)


def env_bsdf_mis_weight(scene, bsdf_pdf, direction, p_select_light: float,
                        sun: Optional[SunDisk] = None):
    """Power-heuristic weight of a BSDF-sampled ray that escaped to the
    environment; camera rays (bsdf_pdf == 0) get weight 1. ``sun``: the sun
    disk's constants, where the NEE mixture samples the disk."""
    p_light_sel = p_select_light if scene.n_lights > 0 else 0.0
    pdf_env = environment_pdf(scene.env, direction, sun) * (1.0 - p_light_sel)
    return torch.where(
        bsdf_pdf > 0.0, torch.clamp(power_heuristic(bsdf_pdf, pdf_env), min=0.0), 1.0
    )


def mip_lod_enabled(scene, cfg) -> bool:
    """Ray-cone mip sampling: on when the atlas carries mip chains and
    ``cfg.mip_sample`` is set."""
    return scene.atlas.mip_x is not None and cfg.mip_sample


def pixel_spread(scene, height: int) -> float:
    """Angular radius of one pixel's ray cone: 2 tan(fov/2) / height."""
    tan_half = abs(float(scene.camera.proj_inverse[1, 1]))
    return float(torch.tensor(2.0 * tan_half, dtype=torch.float32) / max(height, 1))


def cone_lod(ss, spread, tdist):
    """Texture-size-independent LOD: uv density + log2(cone width at hit)."""
    return ss["uv_density"] + torch.log2(torch.clamp(spread * tdist, min=1e-20))


class PathState(NamedTuple):
    """Per-ray state across the bounces."""

    origin: torch.Tensor     # (R, 3)
    direction: torch.Tensor  # (R, 3)
    radiance: torch.Tensor   # (R, 3)
    throughput: torch.Tensor # (R, 3)
    absorption: torch.Tensor # (R, 3)
    seed: torch.Tensor       # (R,) uint32 values in int64
    alive: torch.Tensor      # (R,) bool
    debug: torch.Tensor      # (R, 3) debug-mode output
    steps: torch.Tensor      # (R,) int32 traversal nodes over all bounces (heatmap)
    rays: torch.Tensor       # (R,) int64 rays traced (closest-hit + shadow)
    bsdf_pdf: torch.Tensor   # (R,) pdf of the sample that made this ray (0: camera ray)
    tdist: torch.Tensor      # (R,) path length: the ray-cone distance of the mip LOD


def _eval_bsdf(cfg, state, v, n, l):
    if cfg.pbr_mode == PBR_DISNEY:
        return disney_eval(state, v, n, l)
    return pbr_eval(state, v, n, l)


def _sample_bsdf(cfg, state, v, n, seed):
    """``(f, L, pdf, seed')`` of the configured BSDF; with ``full_mis`` the
    lobe mixture's (f, pdf) at the sampled direction, so that sampling and
    NEE share one pdf."""
    if cfg.pbr_mode == PBR_DISNEY:
        f, l, pdf, _is_ss, seed = disney_sample(state, v, n, seed, combined=cfg.full_mis)
        return f, l, pdf, seed
    return pbr_sample(state, v, n, seed, combined=cfg.full_mis)


def _debug_info(cfg, state) -> torch.Tensor:
    """First-hit debug visualisations (``DebugInfo``, pathtrace.glsl:61-83)."""
    mode = cfg.debug_mode
    m = state.mat
    if mode == DEBUG_METALLIC:
        return m.metallic[..., None].expand(-1, 3)
    if mode == DEBUG_NORMAL:
        return (state.normal + 1.0) * 0.5
    if mode == DEBUG_BASECOLOR:
        return m.albedo
    if mode == DEBUG_EMISSIVE:
        return m.emission
    if mode == DEBUG_ALPHA:
        return m.alpha[..., None].expand(-1, 3)
    if mode == DEBUG_ROUGHNESS:
        return m.roughness[..., None].expand(-1, 3)
    if mode == DEBUG_TEXCOORD:
        return torch.cat([state.tex_coord, torch.zeros_like(state.tex_coord[..., :1])], dim=-1)
    if mode == DEBUG_TANGENT:
        return (state.tangent + 1.0) * 0.5
    raise ValueError(f"debug mode {mode} shows no first-hit state")


def _bundle_tracer(scene, packed, pack):
    """``(closest, occluded)`` over the scene's own acceleration structure:
    the two-level rounds for an ``InstancedAccel``, else the bundle's trees."""
    from ..ops.tlas import InstancedAccel, any_hit_instanced, closest_hit_instanced
    from ..ops.traverse_wide import any_hit_bundle, closest_hit_bundle

    if isinstance(packed, InstancedAccel):
        def closest(o, d, seed, active):
            return closest_hit_instanced(packed, pack, o, d, seed=seed, active=active)

        def occluded(o, d, t_max, seed, active):
            return any_hit_instanced(packed, pack, o, d, t_max, seed=seed, active=active)
    else:
        def closest(o, d, seed, active):
            return closest_hit_bundle(packed, pack, o, d, seed, active=active)

        def occluded(o, d, t_max, seed, active):
            return any_hit_bundle(packed, pack, o, d, t_max, seed, active=active)
    return closest, occluded


def trace_paths(scene, packed, cfg, origin, direction, seed, alpha_pack=None, tracer=None,
                features=None) -> PathState:
    """Run the bounce loop for a batch of primary rays; returns the final
    :class:`PathState` (``radiance`` before the firefly clamp).

    ``alpha_pack``: the scene's ``AlphaPack`` (None: no alpha-tested
    triangles). ``tracer``: a traversal back end with ``closest(o, d, seed,
    active)`` and ``occluded(o, d, t_max, seed, active)`` in place of the
    scene's acceleration structure (the BVH-free anchor,
    :class:`integrator.brute.BruteTracer`)."""
    if cfg.use_sun_sky:
        raise ValueError("bake the sun&sky first (render.prepare_sun_sky)")
    r = origin.shape[0]
    dev = origin.device
    zero3 = torch.zeros(r, 3, device=dev)
    st = PathState(
        origin=origin, direction=direction, radiance=zero3,
        throughput=torch.ones(r, 3, device=dev), absorption=zero3, seed=seed,
        alive=torch.ones(r, dtype=torch.bool, device=dev), debug=zero3,
        steps=torch.zeros(r, dtype=torch.int32, device=dev),
        rays=torch.zeros(r, dtype=torch.int64, device=dev),
        bsdf_pdf=torch.zeros(r, device=dev), tdist=torch.zeros(r, device=dev),
    )
    from ..ops.tlas import InstancedAccel

    instances = packed.inst if isinstance(packed, InstancedAccel) else None
    pack = alpha_pack if cfg.use_any_hit else None
    if tracer is not None:
        closest, occluded = tracer.closest, tracer.occluded
    else:
        closest, occluded = _bundle_tracer(scene, packed, pack)
    use_mips = mip_lod_enabled(scene, cfg)
    spread = pixel_spread(scene, cfg.height) if use_mips else None
    p_select_light = 0.5 if cfg.hdr_multiplier > 0.0 else 1.0
    hdr_mult = cfg.hdr_multiplier
    n_lights = int(scene.n_lights)
    sun = sun_disk_consts(scene.sun_sky) if cfg.sun_disk else None
    first_hit_debug = DEBUG_NONE < cfg.debug_mode < DEBUG_RADIANCE

    for depth in range(cfg.max_depth):
        hit, seed = closest(st.origin, st.direction, st.seed, st.alive)
        steps = st.steps + hit.steps
        rays = st.rays + st.alive.long()

        # Environment miss (pathtrace.glsl:203-228)
        miss = st.alive & (hit.tri < 0)
        env = env_radiance(scene.env, sun, hdr_mult, st.direction)
        if cfg.full_mis:
            env = env * env_bsdf_mis_weight(scene, st.bsdf_pdf, st.direction, p_select_light, sun)[..., None]
        radiance = st.radiance + torch.where(miss[..., None], env * st.throughput, 0.0)
        alive = st.alive & ~miss

        # Shade state + material (pathtrace.glsl:231-252)
        ss = get_shade_state(scene.shade_rows, hit.tri, hit.u, hit.v, instances, hit.inst)
        tdist = st.tdist + torch.where(hit.tri >= 0, torch.clamp(hit.t, max=1e30), 0.0)
        lod = cone_lod(ss, spread, tdist) if use_mips else None
        state = resolve_material(
            ss, scene.atlas, st.direction, features=features, tap_rows=scene.tap_rows, lod=lod,
        )
        m = state.mat
        debug = st.debug
        if first_hit_debug and depth == 0:
            debug = torch.where(alive[..., None], _debug_info(cfg, state), debug)

        # Unlit shortcut, absorption + emission (pathtrace.glsl:258-274)
        unlit = alive & m.unlit
        radiance = radiance + torch.where(unlit[..., None], m.albedo * st.throughput, 0.0)
        alive = alive & ~unlit
        exiting = dot(state.normal, state.ffnormal) > 0.0
        absorption = torch.where(exiting[..., None], 0.0, st.absorption)
        radiance = radiance + torch.where(alive[..., None], m.emission * st.throughput, 0.0)
        throughput = st.throughput * torch.where(
            alive[..., None], torch.exp(-absorption * torch.clamp(hit.t, max=1e30)[..., None]), 1.0,
        )

        # Direct light (NEE) with MIS (pathtrace.glsl:97-188)
        v_dir = -st.direction
        seed, u_sel = rng.rand(seed)
        use_light = (u_sel <= p_select_light) if n_lights > 0 else torch.zeros_like(alive)
        seed, u_li = rng.rand(seed)
        n_l = max(n_lights, 1)
        light_index = torch.clamp((u_li * float(n_l)).long(), max=n_l - 1)
        l_int, l_dir, l_dist = sample_light(scene.lights, light_index, state.position)
        e_rad, e_dir, e_pdf, seed = env_sample(scene.env, sun, hdr_mult, seed)
        light_contrib = torch.where(use_light[..., None], l_int, e_rad)
        light_dir = torch.where(use_light[..., None], l_dir, e_dir)
        light_dist = torch.where(use_light, l_dist, 1e32)
        light_pdf = nee_strategy_pdf(cfg.full_mis, n_lights, use_light, e_pdf, p_select_light)
        f_l, pdf_l = _eval_bsdf(cfg, state, v_dir, state.ffnormal, light_dir)
        mis = torch.where(use_light, 1.0, torch.clamp(power_heuristic(light_pdf, pdf_l), min=0.0))
        nee = (
            mis[..., None] * f_l
            * torch.abs(dot(light_dir, state.ffnormal))[..., None]
            * light_contrib
            / torch.clamp(light_pdf, min=1e-9)[..., None]
        )
        visible = alive & (dot(light_dir, state.ffnormal) > 0.0)
        nee = nee * throughput  # the throughput before the BSDF update (:278)

        # BSDF sampling (pathtrace.glsl:281-296)
        f_b, l_b, pdf_b, seed = _sample_bsdf(cfg, state, v_dir, state.ffnormal, seed)
        entering = dot(state.ffnormal, l_b) < 0.0
        new_abs = -torch.log(torch.clamp(m.attenuation_color, 1e-6, 1.0)) / torch.clamp(
            m.attenuation_distance, min=1e-9
        )[..., None]
        absorption = torch.where((alive & entering)[..., None], new_abs, absorption)
        pdf_ok = pdf_b > 0.0
        throughput = torch.where(
            (alive & pdf_ok)[..., None],
            throughput * f_b * torch.abs(dot(state.ffnormal, l_b))[..., None]
            / torch.clamp(pdf_b, min=1e-20)[..., None],
            throughput,
        )
        alive = alive & pdf_ok

        # Russian roulette continuation (:309-314), next ray (:316-318)
        rr_pcont = torch.clamp(torch.amax(throughput, dim=-1) * state.eta * state.eta + 0.001, max=0.95)
        if not cfg.rr or depth < cfg.rr_depth:
            rr_pcont = torch.ones_like(rr_pcont)
        going_out = dot(l_b, state.ffnormal) > 0.0
        off_n = torch.where(going_out[..., None], state.ffnormal, -state.ffnormal)
        new_origin = torch.where(alive[..., None], offset_ray(state.position, off_n), st.origin)
        new_dir = torch.where(alive[..., None], l_b, st.direction)

        # Deferred shadow ray (:320-331)
        occ, seed = occluded(new_origin, light_dir, light_dist, seed, visible)
        radiance = radiance + torch.where((visible & ~occ)[..., None], nee, 0.0)
        rays = rays + visible.long()

        # Russian roulette termination (:334-338)
        seed, u_rr = rng.rand(seed)
        if cfg.rr:
            alive = alive & ~(u_rr >= rr_pcont)
            throughput = torch.where(
                alive[..., None], throughput / torch.clamp(rr_pcont, min=1e-9)[..., None], throughput
            )

        if depth == cfg.max_depth - 1:
            if cfg.debug_mode == DEBUG_WEIGHT:
                debug = throughput
            elif cfg.debug_mode == DEBUG_RAYDIR:
                debug = (new_dir + 1.0) * 0.5

        st = PathState(
            origin=new_origin, direction=new_dir, radiance=radiance, throughput=throughput,
            absorption=absorption, seed=seed, alive=alive, debug=debug, steps=steps, rays=rays,
            bsdf_pdf=torch.where(alive, pdf_b, st.bsdf_pdf), tdist=tdist,
        )
    return st


def sample_pixels(scene, packed, cfg, origin, direction, seed, alpha_pack=None, tracer=None,
                  features=None):
    """One sample per ray: :func:`trace_paths`, the firefly clamp and the
    debug outputs (``samplePixel``, pathtrace.glsl:348-387). Returns
    ``(radiance (R, 3), seed', PathState)``."""
    st = trace_paths(scene, packed, cfg, origin, direction, seed, alpha_pack=alpha_pack,
                     tracer=tracer, features=features)
    lum = firefly_luminance(st.radiance)
    clamp = cfg.firefly_clamp
    scale = torch.where(lum > clamp, clamp / torch.clamp(lum, min=1e-20), 1.0)
    radiance = st.radiance * scale[..., None]
    mode = cfg.debug_mode
    if mode == DEBUG_HEATMAP:
        t = (st.steps.float() - cfg.min_heatmap) / max(cfg.max_heatmap - cfg.min_heatmap, 1e-9)
        radiance = temperature(torch.clamp(t, 0.0, 1.0))
    elif mode != DEBUG_NONE and mode != DEBUG_RADIANCE:
        radiance = st.debug  # the first hit's state, the weight or the ray direction
    return radiance, st.seed, st
