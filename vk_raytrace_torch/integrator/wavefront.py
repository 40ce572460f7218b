"""Pooled wavefront integrator with ray regeneration (counterpart of
``vk_raytrace_tpu/integrator/wavefront.py::render_units_pooled``).

A fixed pool of lanes traces paths; a lane whose path ends claims the next
unclaimed (pixel, sample) unit of the slice by an exclusive prefix sum over
the dead lanes, so the pool stays full until the units run out. Units map
to pixels in 8x8 tiles. Each loop iteration runs one bounce for the live
lanes only (gathered, then scattered back), which plays the role of the
reference's tiered tail. A path's random stream is keyed on its pixel and
sample, so the schedule never changes the estimator.

Per bounce: closest hit (opaque kernel, then alpha candidate rounds; in a
two-level scene, instance candidate rounds over per-mesh BVHs, ``ops/tlas.py``),
shade state and material, NEE with MIS, a BSDF sample (glTF or Disney, by
``cfg.pbr_mode``), shadow any-hit, Russian roulette, and a scatter of
finished paths into the per-unit image. With ``fused_shade`` the shading
runs as one kernel launch per bounce (``integrator/shade_fused.py``)
wherever its static conditions hold (glTF only, as in the reference: the
Disney BSDF always runs the eager stage); the kernel also adds each hit's
distance to the path length (``tdist``).
"""

from __future__ import annotations

import contextlib

import torch

from ..ops import rng
from ..ops.env import env_radiance, env_sample
from ..ops.lights import sample_light
from ..ops.math import dot, firefly_luminance, offset_ray, power_heuristic
from ..ops.sunsky import sun_disk_consts
from ..ops.tlas import InstancedAccel, any_hit_instanced, closest_hit_instanced
from ..ops.traverse_wide import any_hit_bundle, closest_hit_bundle
from .camera import generate_rays_for_pixels
from . import shade_fused
from .path import (
    _eval_bsdf, _sample_bsdf, cone_lod, env_bsdf_mis_weight, mip_lod_enabled, nee_strategy_pdf,
    pixel_spread,
)
from .shade import get_shade_state, resolve_material

# Per-lane path state carried between iterations.
_FIELDS = (
    "pix", "unit", "origin", "direction", "radiance", "throughput",
    "absorption", "seed", "depth", "bsdf_pdf", "tdist",
)


def render_units_pooled(
    scene, packed, cfg, frame: int, pix0: int, n_pix: int, pool: int,
    alpha_pack=None, features=None, fused_shade: bool = False, shade_tables=None, stream=None,
    backend: str = "fused",
):
    """Trace ``n_pix * cfg.max_samples`` paths of pixels ``[pix0, pix0 +
    n_pix)``. A path's random stream is ``rng.tea(pixel, stream * spp +
    sample)``; ``stream`` defaults to ``frame``, which also drives the
    camera jitter (sample shards pass a stream of their own,
    ``parallel/sharding.py``). Returns ``(radiance_mean (n_pix, 3), rays)``; ``rays`` counts
    every traced ray (closest-hit rays plus shadow rays) as a 0-d tensor.
    ``backend``: the traversal back end, "fused" or "wide"
    (``ops/traverse_wide.py``; the wide one needs ``packed``'s 8-wide
    tables).
    ``fused_shade`` asks for the fused shading stage; it runs where
    ``shade_fused.supported`` holds, the unfused stage elsewhere (the
    reference's rule; ``shade_fused.supported`` says which ran).
    ``shade_tables``: the fused stage's ``StageTables`` (built here when
    None and the fused stage runs)."""
    if cfg.use_sun_sky:
        raise ValueError("bake the sun&sky first (render.prepare_sun_sky)")
    dev = scene.shade_rows.device
    w, h = cfg.width, cfg.height
    spp = cfg.max_samples
    total_units = n_pix * spp
    stream = frame if stream is None else stream
    tiled = w % 8 == 0 and n_pix % (w * 8) == 0
    tiles_x = w // 8
    use_mips = mip_lod_enabled(scene, cfg)
    spread = pixel_spread(scene, h) if use_mips else None
    p_select_light = 0.5 if cfg.hdr_multiplier > 0.0 else 1.0
    hdr_mult = cfg.hdr_multiplier
    clamp = cfg.firefly_clamp
    n_lights = int(scene.n_lights)
    pack = alpha_pack if cfg.use_any_hit else None
    use_fused = shade_fused.supported(fused_shade, cfg, scene, features)
    instances = packed.inst if isinstance(packed, InstancedAccel) else None
    if use_fused and shade_tables is None:
        shade_tables = shade_fused.stage_tables(scene, instances)
    # The sun disk's per-scene constants, once per call (the eager stage).
    sun = sun_disk_consts(scene.sun_sky) if cfg.sun_disk and not use_fused else None

    def closest(o, d, seed):
        if instances is not None:
            return closest_hit_instanced(packed, pack, o, d, seed=seed, backend=backend)
        return closest_hit_bundle(packed, pack, o, d, seed, backend=backend)

    def occluded(o, d, t_max, seed, active):
        if instances is not None:
            return any_hit_instanced(packed, pack, o, d, t_max, seed=seed, active=active,
                                     backend=backend)
        return any_hit_bundle(packed, pack, o, d, t_max, seed, active=active, backend=backend)

    def unit_to_local(p_rank):
        t_id = p_rank // 64
        w_in = p_rank % 64
        lx = (t_id % tiles_x) * 8 + (w_in % 8)
        ly = (t_id // tiles_x) * 8 + (w_in // 8)
        return ly * w + lx

    p = pool
    st = dict(
        pix=torch.zeros(p, dtype=torch.int64, device=dev),
        unit=torch.zeros(p, dtype=torch.int64, device=dev),
        origin=torch.zeros(p, 3, device=dev),
        direction=torch.zeros(p, 3, device=dev),
        radiance=torch.zeros(p, 3, device=dev),
        throughput=torch.zeros(p, 3, device=dev),
        absorption=torch.zeros(p, 3, device=dev),
        seed=torch.zeros(p, dtype=torch.int64, device=dev),
        depth=torch.zeros(p, dtype=torch.int64, device=dev),
        bsdf_pdf=torch.zeros(p, device=dev),
        tdist=torch.zeros(p, device=dev),
    )
    active = torch.zeros(p, dtype=torch.bool, device=dev)
    out = torch.zeros(total_units, 3, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    next_unit = 0

    def regenerate(active, next_unit):
        dead = ~active
        rank = torch.cumsum(dead.long(), 0) - dead.long()
        unit = next_unit + rank
        granted = dead & (unit < total_units)
        n_granted = min(int(dead.sum()), total_units - next_unit)
        p_rank = unit // spp
        local = unit_to_local(p_rank) if tiled else p_rank
        upix = pix0 + local
        usamp = unit % spp
        seed_new = rng.tea(upix, stream * spp + usamp)
        o, d, seed_new = generate_rays_for_pixels(scene.camera, w, h, upix, frame, seed_new)
        g3 = granted[:, None]
        st["pix"] = torch.where(granted, upix, st["pix"])
        st["unit"] = torch.where(granted, unit, st["unit"])
        st["origin"] = torch.where(g3, o, st["origin"])
        st["direction"] = torch.where(g3, d, st["direction"])
        st["radiance"] = torch.where(g3, 0.0, st["radiance"])
        st["throughput"] = torch.where(g3, 1.0, st["throughput"])
        st["absorption"] = torch.where(g3, 0.0, st["absorption"])
        st["seed"] = torch.where(granted, seed_new, st["seed"])
        st["depth"] = torch.where(granted, 0, st["depth"])
        st["bsdf_pdf"] = torch.where(granted, 0.0, st["bsdf_pdf"])
        st["tdist"] = torch.where(granted, 0.0, st["tdist"])
        return active | granted, next_unit + n_granted

    def shade_stage(s, hit, seed):
        """The XLA shading stage of the reference, clause for clause."""
        # Environment miss (pathtrace.glsl:203-228); every lane here is live.
        miss = hit.tri < 0
        env = env_radiance(scene.env, sun, hdr_mult, s["direction"])
        if cfg.full_mis:
            w_env = env_bsdf_mis_weight(scene, s["bsdf_pdf"], s["direction"], p_select_light, sun)
            env = env * w_env[..., None]
        radiance = s["radiance"] + torch.where(miss[..., None], env * s["throughput"], 0.0)
        alive = ~miss

        ss = get_shade_state(scene.shade_rows, hit.tri, hit.u, hit.v, instances, hit.inst)
        tdist = s["tdist"] + torch.where(hit.tri >= 0, torch.clamp(hit.t, max=1e30), 0.0)
        lod = cone_lod(ss, spread, tdist) if use_mips else None
        state = resolve_material(
            ss, scene.atlas, s["direction"], features=features,
            tap_rows=scene.tap_rows, lod=lod,
        )
        m = state.mat

        # Unlit shortcut, absorption + emission (pathtrace.glsl:258-274)
        unlit = alive & m.unlit
        radiance = radiance + torch.where(unlit[..., None], m.albedo * s["throughput"], 0.0)
        alive = alive & ~unlit
        exiting = dot(state.normal, state.ffnormal) > 0.0
        absorption = torch.where(exiting[..., None], 0.0, s["absorption"])
        radiance = radiance + torch.where(alive[..., None], m.emission * s["throughput"], 0.0)
        throughput = s["throughput"] * torch.where(
            alive[..., None],
            torch.exp(-absorption * torch.clamp(hit.t, max=1e30)[..., None]),
            1.0,
        )

        # Direct light (NEE) with MIS (pathtrace.glsl:97-188)
        v_dir = -s["direction"]
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
        mis = torch.where(
            use_light, 1.0, torch.clamp(power_heuristic(light_pdf, pdf_l), min=0.0)
        )
        nee = (
            mis[..., None] * f_l
            * torch.abs(dot(light_dir, state.ffnormal))[..., None]
            * light_contrib
            / torch.clamp(light_pdf, min=1e-9)[..., None]
        )
        visible = alive & (dot(light_dir, state.ffnormal) > 0.0)
        nee = nee * throughput

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
        rr_pcont = torch.clamp(torch.amax(throughput, dim=-1) * state.eta * state.eta + 0.001, max=0.95)
        going_out = dot(l_b, state.ffnormal) > 0.0
        off_n = torch.where(going_out[..., None], state.ffnormal, -state.ffnormal)
        new_origin = torch.where(alive[..., None], offset_ray(state.position, off_n), s["origin"])
        new_dir = torch.where(alive[..., None], l_b, s["direction"])
        return (
            radiance, alive, throughput, absorption, new_origin, new_dir,
            nee, light_dir, light_dist, visible, rr_pcont, pdf_b, seed, tdist,
        )

    def shade_stage_fused(s, hit, seed):
        """The same clauses as :func:`shade_stage` in one kernel launch,
        which also adds the hit's t to the path length."""
        # bounce() receives the live lanes only, so every lane is active.
        out = shade_fused.shade_bounce_fused(
            scene, features, cfg.full_mis, p_select_light, hdr_mult, hit, s["origin"],
            s["direction"], seed, None, s["radiance"], s["throughput"], s["absorption"],
            s["bsdf_pdf"], instances=instances, sun_disk=cfg.sun_disk,
            mip=(spread, None) if use_mips else None, path_tdist=s["tdist"],
            tables=shade_tables,
        )
        return tuple(out[k] for k in (
            "radiance", "alive", "throughput", "absorption", "new_origin", "new_dir",
            "nee", "light_dir", "light_dist", "visible", "rr_pcont", "pdf_b", "seed", "tdist",
        ))

    def bounce(s):
        """One bounce for a batch of live lanes; returns the new state and
        the lanes still alive."""
        hit, seed = closest(s["origin"], s["direction"], s["seed"])
        n_rays = hit.tri.shape[0]
        # A profiler range read by chip_profile.py, entered only while a
        # profiler runs: it costs a dispatcher call per bounce otherwise.
        stage_range = (
            torch.profiler.record_function("shade_stage")
            if torch.autograd._profiler_enabled() else contextlib.nullcontext()
        )
        with stage_range:
            (
                radiance, alive, throughput, absorption, new_origin, new_dir,
                nee, light_dir, light_dist, visible, rr_pcont, pdf_b, seed, tdist,
            ) = (shade_stage_fused if use_fused else shade_stage)(s, hit, seed)
        rr_gate = s["depth"] >= cfg.rr_depth if cfg.rr else torch.zeros_like(alive)
        rr_pcont = torch.where(rr_gate, rr_pcont, 1.0)

        # Deferred shadow ray (:320-331)
        occ, seed = occluded(new_origin, light_dir, light_dist, seed, visible)
        radiance = radiance + torch.where((visible & ~occ)[..., None], nee, 0.0)
        shadow_rays = visible.sum()

        # Russian roulette (:334-338)
        seed, u_rr = rng.rand(seed)
        if cfg.rr:
            alive = alive & ~(rr_gate & (u_rr >= rr_pcont))
            throughput = torch.where(
                alive[..., None], throughput / torch.clamp(rr_pcont, min=1e-9)[..., None], throughput
            )
        depth = s["depth"] + 1
        alive = alive & (depth < cfg.max_depth)
        s = dict(
            pix=s["pix"], unit=s["unit"], origin=new_origin, direction=new_dir,
            radiance=radiance, throughput=throughput, absorption=absorption,
            seed=seed, depth=depth,
            bsdf_pdf=torch.where(alive, pdf_b, s["bsdf_pdf"]),
            tdist=tdist,
        )
        return s, alive, n_rays + shadow_rays

    while next_unit < total_units or bool(active.any()):
        active, next_unit = regenerate(active, next_unit)
        live = torch.nonzero(active).squeeze(1)
        if live.numel() == p:
            sub, alive, n = bounce(st)
            st = sub
        else:
            sub, alive, n = bounce({k: st[k][live] for k in _FIELDS})
            for k in _FIELDS:
                st[k][live] = sub[k]
        rays = rays + n
        died = ~alive
        # Path termination: firefly clamp, then write the unit's radiance.
        rad = sub["radiance"][died]
        lum = firefly_luminance(rad)
        scale = torch.where(lum > clamp, clamp / torch.clamp(lum, min=1e-20), 1.0)
        out[sub["unit"][died]] = rad * scale[..., None]
        if live.numel() == p:
            active = alive
        else:
            active = active.clone()
            active[live] = alive

    img = out.reshape(n_pix, spp, 3).sum(dim=1) / float(spp)
    if tiled:
        # Un-swizzle: pixel-rank of every slice-local pixel (closed form).
        local = torch.arange(n_pix, device=dev)
        y, x = local // w, local % w
        img = img[((y // 8) * tiles_x + (x // 8)) * 64 + (y % 8) * 8 + (x % 8)]
    return img, rays
