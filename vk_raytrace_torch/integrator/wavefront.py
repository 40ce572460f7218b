"""Pooled wavefront integrator with ray regeneration (counterpart of
``vk_raytrace_tpu/integrator/wavefront.py::render_units_pooled``).

A fixed pool of lanes traces paths; a lane whose path ends claims the next
unclaimed (pixel, sample) unit of the slice by an exclusive prefix sum over
the dead lanes, so the pool stays full until the units run out. Units map
to pixels in 8x8 tiles. A path's random stream is keyed on its pixel and
sample, so the schedule never changes the estimator.

The loop has the reference's form: the state spans the whole pool and every
stage takes the ``active`` mask; once the units run out, a pool of at least
8192 lanes is cut to a quarter of its width while more than a sixteenth is
live, then to a sixteenth (the tiered tail, a stable partition that keeps
the live lanes in lane order). Regeneration and the bounce's epilogue are
one kernel each (``integrator/pool.py``, ``csrc/wavefront.cu``), and the
loop's control (next unit, live lanes, rays) stays on the device: the host
reads it once an iteration, as the reference's while-loop tests its
condition, and nothing else in an iteration waits for the device.

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
from ..ops.math import dot, offset_ray, power_heuristic
from ..ops.sunsky import sun_disk_consts
from ..ops.tlas import InstancedAccel, any_hit_instanced, closest_hit_instanced
from ..ops.traverse_wide import any_hit_bundle, closest_hit_bundle
from . import pool as lanes
from . import shade_fused
from .path import (
    _eval_bsdf, _sample_bsdf, cone_lod, env_bsdf_mis_weight, mip_lod_enabled, nee_strategy_pdf,
    pixel_spread,
)
from .shade import get_shade_state, resolve_material

# Pools of this many lanes or more run the tiered tail (the reference's rule).
TIER_MIN_POOL = 8192
# The loop's own counts: iterations, and the host's reads of the loop
# control (one an iteration).
LOOP = {"iterations": 0, "host_reads": 0}
# With CHECK_SYNCS, each iteration's device work on a CUDA pool runs under
# torch's sync debug mode "error": a host sync there raises.
CHECK_SYNCS = False


def reset_counts() -> None:
    for k in LOOP:
        LOOP[k] = 0


@contextlib.contextmanager
def _no_sync(dev):
    if not (CHECK_SYNCS and dev.type == "cuda"):
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class _ControlReader:
    """The loop control's one read an iteration: ``(next_unit, live,
    rays)``, through pinned memory on the card."""

    def __init__(self, ctrl):
        self.ctrl = ctrl
        if ctrl.device.type == "cuda":
            self.host = torch.empty(3, dtype=torch.int64, pin_memory=True)
            self.done = torch.cuda.Event()

    def read(self):
        LOOP["host_reads"] += 1
        if self.ctrl.device.type != "cuda":
            return self.ctrl.tolist()
        self.host.copy_(self.ctrl, non_blocking=True)
        self.done.record()
        self.done.synchronize()
        return self.host.tolist()


def render_units_pooled(
    scene, packed, cfg, frame: int, pix0: int, n_pix: int, pool: int,
    alpha_pack=None, features=None, fused_shade: bool = False, shade_tables=None, stream=None,
    backend: str = "fused", track_steps: bool = False, track_occupancy: bool = False,
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
    None and the fused stage runs).
    With ``track_steps`` or ``track_occupancy`` it returns ``(radiance,
    rays, steps, occ)``: ``steps`` (n_pix,) int32, each pixel's closest-hit
    traversal steps summed over its paths' bounces (``track_steps``, else
    None); ``occ`` (1024,) int32, the lanes active at each iteration's
    bounce, -1 past the last iteration (``track_occupancy``, else None),
    as the reference records them."""
    if cfg.use_sun_sky:
        raise ValueError("bake the sun&sky first (render.prepare_sun_sky)")
    dev = scene.shade_rows.device
    h = cfg.height
    spp = cfg.max_samples
    total_units = n_pix * spp
    stream = frame if stream is None else stream
    sl = lanes.make_slice(scene.camera, cfg, n_pix, pix0, stream, frame)
    use_mips = mip_lod_enabled(scene, cfg)
    spread = pixel_spread(scene, h) if use_mips else None
    p_select_light = 0.5 if cfg.hdr_multiplier > 0.0 else 1.0
    hdr_mult = cfg.hdr_multiplier
    n_lights = int(scene.n_lights)
    pack = alpha_pack if cfg.use_any_hit else None
    use_fused = shade_fused.supported(fused_shade, cfg, scene, features)
    instances = packed.inst if isinstance(packed, InstancedAccel) else None
    if use_fused and shade_tables is None:
        shade_tables = shade_fused.stage_tables(scene, instances)
    # The sun disk's per-scene constants, once per call (the eager stage).
    sun = sun_disk_consts(scene.sun_sky) if cfg.sun_disk and not use_fused else None

    def closest(o, d, seed, active):
        if instances is not None:
            return closest_hit_instanced(packed, pack, o, d, seed=seed, active=active,
                                         backend=backend)
        return closest_hit_bundle(packed, pack, o, d, seed, active=active, backend=backend)

    def occluded(o, d, t_max, seed, active):
        if instances is not None:
            return any_hit_instanced(packed, pack, o, d, t_max, seed=seed, active=active,
                                     backend=backend)
        return any_hit_bundle(packed, pack, o, d, t_max, seed, active=active, backend=backend)

    def shade_stage(s, hit, seed):
        """The XLA shading stage of the reference, clause for clause."""
        # Environment miss (pathtrace.glsl:203-228)
        miss = s["active"] & (hit.tri < 0)
        env = env_radiance(scene.env, sun, hdr_mult, s["direction"])
        if cfg.full_mis:
            w_env = env_bsdf_mis_weight(scene, s["bsdf_pdf"], s["direction"], p_select_light, sun)
            env = env * w_env[..., None]
        radiance = s["radiance"] + torch.where(miss[..., None], env * s["throughput"], 0.0)
        alive = s["active"] & ~miss

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
        out = shade_fused.shade_bounce_fused(
            scene, features, cfg.full_mis, p_select_light, hdr_mult, hit, s["origin"],
            s["direction"], seed, s["active"], s["radiance"], s["throughput"], s["absorption"],
            s["bsdf_pdf"], instances=instances, sun_disk=cfg.sun_disk,
            mip=(spread, None) if use_mips else None, path_tdist=s["tdist"],
            tables=shade_tables,
        )
        return tuple(out[k] for k in (
            "radiance", "alive", "throughput", "absorption", "new_origin", "new_dir",
            "nee", "light_dir", "light_dist", "visible", "rr_pcont", "pdf_b", "seed", "tdist",
        ))

    def iteration(st, it):
        """Regeneration and one bounce over the whole pool, under its mask."""
        lanes.regenerate(st, ctrl, occ, it, sl)
        hit, seed = closest(st["origin"], st["direction"], st["seed"], st["active"])
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
            ) = (shade_stage_fused if use_fused else shade_stage)(st, hit, seed)
        # Deferred shadow ray (:320-331), then the epilogue (:334-472).
        occl, seed = occluded(new_origin, light_dir, light_dist, seed, visible)
        st.update(origin=new_origin, direction=new_dir, absorption=absorption, tdist=tdist)
        lanes.retire(st, dict(
            alive=alive, visible=visible, occluded=occl, radiance=radiance,
            throughput=throughput, nee=nee, rr_pcont=rr_pcont, pdf_b=pdf_b, seed=seed,
            hit_steps=hit.steps,
        ), ctrl, out, steps, sl)

    p = pool
    st = lanes.empty_pool(p, dev)
    ctrl = torch.zeros(3, dtype=torch.int64, device=dev)  # next_unit, live, rays
    out = torch.zeros(total_units + p, 3, device=dev)
    steps = torch.zeros(n_pix + 1, dtype=torch.int32, device=dev) if track_steps else None
    occ = torch.full((lanes.OCC_LEN,), -1, dtype=torch.int32, device=dev) if track_occupancy else None
    reader = _ControlReader(ctrl)

    # The reference's conditions: full width while units remain or more
    # than a quarter of the lanes live, a quarter while more than a
    # sixteenth live, a sixteenth until none is.
    def any_left(next_unit, live):
        return next_unit < total_units or live > 0

    if p >= TIER_MIN_POOL:
        q, s16 = p // 4, p // 16
        tiers = ((p, lambda nu, live: nu < total_units or live > q),
                 (q, lambda nu, live: live > s16), (s16, any_left))
    else:
        tiers = ((p, any_left),)
    next_unit = live = it = 0
    for width, keep_going in tiers:
        if width < st["active"].shape[0]:
            st = lanes.compact(st, width)
        while keep_going(next_unit, live):
            with _no_sync(dev):
                iteration(st, it)
            next_unit, live, _ = reader.read()
            it += 1
            LOOP["iterations"] += 1

    img = out[:total_units].reshape(n_pix, spp, 3).sum(dim=1) / float(spp)
    if sl.tiled:
        # Un-swizzle: pixel-rank of every slice-local pixel (closed form).
        w, tiles_x = cfg.width, cfg.width // 8
        local = torch.arange(n_pix, device=dev)
        y, x = local // w, local % w
        img = img[((y // 8) * tiles_x + (x // 8)) * 64 + (y % 8) * 8 + (x % 8)]
    rays = ctrl[2].clone()
    if track_steps or track_occupancy:
        return img, rays, steps[:n_pix] if steps is not None else None, occ
    return img, rays
