#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases, each printing its own lines (any failure raises and exits non-zero):

1. environment: the card's name and power limit; CUDA must be available;
2. build: the traversal kernels (``vk_raytrace_torch/csrc/traverse.cu``,
   one library per row width) and the shading kernel (``shade.cu``), nvcc
   processes started together, and the native host runtime
   (``csrc/native.cpp``, g++), from this checkout;
3. traversal kernel against its plain torch twin on the card, for modes a
   (closest hit), b (any hit) and c (alpha candidates), on the full atrium's
   trees at 2^18 rays (the main path's pool width), and both timed there;
   modes a and b (the persistent entry) bit for bit in t, tri, u, v and
   steps, each printed with its registers, stack frame and spill (ptxas),
   its resident blocks per SM, the deepest stack its rays reached and the
   tree's stack bound;
4. the render slice on the card against the same slice on the CPU twin:
   a small atrium at 128x72, depth 4, 1 spp, 2 frames, identical tables and
   random streams; then the same with the fused shading stage on the card
   and on the CPU, and fused against unfused on the card;
5. the main path: the full atrium (~217k triangles) at 1920x1080, depth 4,
   1 spp, sun&sky, one warm-up and three timed frames; modes a and b and the
   alpha rounds kernel must have launched, and the per-round mode c not;
6. the shading stage kernel (``vkrt_shade_stage``, the whole fused stage)
   against the plain stage (``shade_inputs`` + ``_shade_plain``) on the
   card at 2^18 lanes: the hits of atrium camera rays with random lane
   states, sun disk / full MIS / mip LOD each both ways, then every branch through a
   synthetic shade-row and tap-row table (``tri = arange(R)``); each timed,
   with its ``stage_bytes`` bound and the ptxas report of each
   instantiation; then the body alone (``vkrt_shade``) on gathered inputs:
   the camera hits, and every branch with full MIS on and off; timed;
7. the main path with the fused shading stage (``Renderer(...,
   fused_shade=True)``): one warm-up and three timed frames; the stage
   kernel and the kernels of phase 5 must have launched, and neither the
   body alone nor the per-round mode c;
8. traversal with per-lane roots (the two-level path's kernel modes)
   against its twin on the full bistro (579k unique, >1M instanced
   triangles) at 2^18 rays: each ray's first instance candidate, moved into
   that instance's object space; modes a and b over the opaque-subset
   table, c over the alpha-subset table toward the foliage; all timed;
9. the two-level render slice on the card against the CPU twin: a small
   bistro at 128x72, depth 4, 1 spp, 2 frames, unfused and fused, and
   fused against unfused on the card;
10. the instanced stage kernel against the plain stage at 2^18 lanes as in
    phase 6, on the bistro's camera hits (with their instances); then the
    instanced body alone on gathered inputs; timed;
11. the two-level main path: the full bistro through
    ``build_instanced_scene`` and ``Renderer(..., fused_shade=True)`` at
    1920x1080, depth 4, 1 spp, glTF PBR, sun&sky, firefly clamp 10,
    full_mis off; one warm-up and three timed frames; the opaque machine,
    the alpha machine and the stage kernel must have launched, and no
    per-round kernel with roots and not the body alone;
12. the width-32 traversal kernel (1024-byte rows, 16-triangle leaves)
    against its twin: the full atrium's width-32 trees on phase 3's ray
    sets, then per-lane roots on the full bistro's width-32 tables on phase
    8's; all timed;
13. the child sort (``sort_children``) against its plain version at 2^18
    rows of 16 and of 32 keys with ties, misses and NaN, exact; timed beside
    one stable ``torch.sort``;
14. the traversal micro-bench (``vk_raytrace_torch.travbench``) at full
    size on the atrium, widths 16 and 32: each capped and no-gather kernel
    against its plain version (exact) and timed, with the full traversal
    and the root child order; the capped, no-gather and sort kernels must
    have launched;
15. the atrium main path at width 32 (``build_accel_bundle(geom,
    width=32)``, fused shading), beside phase 7: the width-32 kernels of
    phase 5 and the stage kernel must have launched, and no width-16
    kernel, no per-round mode c and not the body alone;
16. the bistro main path at width 32 (``build_instanced_scene(...,
    width=32)``), beside phase 11: the same for the opaque and alpha
    machines;
17. the alpha machine kernel (``vkrt_alpha_machine``, the two-level alpha
    pass of ``ops/tlas.py`` in one launch) on the full bistro at 2^18 rays
    toward the foliage, at widths 16 and 32, closest and any hit: exact on
    tri/inst/seed/steps against the round loop driving the per-round kernel
    (mode c with roots, held against its twin in phases 8 and 12) and
    against the fully plain round loop (the twin in every round); the
    kernel, the round loop (its wall and device time) and the plain loop
    timed, the bound counted from the plain run;
18. the single-level alpha rounds kernel (``vkrt_alpha_rounds``,
    ``ops/traverse_alpha.py``'s rounds in one launch) on the full atrium at
    2^18 rays toward the banners, at widths 16 and 32, closest (windowed by
    the opaque hit) and any hit: the same comparisons and times as phase 17,
    against the round loop driving the per-round mode c;
19. the two-level opaque machine kernel (``vkrt_opaque_machine``, the
    opaque rounds of ``ops/tlas.py`` in one launch) on the full bistro at
    2^18 camera rays, at widths 16 and 32, closest and any hit, over the
    opaque subsets and over the full table: the same, against the round
    loop driving modes a/b with roots.

Phases 17-19 also print how each machine's rounds spread over its warps
(32 consecutive rays): the mean rounds per ray, the mean of each warp's
most, and the share of the warps' lane-rounds that do work.

The line before the last is the per-kernel JSON summary (times, launches,
errors and each kernel's bound on this card); the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCE = "vk_raytrace_torch/csrc/traverse.cu"
REPLACES = "vk_raytrace_tpu/ops/traverse_fused.py:255"  # _make_step_kernel
ROOTS_REPLACES = "vk_raytrace_tpu/ops/traverse_fused.py:724"  # root0 (mode d)
SORT_REPLACES = "tests/test_fused.py:88"  # the pallas_call around _bitonic
# The mode-c step kernel with per-lane roots, launched once per round by the
# reference's _two_level_alpha_pass: the rounds the alpha machine runs whole.
MACHINE_REPLACES = "vk_raytrace_tpu/ops/tlas.py:695"
# The step kernel as the reference's single-level alpha rounds and its
# two-level opaque rounds call it, once per round: the rounds the alpha
# rounds kernel and the opaque machine run whole.
ROUNDS_REPLACES = "vk_raytrace_tpu/ops/traverse_alpha.py:128"
OPAQUE_REPLACES = "vk_raytrace_tpu/ops/tlas.py:495"
NOGATHER_REPLACES = "scripts/stepbench.py:121"  # the no-gather step kernel
SHADE_SOURCE = "vk_raytrace_torch/csrc/shade.cu"
SHADE_REPLACES = "vk_raytrace_tpu/integrator/shade_fused.py:290"  # _make_kernel
SHADE_INST_REPLACES = "vk_raytrace_tpu/integrator/shade_fused.py:367"  # instanced
# The whole stage: shade_bounce_fused (:901), its pallas_call (:1094) and
# the XLA prologue around it.
STAGE_REPLACES = "vk_raytrace_tpu/integrator/shade_fused.py:1094"
# Bytes, operations and bounds of the traversal kernel's calls, and the
# card's peak rates, are counted by vk_raytrace_torch/travbench.py.
# Float operations of one shading lane, counted from csrc/shade.cu for the
# atrium's flags (base texture, full MIS), each add, multiply, divide,
# square root, min/max, compare or transcendental as one: shade state ~260,
# material ~120, NEE with its BSDF evaluation ~260, BSDF sample ~400 and its
# full-MIS evaluation ~220, the rest ~110. Bytes set the bound by 10x.
SHADE_OPS_PER_LANE = 1400
# The instanced variant adds the transform of position, both normals and
# the tangent (9 products and 6 sums each, 3 more sums for the position)
# and three normalisations of 9 operations: 90.
SHADE_INST_OPS_PER_LANE = SHADE_OPS_PER_LANE + 90
# The stage's prologue, counted from csrc/shade.cu: 11-12 PCG draws (~8 integer
# operations and a conversion each, ~100), the uv transform and ray-cone LOD
# (~45), each enabled texture's placement, mip level and two wrapped axes
# (~45 each), the light sample (~60) or the env sample (alias and bilinear
# tap ~55, with the sun cone and disk ~110 more), and on a miss the env tap,
# disk and MIS weight (~150 on the few miss lanes): ~400 for the atrium's
# one texture with the sun disk.
STAGE_PROLOGUE_OPS = 400
# The alpha machine's work beside its traversal nodes, counted from
# csrc/traverse.cu: per round the window start and the ray transform (3
# multiply-adds, then 9 products and 9 sums for the origin, 9 and 6 for the
# direction, 3 reciprocals: 42); per candidate the alpha test (uv transform,
# texel index, opacity and the PCG draw as float operations: about 20). Its
# bytes: rays in (origin, direction, t_max, active, seed: 37 B) and out (t,
# tri, u, v, inst, steps, seed: 32 B), the instance table once (76 B an
# instance), each distinct alpha BLAS row once, and per candidate its
# 64-byte AlphaPack row and one 32-byte texel sector. Its per-round scan of
# the instance boxes is this design's choice, not counted.
MACHINE_ROUND_OPS, MACHINE_CAND_OPS = 42, 20
MACHINE_RAY_BYTES, MACHINE_INST_BYTES, MACHINE_CAND_BYTES = 37 + 32, 76, 64 + 32
# The single-level alpha rounds kernel: per round the window start (3
# multiply-adds), its end (a subtract and a compare) and the root union box's
# slab test (6 subtracts, 6 multiplies, 10 min/max, 3 compares): 33; per
# candidate the alpha test as above. Its bytes: rays in (origin, direction,
# t_limit, active, seed: 37 B) and out (t, tri, u, v, steps, seed: 28 B), each
# distinct alpha row once, and per candidate its AlphaPack row and texel.
ROUNDS_ROUND_OPS, ROUNDS_RAY_BYTES = 33, 37 + 28
# The opaque machine: per round the transform of the world origin and
# direction (9 products and 9 sums, 9 and 6, 3 reciprocals: 36). Its bytes:
# rays in (origin, direction, t_max, active: 29 B) and out (t, tri, u, v,
# inst, steps: 24 B), the instance table once and each distinct BLAS row once.
# Its per-round instance scan is this design's choice, not counted.
OPAQUE_ROUND_OPS, OPAQUE_RAY_BYTES = 36, 29 + 24
# The bistro's render configuration (BASELINE config #5,
# scripts/baseline_configs.py:74-75, 93-97), at the main path's size.
BISTRO_CFG = dict(max_depth=4, max_samples=1, hdr_multiplier=1.0, firefly_clamp=10.0,
                  use_sun_sky=True, full_mis=False)
# Shading kernel vs its plain version on the card: the same float32
# operations in the same order with the same device math functions.
SHADE_RTOL, SHADE_ATOL, SHADE_MASK_SHARE = 1e-5, 1e-6, 0.9999
SMALL_ATRIUM = dict(bays_x=2, bays_z=2, column_segments=16, column_rows=12)
# The single-level main path's kernels (LAUNCHES keys at width 16): modes a
# and b over the opaque tree, the alpha rounds over the alpha tree.
ATRIUM_KERNELS = ("closest", "any", "alpha_rounds")
# Kernel vs twin: the same float32 operations in the same order, rounded
# per operation on both sides (nvcc -fmad=false); t/u/v within a few ulp.
RTOL, ATOL = 1e-5, 1e-5
# Slice vs CPU twin: the CUDA and CPU math libraries round transcendentals
# differently, which flips a rare Russian-roulette or alpha branch.
PIX_RTOL, PIX_ATOL, PIX_SHARE, RAY_REL = 1e-3, 1e-4, 0.99, 1e-3


def phase(name):
    print(f"== {name}", flush=True)


def shade_bytes(n, flags):
    """Bytes the shading kernel moves for ``n`` lanes under ``flags``,
    counted from csrc/shade.cu in 32-byte sectors: the merged-row lanes it
    loads (not the uv-transform and texture-placement lanes, which the
    prologue reads, nor the row's padding), the taps and footprint weights
    of the enabled textures, the rest of aux, and the outputs."""
    from vk_raytrace_torch.integrator import shade_fused as sf
    from vk_raytrace_torch.integrator.shade import _OFFS

    def mat(name, k=1):
        return range(sf._SROW_MAT0 + _OFFS[name], sf._SROW_MAT0 + _OFFS[name] + k)

    # vertex positions, normals, tangents and handedness; vertex colours
    srow = [*range(0, 22), *range(28, 34)]
    for name, k in (("emissive_factor", 3), ("ior", 1), ("rough_f", 1), ("metal_f", 1),
                    ("base_factor", 3), ("transmission_f", 1), ("unlit", 1), ("aniso", 1),
                    ("atten_color", 3), ("atten_dist", 1), ("thickness", 1), ("cc_f", 1),
                    ("cc_rough", 1)):
        srow += mat(name, k)
    taps, aux = [], [*range(10, sf.aux_width(flags.instanced))]
    for k, (name, on) in enumerate((("base", flags.base_tex), ("mr", flags.mr_tex),
                                    ("normal", flags.normal_tex),
                                    ("emissive", flags.emissive_tex))):
        if on:
            srow += mat(f"{name}_tex")
            taps += range(4 * k, 4 * k + 4)
            aux += [2 * k, 2 * k + 1]
    if flags.normal_tex:
        srow += mat("normal_scale")
    if flags.anisotropy:
        srow += mat("aniso_dir", 3)

    def sectors(lanes):
        return len({4 * i // 32 for i in lanes}) * 32

    return n * (sectors(srow) + sectors(taps) + sectors(aux) + sf.OUT_W * 4 + 2)


def build_kernels():
    """nvcc of every kernel source at once (one process each) and g++ of the
    native runtime meanwhile; returns seconds per library."""
    from concurrent.futures import ThreadPoolExecutor

    from vk_raytrace_torch import runtime
    from vk_raytrace_torch.integrator import shade_fused as sf
    from vk_raytrace_torch.ops import traverse_fused as tf

    def timed(fn, *args, **kw):
        t0 = time.time()
        fn(*args, **kw)
        return time.time() - t0

    with ThreadPoolExecutor(4) as pool:
        futures = {
            "native": pool.submit(timed, runtime.build),
            **{f"traverse{w}": pool.submit(timed, tf.build, w, verbose=True) for w in tf.WIDTHS},
            "shade": pool.submit(timed, sf.build, verbose=True),
        }
        return {k: f.result() for k, f in futures.items()}


def compare_shade(kern, plain):
    """Shading kernel vs plain outputs; returns max |error| of out_vec on
    lanes whose masks agree."""
    k_vec, k_alive, k_vis = kern
    p_vec, p_alive, p_vis = plain
    same = (k_alive == p_alive) & (k_vis == p_vis)
    share = float(same.float().mean())
    assert share >= SHADE_MASK_SHARE, f"shade: masks agree on only {share:.6f} of lanes"
    a, b = k_vec[same].cpu().numpy(), p_vec[same].cpu().numpy()
    np.testing.assert_allclose(a, b, rtol=SHADE_RTOL, atol=SHADE_ATOL)
    assert float(k_alive.float().mean()) > 0.2, "shade: too few live lanes to compare"
    return float(np.nanmax(np.abs(a - b), initial=0.0)), share


def run_frames(r, n=3):
    """One warm-up and ``n`` timed frames: (warm-up s, [s per frame], [rays])."""
    t0 = time.time()
    r.step()
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    frame_s, frame_rays = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        r.step()
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
        frame_rays.append(r.last_rays)
    return warm_s, frame_s, frame_rays


def random_rays(rng, positions, n, dev):
    """Origins inside the scene's bounds, uniform random directions."""
    lo, hi = positions.min(0), positions.max(0)
    o = rng.uniform(lo + 0.05 * (hi - lo), hi - 0.05 * (hi - lo), (n, 3))
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.tensor(o, dtype=torch.float32, device=dev),
            torch.tensor(d, dtype=torch.float32, device=dev))


def rays_at(rng, geom, ids, n, dev):
    """Rays from random points of the scene toward random points of the
    triangles ``ids`` (the alpha-tested banners for mode c)."""
    pos = np.asarray(geom.positions)
    p = pos[np.asarray(geom.indices)[rng.choice(ids, n)]]
    target = np.einsum("rk,rkc->rc", rng.dirichlet(np.ones(3), n), p)
    o, _ = random_rays(rng, pos, n, "cpu")
    d = target - o.numpy()
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.to(dev), torch.tensor(d, dtype=torch.float32, device=dev)


def rays_toward_instances(rng, pool, inst, pick, origins, dev):
    """Rays from ``origins`` (n, 3) toward random points of random triangles
    of the instances ``pick`` (n,), carried to world space by their
    object-to-world rows."""
    n = len(pick)
    mesh = np.asarray(inst.mesh_id)[pick]
    tri = np.asarray(pool.tri_start)[mesh] + (
        rng.random(n) * np.asarray(pool.tri_count)[mesh]).astype(np.int64)
    p = np.einsum("rk,rkc->rc", rng.dirichlet(np.ones(3), n),
                  np.asarray(pool.geometry.positions)[np.asarray(pool.geometry.indices)[tri]])
    m = np.asarray(inst.object_to_world)[pick]
    d = np.einsum("rij,rj->ri", m[:, :, :3], p) + m[:, :, 3] - origins
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.tensor(origins, dtype=torch.float32, device=dev),
            torch.tensor(d, dtype=torch.float32, device=dev))


def camera_rays(cam, w, h, n, rng, dev):
    from vk_raytrace_torch.integrator.camera import generate_rays_for_pixels
    from vk_raytrace_torch.ops import rng as vrng

    pix = torch.tensor(rng.integers(0, w * h, n), dtype=torch.int64, device=dev)
    seed = vrng.tea(pix, 0)
    o, d, _ = generate_rays_for_pixels(cam, w, h, pix, 1, seed)
    return o.contiguous(), d.contiguous()


def redraw_material(srow, rng):
    """Redraw the material lanes of gathered shade rows ``srow`` (R, 128)
    in place, so that each lane takes its own mix of branches: roughness,
    metallic, transmission, ior, clearcoat, anisotropy > 0 on half the
    lanes, thickness 0 and not 0, unlit lanes, and texture ids >= 0 on 90%
    of the lanes."""
    from vk_raytrace_torch.integrator import shade_fused as sf
    from vk_raytrace_torch.integrator.shade import _OFFS

    r, dev = srow.shape[0], srow.device
    u = lambda lo=0.0, hi=1.0, k=1: torch.tensor(  # noqa: E731
        rng.uniform(lo, hi, (r, k)), dtype=torch.float32, device=dev)
    half = lambda: torch.tensor(rng.random((r, 1)) < 0.5, device=dev)  # noqa: E731

    def put(name, val):
        o = sf._SROW_MAT0 + _OFFS[name]
        srow[:, o:o + val.shape[1]] = val

    for name in ("base", "mr", "normal", "emissive"):
        put(f"{name}_tex", torch.where(u() < 0.9, 0.0, -1.0))
    put("emissive_factor", u(0.0, 2.0, 3))
    put("normal_scale", u(0.5, 1.5))
    put("ior", u(1.0, 2.5))
    put("rough_f", u(0.0, 1.0))
    put("metal_f", u(0.0, 1.0))
    put("base_factor", u(0.05, 1.0, 4))
    put("transmission_f", torch.where(half(), u(), 0.0))
    put("unlit", torch.where(u() < 0.02, 1.0, 0.0))
    put("aniso", torch.where(half(), u(0.05, 0.95), 0.0))
    adir = u(-1.0, 1.0, 3)
    put("aniso_dir", adir / adir.norm(dim=1, keepdim=True))
    put("atten_color", u(0.05, 1.0, 3))
    put("atten_dist", u(0.1, 10.0))
    put("thickness", torch.where(half(), u(0.1, 2.0), 0.0))
    put("cc_f", torch.where(half(), u(), 0.0))
    put("cc_rough", u(0.0, 1.0))


def every_branch(x, rng, full_mis):
    """The body's inputs ``x`` (a ``ShadeInputs``) with every flag on, the
    material lanes of the gathered rows redrawn (:func:`redraw_material`)
    and random footprint texels and weights."""
    from vk_raytrace_torch.integrator import shade_fused as sf

    srow = x.srow.clone()
    redraw_material(srow, rng)
    r, dev = srow.shape[0], srow.device
    taps = torch.tensor(rng.integers(-2**31, 2**31, (r, 16), dtype=np.int64).astype(np.int32),
                        device=dev)
    aux = x.aux.clone()
    aux[:, 0:8] = torch.tensor(rng.uniform(0.0, 1.0, (r, 8)), dtype=torch.float32, device=dev)
    flags = sf.ShadeFlags(True, True, True, True, True, full_mis, x.flags.instanced)
    return srow.contiguous(), taps, aux.contiguous(), flags


# Rows of the synthetic tap table of the every-branch stage case (atlas rows).
SYNTH_TAP_ROWS = 64
# Lights of the every-branch stage case: directional, point and spot in turn.
SYNTH_LIGHTS = 9


def synthetic_lights(rng, dev):
    """``SYNTH_LIGHTS`` punctual lights of every type (``schema.LIGHT_*``):
    positions in a 10-unit box, random directions and colours, half of the
    point and spot lights with a range (the rest unlimited), spot cones of
    random width."""
    from vk_raytrace_torch.models.schema import make_lights

    rows = []
    for k in range(SYNTH_LIGHTS):
        d = rng.standard_normal(3)
        outer = rng.uniform(0.2, 0.9)
        rows.append(dict(type=k % 3, position=rng.uniform(-5.0, 5.0, 3),
                         direction=d / np.linalg.norm(d), color=rng.uniform(0.2, 1.0, 3), intensity=rng.uniform(1.0, 50.0),
                         range=rng.uniform(2.0, 20.0) if rng.random() < 0.5 else 0.0,
                         outer_cone_cos=outer, inner_cone_cos=outer + rng.uniform(0.01, 0.09)))
    return make_lights(rows).to(dev)


def every_branch_stage(scene, tables, hit, rng):
    """The stage's every-branch case: a synthetic shade-row table holding
    each lane's gathered row with its material lanes redrawn
    (:func:`redraw_material`), its vertex uvs drawn in [-2, 3] (negative
    texel coordinates, every wrap mode) and random texture placements and
    mip chains; a random tap-row table of ``SYNTH_TAP_ROWS`` atlas rows;
    lights of every type (:func:`synthetic_lights`); the hits ``tri =
    arange(R)``, 5% of them misses. Returns (scene', tables', hit', features
    with every texture and anisotropy on)."""
    import dataclasses

    from vk_raytrace_torch.integrator import shade_fused as sf
    from vk_raytrace_torch.integrator.shade import _OFFS, MatFeatures

    r, dev = hit.tri.shape[0], hit.tri.device
    srow = tables.shade_rows[torch.clamp(hit.tri, min=0)].clone()
    redraw_material(srow, rng)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    srow[:, 22:28] = f32(rng.uniform(-2.0, 3.0, (r, 6)))
    aw = tables.atlas_w
    for name in ("base", "mr", "normal", "emissive"):
        o = sf._SROW_MAT0 + _OFFS[f"{name}_tex"]
        w = rng.integers(1, 65, r)
        h = rng.integers(1, 65, r)
        span = np.maximum(aw - 2 * w, 1)
        mx = np.where(rng.random(r) < 0.5, -1, rng.integers(0, 1 << 30, r) % span)
        lanes = np.stack([np.zeros(r), rng.integers(0, 1 << 30, r) % span,
                          rng.integers(0, SYNTH_TAP_ROWS, r) % np.maximum(SYNTH_TAP_ROWS - h, 1),
                          w, h, rng.integers(0, 3, r) * 3 + rng.integers(0, 3, r), mx,
                          rng.integers(0, 1 << 30, r) % np.maximum(SYNTH_TAP_ROWS - h, 1)], 1)
        srow[:, o + 1:o + 8] = f32(lanes[:, 1:])
    taps = torch.tensor(
        rng.integers(-2**31, 2**31, (aw * SYNTH_TAP_ROWS, 4), dtype=np.int64).astype(np.int32),
        device=dev)
    tri = torch.arange(r, device=dev)
    tri[torch.tensor(rng.random(r) < 0.05, device=dev)] = -1
    srow = srow.contiguous()
    lights = synthetic_lights(rng, dev)
    scene2 = dataclasses.replace(scene, shade_rows=srow, tap_rows=taps, lights=lights,
                                 n_lights=SYNTH_LIGHTS)
    tables2 = tables._replace(shade_rows=srow, tap_rows=taps, lights=sf.light_rows(lights),
                              n_lights=SYNTH_LIGHTS)
    feats = MatFeatures(base_tex=True, mr_tex=True, normal_tex=True, emissive_tex=True,
                        transmission_tex=False, clearcoat_tex=False, anisotropy=True)
    return scene2, tables2, hit._replace(tri=tri), feats


class StageState:
    """Random lane states of the stage's inputs (numpy-seeded): origins in a
    box, unit directions given, radiance, throughput, absorption, seeds,
    bsdf_pdf (0 on 30% of the lanes: camera rays) and the path length
    before the hit."""

    def __init__(self, rng, direction, origin=None):
        n, dev = direction.shape[0], direction.device
        f32 = lambda lo, hi, *s: torch.tensor(  # noqa: E731
            rng.uniform(lo, hi, (n, *s)), dtype=torch.float32, device=dev)
        self.origin = origin if origin is not None else f32(-5.0, 5.0, 3)
        self.direction = direction
        self.radiance = f32(0.0, 1.0, 3)
        self.throughput = f32(0.05, 1.0, 3)
        self.absorption = f32(0.0, 0.2, 3)
        self.seed = torch.tensor(rng.integers(0, 2**32, n), device=dev)
        self.bsdf_pdf = torch.where(torch.tensor(rng.random(n) < 0.3, device=dev), 0.0,
                                    f32(0.1, 4.0))
        self.tdist = f32(0.5, 30.0)

    def lanes(self):
        return (self.origin, self.direction, self.seed, None, self.radiance, self.throughput,
                self.absorption, self.bsdf_pdf)


STAGE_VEC_KEYS = ("new_origin", "new_dir", "radiance", "throughput", "absorption", "nee",
                  "light_dir", "light_dist", "rr_pcont", "pdf_b", "tdist")


def compare_stage(kern, plain):
    """The stage kernel's dict against the plain stage's (the card gate of
    the body): seeds and miss exact, alive and visible agree on
    ``SHADE_MASK_SHARE`` of the lanes, every vector within SHADE_RTOL /
    SHADE_ATOL where they agree. Returns (max |error|, mask share)."""
    for k in ("seed", "miss"):
        assert torch.equal(kern[k], plain[k]), f"stage: {k} differs from the plain stage"
    same = (kern["alive"] == plain["alive"]) & (kern["visible"] == plain["visible"])
    share = float(same.float().mean())
    assert share >= SHADE_MASK_SHARE, f"stage: masks agree on only {share:.6f} of lanes"
    err = 0.0
    for k in STAGE_VEC_KEYS:
        if k not in plain:
            continue
        a, b = kern[k][same].cpu().numpy(), plain[k][same].cpu().numpy()
        np.testing.assert_allclose(a, b, rtol=SHADE_RTOL, atol=SHADE_ATOL, err_msg=k)
        err = max(err, float(np.nanmax(np.abs(a - b), initial=0.0)))
    assert float(kern["alive"].float().mean()) > 0.2, "stage: too few live lanes to compare"
    return err, share


class _Logged(torch.Tensor):
    """A table whose indexing logs its index (:func:`stage_bytes`)."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    def __getitem__(self, idx):
        self.log.append(idx)
        return torch.Tensor.__getitem__(self.as_subclass(torch.Tensor), idx)


def _logged(t):
    out = t.as_subclass(_Logged)
    out.log = []
    return out


def stage_bytes(plain_fn, scene, tables, flags, n):
    """Bytes the stage must move for this call, in 32-byte sectors: each
    lane's hit and state in and its outputs (``flags``), and each distinct
    row of the scene's tables that the plain stage gathers, once: shade
    rows (the lanes the kernel reads, :func:`shade_row_lanes`), tap rows
    (16 B), env rows (a whole-row gather counts the row's 64 B, a gather of
    its pdf lane 32 B), instance rows (2 x 48 B); the light table and the
    sun's constants whole. ``plain_fn(scene)`` runs the plain stage."""
    import dataclasses

    shade = _logged(scene.shade_rows)
    tap = _logged(scene.tap_rows)
    env = _logged(scene.env.rows)
    plain_fn(dataclasses.replace(scene, shade_rows=shade, tap_rows=tap,
                                 env=dataclasses.replace(scene.env, rows=env)))
    rows = torch.unique(torch.cat([i.reshape(-1) for i in shade.log]))
    sectors = len({4 * k // 32 for k in shade_row_lanes(flags)})
    n_bytes = rows.numel() * sectors * 32
    if tap.log:
        n_bytes += torch.unique(torch.cat([i.reshape(-1) for i in tap.log]) // 2).numel() * 32
    env_sec = []
    for idx in env.log:
        if isinstance(idx, tuple):  # rows[i, 14]: the pdf lane's sector
            env_sec.append(idx[0].reshape(-1) * 2 + 1)
        else:
            i = idx.reshape(-1)
            env_sec += [i * 2, i * 2 + 1]
    n_bytes += torch.unique(torch.cat(env_sec)).numel() * 32 if env_sec else 0
    lane_in = 12 + 8 + 60 + 8 + 4 + (8 if flags.instanced else 0) + (4 if flags.full_mis else 0)
    lane_out = 7 * 12 + 4 * 4 + 3 + 8
    tables_b = (tables.lights.numel() + tables.sun_lanes.numel()) * 4
    return n_bytes + n * (lane_in + lane_out) + tables_b


def shade_row_lanes(flags):
    """The shade-row lanes csrc/shade.cu reads under ``flags``: the vertex
    positions, normals, tangents, handedness, uvs and colours, the uv
    transform, each enabled texture's id and placement (with its mip chain
    under flags.mip), and the material lanes the body reads."""
    from vk_raytrace_torch.integrator import shade_fused as sf
    from vk_raytrace_torch.integrator.shade import _OFFS

    def mat(name, k=1):
        return range(sf._SROW_MAT0 + _OFFS[name], sf._SROW_MAT0 + _OFFS[name] + k)

    lanes = [*range(0, 34), *mat("uvT", 6)]
    for name, k in (("emissive_factor", 3), ("ior", 1), ("rough_f", 1), ("metal_f", 1),
                    ("base_factor", 3), ("transmission_f", 1), ("unlit", 1), ("aniso", 1),
                    ("atten_color", 3), ("atten_dist", 1), ("thickness", 1), ("cc_f", 1),
                    ("cc_rough", 1)):
        lanes += mat(name, k)
    for name, on in (("base", flags.base_tex), ("mr", flags.mr_tex),
                     ("normal", flags.normal_tex), ("emissive", flags.emissive_tex)):
        if on:
            lanes += mat(f"{name}_tex", 8 if flags.mip else 6)
    if flags.normal_tex:
        lanes += mat("normal_scale")
    if flags.anisotropy:
        lanes += mat("aniso_dir", 3)
    return lanes


def stage_case(what, scene, tables, features, hit, st, instances, sun_disk, full_mis, spread,
               hdr_mult, card, reps=20):
    """The stage kernel against the plain stage on the card at these hits
    and lane states (:func:`compare_stage`); the kernel timed (CUDA events
    over ``reps`` launches of prepared arguments, and the wrapper's wall per
    call), the plain stage timed, and the call's bound (:func:`stage_bytes`,
    ops per lane). Returns (max |err|, ms, plain_ms, (bound_ms, bound_by))."""
    from vk_raytrace_torch import travbench as tb
    from vk_raytrace_torch.integrator import shade_fused as sf

    n = hit.tri.shape[0]
    mip = (spread, None) if spread is not None else None
    lanes = st.lanes()
    args = (features, full_mis, 0.5, hdr_mult, hit, *lanes)
    tail = (instances, sun_disk, mip, st.tdist, tables)
    before = dict(sf.LAUNCHES)
    kern = sf._stage_launch(scene, *args, *tail)
    torch.cuda.synchronize()
    assert sf.LAUNCHES["shade_stage"] == before["shade_stage"] + 1, "stage: not one launch"
    assert sf.LAUNCHES["shade_bounce"] == before["shade_bounce"], "stage: the body launched"
    plain = sf._stage_plain(scene, *args, *tail[:-1])
    err, share = compare_stage(kern, plain)
    flags = sf.ShadeFlags(features.base_tex, features.mr_tex, features.normal_tex,
                          features.emissive_tex, features.anisotropy, full_mis,
                          instances is not None, sun_disk, mip is not None)
    a, _ = sf.stage_args(tables, flags, 0.5, hdr_mult, spread, hit, *lanes, st.tdist)
    ms = tb.cuda_time(lambda: sf.launch_stage(a, hit.tri.device), reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        sf._stage_launch(scene, *args, *tail)
    torch.cuda.synchronize()
    wrap_ms = (time.perf_counter() - t0) * 1e3 / reps
    plain_ms = tb.cuda_time(lambda: sf._stage_plain(scene, *args, *tail[:-1]), 2)
    n_bytes = stage_bytes(lambda sc: sf._stage_plain(sc, *args, *tail[:-1]), scene, tables, flags,
                          n)
    ops = (SHADE_INST_OPS_PER_LANE if flags.instanced else SHADE_OPS_PER_LANE) + STAGE_PROLOGUE_OPS
    bnd = tb.bound(n_bytes, n * ops)
    print(f"stage {what}: {n} lanes, alive {float(kern['alive'].float().mean()):.4f}, miss "
          f"{float(kern['miss'].float().mean()):.4f}, masks agree {share:.6f}, seeds and miss "
          f"exact, max |err| {err:.3g} -> OK; kernel {ms:.4f} ms, "
          f"wrapper {wrap_ms:.4f} ms wall a call, plain {plain_ms:.3f} ms; bound {bnd[0]:.4f} ms "
          f"by "
          f"{bnd[1]} ({n_bytes / 1e6:.1f} MB, {n_bytes / n:.0f} B per lane; {ms / bnd[0]:.1f}x "
          f"the bound) ({card})", flush=True)
    return err, ms, plain_ms, bnd


def stage_cases(name, scene, tables, features, hit, st, instances, main, spread, hdr_mult, rng,
                card):
    """Phases 6 and 10: :func:`stage_case` on the camera hits with the main
    path's (sun disk, full MIS, mip) ``main``; with each of the three
    flipped; and every branch (:func:`every_branch_stage`) with full MIS on
    and off. Returns {"main": result on the main path's flags, "err": max
    |err| of all}."""
    sun, mis, mip = main
    sp = lambda on: spread if on else None  # noqa: E731
    flags = f"sun disk {sun}, full MIS {mis}, mip {mip}"
    res = {"main": stage_case(f"{name} camera hits, the main path's flags ({flags})", scene,
                              tables, features, hit, st, instances, sun, mis, sp(mip), hdr_mult,
                              card)}
    errs = [res["main"][0]]
    flipped = f"sun disk {not sun}, full MIS {not mis}, mip {not mip}"
    errs.append(stage_case(f"{name} camera hits, flipped ({flipped})", scene, tables, features,
                           hit, st, instances, not sun, not mis, sp(not mip), hdr_mult, card,
                           reps=3)[0])
    scene2, tables2, hit2, feats2 = every_branch_stage(scene, tables, hit, rng)
    for full_mis in (True, False):
        errs.append(stage_case(
            f"{name} every branch (synthetic tables, tri = arange(R)), full MIS {full_mis}",
            scene2, tables2, feats2, hit2, st, instances, True, full_mis, spread, hdr_mult, card,
            reps=3)[0])
    res["err"] = max(errs)
    return res


def stage_report(card):
    """ptxas of each instantiation of the stage and the body (registers,
    stack frame, spill) from the shading library's build."""
    from vk_raytrace_torch import cuda_build

    for label, entry in (("stage single-level", "shade_stage_kernelILb0E"),
                         ("stage instanced", "shade_stage_kernelILb1E"),
                         ("body single-level", "shade_kernelILb0E"),
                         ("body instanced", "shade_kernelILb1E")):
        rep = cuda_build.resources("shade", entry)
        print(f"ptxas {label}: {rep['registers']} registers, {rep['stack_frame']} B stack "
              f"frame, {rep['spill_stores']} B spill stores, {rep['spill_loads']} B spill "
              f"loads, {rep['smem']} B shared ({card})", flush=True)


def compare(mode, kern, twin):
    """Kernel vs twin outputs of one mode; returns max |error| of t/u/v."""
    t_k, tri_k, u_k, v_k = (x.cpu().numpy() for x in kern[:4])
    t_p, tri_p, u_p, v_p = (x.cpu().numpy() for x in twin[:4])
    assert np.array_equal(kern[4].cpu().numpy(), twin[4].cpu().numpy()), f"{mode}: node counts differ"
    if mode == "any":
        assert np.array_equal(tri_k >= 0, tri_p >= 0), "any-hit masks differ"
        return 0.0
    diff = tri_k != tri_p
    # A differing triangle is allowed only at a tie of the nearest t.
    np.testing.assert_allclose(t_k[diff], t_p[diff], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_k, t_p, rtol=RTOL, atol=ATOL)
    hit = (tri_p >= 0) & ~diff
    errs = [np.abs(t_k - t_p)[hit], np.abs(u_k - u_p)[hit], np.abs(v_k - v_p)[hit]]
    np.testing.assert_allclose(u_k[hit], u_p[hit], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(v_k[hit], v_p[hit], rtol=1e-4, atol=1e-4)
    if mode == "candidate":
        for a, b in ((kern[5], twin[5]), (kern[6], twin[6])):
            a, b = a.cpu().numpy()[hit], b.cpu().numpy()[hit]
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
            errs.append(np.abs(a - b))
    assert hit.mean() > 0.2, f"{mode}: too few hits to compare ({hit.mean():.3f})"
    return float(max(e.max(initial=0.0) for e in errs))


def traversal_case(name, planar, oo, dd, tm, mode, cull, card, root0=None, note=""):
    """The traversal kernel against its twin in one mode (with ``root0``:
    per-lane roots) on these rays; both timed, and the call's bound counted
    from the rows the twin visits. Returns (max |err|, (ms, plain_ms),
    (bound_ms, bound_by))."""
    from vk_raytrace_torch import travbench as tb
    from vk_raytrace_torch.ops import traverse_fused as tf

    n = oo.shape[0]
    kern = tf.traverse(planar, oo, dd, tm, mode=mode, cull=cull, root0=root0)
    seen = torch.zeros(planar.rows.shape[0], dtype=torch.int8, device=oo.device)
    twin = tf._traverse_plain(planar, oo, dd, tm, None, mode, cull, seen, root0=root0)
    torch.cuda.synchronize()
    err = compare(mode, kern, twin)
    persistent = root0 is None and mode != "candidate"  # the a/b entry from the root
    if persistent:
        assert tb.same_hits(kern, twin), f"{name}: t/tri/u/v/steps not bit-exact with the twin"
    hit_share = float((kern[1] >= 0).float().mean())
    steps = float(kern[4].float().mean())
    ms = tb.cuda_time(lambda: tf.traverse(planar, oo, dd, tm, mode=mode, cull=cull, root0=root0),
                      20)
    plain_ms = tb.cuda_time(
        lambda: tf._traverse_plain(planar, oo, dd, tm, None, mode, cull, root0=root0), 2)
    # Bytes: rays in (origin, direction, t_max, + root) and out (t, tri, u,
    # v, steps, + uv in mode c), plus each distinct row the rays visit once.
    ray_b = 28 + (4 if root0 is not None else 0) + (28 if mode == "candidate" else 20)
    n_bytes, n_inner, n_leaf = tb.traversal_bytes(n, ray_b, seen, planar.width, mode)
    n_ops = float(kern[4].double().sum()) * tb.ops_per_node(planar.width)
    bnd = tb.bound(n_bytes, n_ops)
    if persistent:
        rep = tb.ab_report(planar.width, mode, oo.device)
        note += (f" [persistent kernel: bit-exact; {rep['registers']} registers, "
                 f"{rep['stack_frame']} B stack frame, {rep['spill_bytes']} B spill, "
                 f"{rep['blocks_per_sm']} blocks of 128 per SM; deepest stack "
                 f"{rep['deepest_stack']} of the tree's bound {planar.stack_depth}]")
    print(f"mode {name}{note}: {n} rays, hit share {hit_share:.4f}, mean nodes/ray {steps:.2f}, "
          f"max |err| {err:.3g} -> OK; kernel {ms:.3f} ms, twin {plain_ms:.3f} ms, bound "
          f"{bnd[0]:.4f} ms by {bnd[1]} ({n_bytes / 1e6:.1f} MB with {n_inner} interior + "
          f"{n_leaf} leaf rows of {planar.rows.shape[0]} visited, {n_ops / 1e9:.3f} Gop; "
          f"{ms / bnd[0]:.1f}x the bound) ({card})", flush=True)
    return err, (ms, plain_ms), bnd


def first_candidates(acc, subset, o, d, t_max, n):
    """The rays' first instance candidates over the ``subset`` ("opq" or
    "alp") boxes of the instances that have such triangles, moved into
    their instance's object space; ``n`` of the rays that have one (cycled
    when fewer do). Returns (origin, direction, t_max, root0, share of rays
    with a candidate)."""
    from vk_raytrace_torch.ops import tlas

    _, roots, view, mask = tlas._subset(acc, subset)
    entry = tlas._instance_slab(view, o, d, t_max, mask)
    r = o.shape[0]
    _, nid = tlas._next_candidate(entry, torch.full((r,), tlas._NEG, device=o.device),
                                  torch.full((r,), -1, dtype=torch.int64, device=o.device))
    sel = torch.nonzero(nid >= 0).squeeze(1)
    share = sel.numel() / r
    sel = sel[torch.arange(n, device=o.device) % sel.numel()]
    oo, dd = tlas._transform_rays(acc.inst, nid[sel], o[sel], d[sel])
    root0 = roots[acc.inst.mesh_id[nid[sel]]].to(torch.int32)
    return oo.contiguous(), dd.contiguous(), t_max[sel].contiguous(), root0.contiguous(), share


def warp_rounds(rounds):
    """How a machine's rounds spread over its warps (a thread per ray, 32
    consecutive rays a warp): (mean rounds per ray, mean of each warp's
    most rounds, the share of a warp's lane-rounds that do work)."""
    r = rounds.double()
    w = torch.nn.functional.pad(r, (0, (-r.numel()) % 32)).view(-1, 32)
    wmax = w.amax(dim=1)
    return float(r.mean()), float(wmax.mean()), float(w.sum() / (32 * wmax).sum().clamp(min=1))


def machine_case(name, planar, kernel, loop, key, loop_key, exact, work_bytes_ops, card):
    """A round machine kernel (``kernel()``, one launch of ``key``) against
    its round loop driving the per-round kernel (``loop()``, launches of
    ``loop_key``) and against the fully plain round loop (``loop(trav=the
    twin, rounds=...)``): the output fields ``exact`` equal, the others
    (t, u, v) within RTOL/ATOL. The kernel is timed (CUDA events), the round
    loop's wall (CUDA events, which span its host syncs) and device time
    (profiler), the plain loop once on the host clock; the bound is counted
    by ``work_bytes_ops(seen rows, rounds per ray, candidates, plain outputs)``
    from the plain run, which also gives the rounds per warp. Returns
    ((max |err|, (ms, plain_ms), bound), the per-round kernel's launches in
    one round-loop call)."""
    import chip_profile
    from vk_raytrace_torch import travbench as tb
    from vk_raytrace_torch.ops import traverse_fused as tf

    before = dict(tf.LAUNCHES)
    kern = kernel()
    torch.cuda.synchronize()
    assert tf.LAUNCHES[key] == before[key] + 1 and tf.LAUNCHES[loop_key] == before[loop_key], (
        f"{name}: the pass did not run as one {key} launch")
    looped = loop()
    torch.cuda.synchronize()
    loop_launches = tf.LAUNCHES[loop_key] - before[loop_key]
    seen = torch.zeros(planar.rows.shape[0], dtype=torch.int8, device=planar.rows.device)
    cands = [0]

    def plain_trav(planar, o, d, tm, active, mode, cull, root0=None):
        out = tf._traverse_plain(planar, o, d, tm, active, mode, cull, seen, root0=root0)
        cands[0] += int((out[1] >= 0).sum())
        return out

    n = kern[0].shape[0]
    rounds = torch.zeros(n, dtype=torch.int32, device=kern[0].device)
    t0 = time.perf_counter()
    plain = loop(trav=plain_trav, rounds=rounds)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3

    def check(what, a, b):
        for k in range(len(a)):
            if k in exact:
                assert torch.equal(a[k], b[k]), f"{name}: output {k} differs from the {what}"
            else:
                torch.testing.assert_close(a[k], b[k], rtol=RTOL, atol=ATOL)
        return max(float((a[k] - b[k]).abs().max()) for k in range(len(a)) if k not in exact)

    err = max(check("round loop", kern, looped), check("plain round loop", kern, plain))
    ms = tb.cuda_time(kernel, 20)
    loop_ms = tb.cuda_time(loop, 3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        loop()
        torch.cuda.synchronize()
    events, _ = chip_profile.device_events(prof)
    loop_busy = chip_profile.busy_us(events) / 1e3
    n_bytes, n_ops = work_bytes_ops(seen, rounds, cands[0], plain)
    bnd = tb.bound(n_bytes, n_ops)
    mean_r, warp_max, used = warp_rounds(rounds)
    print(f"{name}: {n} rays, {int(rounds.sum())} rounds ({mean_r:.2f} per ray, the warps' most "
          f"{warp_max:.2f} on average, {used:.3f} of the warps' lane-rounds used, at most "
          f"{int(rounds.max())}), {cands[0]} candidates, hit {float((kern[1] >= 0).float().mean()):.4f}; "
          f"exact vs round loop and plain loop, max |err| {err:.3g} -> OK; kernel {ms:.3f} ms "
          f"(1 launch); round loop {loop_ms:.3f} ms wall, {loop_busy:.3f} ms device busy, "
          f"{len(events)} device activities, {loop_launches} per-round launches; plain loop "
          f"{plain_ms:.1f} ms; bound {bnd[0]:.4f} ms by {bnd[1]} ({n_bytes / 1e6:.1f} MB, "
          f"{int((seen == 1).sum())} interior + {int((seen == 2).sum())} leaf rows of "
          f"{planar.rows.shape[0]}, {n_ops / 1e9:.3f} Gop; {ms / bnd[0]:.1f}x the bound) ({card})",
          flush=True)
    return (err, (ms, plain_ms), bnd), loop_launches


def alpha_machine_case(name, acc, pack, o, d, t_max, seed, act, any_hit, card):
    """Phase 17: the alpha machine kernel on these world rays; see
    :func:`machine_case`. Bound: MACHINE_* per ray, instance and candidate,
    each distinct alpha BLAS row, and the rounds' nodes."""
    from vk_raytrace_torch import travbench as tb
    from vk_raytrace_torch.ops import tlas
    from vk_raytrace_torch.ops import traverse_fused as tf

    planar = acc.blas_planar_alp
    args = (acc, pack, o, d, t_max, seed, act, any_hit, not any_hit)
    n, n_inst = o.shape[0], acc.inst.aabb_min.shape[0]

    def work(seen, rounds, cands, plain):
        n_rounds = float(rounds.double().sum())
        nodes = float(plain[6].double().sum()) - n_rounds
        rows_b, _, _ = tb.traversal_bytes(0, 0, seen, planar.width, "candidate")
        return (n * MACHINE_RAY_BYTES + n_inst * MACHINE_INST_BYTES + rows_b
                + cands * MACHINE_CAND_BYTES,
                nodes * tb.ops_per_node(planar.width) + n_rounds * MACHINE_ROUND_OPS
                + cands * MACHINE_CAND_OPS)

    return machine_case(
        name, planar, lambda: tlas._two_level_alpha_pass(*args),
        lambda **kw: tlas._alpha_rounds(*args, **kw), tf.launch_key("alpha_machine", planar.width),
        tf.launch_key("candidate_roots", planar.width), (1, 4, 5, 6), work, card)


def alpha_rounds_case(name, planar, pack, o, d, t_lim, seed, act, cull, card):
    """Phase 18: the single-level alpha rounds kernel on these rays, with the
    window the caller gives them (``traverse_alpha._alpha_rounds``: active,
    a window past 0 and the root prefilter); see :func:`machine_case`.
    Bound: ROUNDS_* per ray and round, MACHINE_CAND_* per candidate, each
    distinct alpha row, and the rounds' nodes."""
    from vk_raytrace_torch import travbench as tb
    from vk_raytrace_torch.ops import traverse_alpha as ta
    from vk_raytrace_torch.ops import traverse_fused as tf

    need = act & (t_lim > 0.0) & tf.root_prefilter(planar, o, d, t_lim)
    args = (planar, pack, o, d, t_lim, seed, need, cull)
    n = o.shape[0]

    def work(seen, rounds, cands, plain):
        rows_b, _, _ = tb.traversal_bytes(0, 0, seen, planar.width, "candidate")
        return (n * ROUNDS_RAY_BYTES + rows_b + cands * MACHINE_CAND_BYTES,
                float(plain[5].double().sum()) * tb.ops_per_node(planar.width)
                + float(rounds.double().sum()) * ROUNDS_ROUND_OPS + cands * MACHINE_CAND_OPS)

    return machine_case(
        name, planar, lambda: ta._rounds(*args), lambda **kw: ta._rounds_core(*args, **kw),
        tf.launch_key("alpha_rounds", planar.width), tf.launch_key("candidate", planar.width),
        (1, 4, 5), work, card)


def opaque_machine_case(name, acc, subset, o, d, t_max, act, any_hit, card):
    """Phase 19: the two-level opaque machine kernel on these world rays over
    ``acc``'s ``subset`` ("opq" or "full", ``tlas._subset``); see
    :func:`machine_case`. Bound: OPAQUE_* per ray and round,
    MACHINE_INST_BYTES per instance, each distinct BLAS row, and the rounds'
    nodes."""
    from vk_raytrace_torch import travbench as tb
    from vk_raytrace_torch.ops import tlas
    from vk_raytrace_torch.ops import traverse_fused as tf

    planar, roots, inst, mask = tlas._subset(acc, subset)
    args = (planar, roots, inst, o, d, t_max, act, mask, not any_hit, any_hit)
    mode = "any" if any_hit else "closest"
    n, n_inst = o.shape[0], inst.aabb_min.shape[0]

    def work(seen, rounds, cands, plain):
        n_rounds = float(rounds.double().sum())
        nodes = float(plain[5].double().sum()) - n_rounds
        rows_b, _, _ = tb.traversal_bytes(0, 0, seen, planar.width, mode)
        return (n * OPAQUE_RAY_BYTES + n_inst * MACHINE_INST_BYTES + rows_b,
                nodes * tb.ops_per_node(planar.width) + n_rounds * OPAQUE_ROUND_OPS)

    return machine_case(
        name, planar,
        lambda: tlas._two_level_opaque_pass(acc, subset, o, d, t_max, act, not any_hit, any_hit),
        lambda **kw: tlas._two_level_pass(*args, **kw),
        tf.launch_key("opaque_machine", planar.width), tf.launch_key(f"{mode}_roots", planar.width),
        (1, 4, 5), work, card)


def main():
    # ---- 1. environment ----------------------------------------------------
    phase("environment")
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this script needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    from vk_raytrace_torch.ops import traverse_fused as tf

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    from vk_raytrace_torch import travbench as tb

    card = tb.card_line()
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"card: {card}", flush=True)

    # ---- 2. build -----------------------------------------------------------
    phase("build")
    from vk_raytrace_torch.integrator import shade_fused as sf

    build_s = build_kernels()
    print("build s: " + ", ".join(f"{k} {v:.2f}" for k, v in build_s.items()), flush=True)

    # ---- 3. kernel vs twin on the full atrium ------------------------------
    phase("kernel vs twin")
    from vk_raytrace_torch import render as R
    from vk_raytrace_torch.models import procedural
    from vk_raytrace_torch.models.schema import PBR_GLTF, RenderConfig
    from vk_raytrace_torch.ops.bvh8 import build_accel_bundle
    from vk_raytrace_torch.ops.traverse_wide import make_alpha_pack

    t0 = time.time()
    geom, mats, lights, cam, atlas = procedural.atrium_scene()
    scene_gen_s = time.time() - t0
    t0 = time.time()
    bundle = build_accel_bundle(geom)
    accel_s = time.time() - t0
    gbundle = bundle.to(dev)
    print(f"atrium: {len(geom.indices)} triangles, opaque rows "
          f"{gbundle.opaque_planar.rows.shape[0]} (stack {bundle.opaque_planar.stack_depth}), "
          f"alpha rows {gbundle.alpha_planar.rows.shape[0]} (stack "
          f"{bundle.alpha_planar.stack_depth}); scene {scene_gen_s:.2f} s, accel {accel_s:.2f} s")
    rng = np.random.default_rng(1234)
    from vk_raytrace_torch.integrator.camera import with_aspect

    cam_dev = with_aspect(cam, 1920, 1080).to(dev)
    pos = np.asarray(geom.positions)
    alpha_ids = np.where(np.asarray(geom.tri_flags) & 2)[0]
    # One ray set per mode at the main path's pool width (2^18 rays): half
    # camera rays, half random rays for a and b; rays toward the banners for c.
    n = 1 << 18
    oc, dc = camera_rays(cam_dev, 1920, 1080, n // 2, rng, dev)
    orr, drr = random_rays(rng, pos, n // 2, dev)
    o = torch.cat([oc, orr]).contiguous()
    d = torch.cat([dc, drr]).contiguous()
    inf = torch.full((n,), tf.INF, device=dev)
    t_short = torch.tensor(rng.uniform(0.5, 20.0, n), dtype=torch.float32, device=dev)
    oa, da = rays_at(rng, geom, alpha_ids, n, dev)
    cases = {
        "closest": (gbundle.opaque_planar, o, d, inf, True),
        "any": (gbundle.opaque_planar, o, d, t_short, False),
        "candidate": (gbundle.alpha_planar, oa, da, inf, True),
    }
    errors, times, bounds = {}, {}, {}
    for mode, (planar, oo, dd, tm, cull) in cases.items():
        errors[mode], times[mode], bounds[mode] = traversal_case(
            mode, planar, oo, dd, tm, mode, cull, card)

    # ---- 4. render slice: card vs CPU twin ---------------------------------
    phase("slice vs twin")
    g2, m2, l2, c2, a2 = procedural.atrium_scene(**SMALL_ATRIUM)
    small = R.build_scene(g2, m2, l2, c2, atlas=a2)
    cfg_s = RenderConfig(width=128, height=72, max_depth=4, max_samples=1, pbr_mode=PBR_GLTF,
                         firefly_clamp=10.0, use_sun_sky=True)
    # One environment for both: the bake and alias table come from the CPU.
    small, run_cfg = R.prepare_sun_sky(small, cfg_s, "cpu")
    acc = build_accel_bundle(small.geometry)
    imgs, rays = {}, {}
    for where in ("cuda", "cpu"):
        r = R.Renderer(small, run_cfg, device=where, packed=acc)
        rays[where] = []
        for _ in range(2):
            r.step()
            rays[where].append(r.last_rays)
        imgs[where] = r.accum.cpu().numpy()
    share = float(np.isclose(imgs["cuda"], imgs["cpu"], rtol=PIX_RTOL, atol=PIX_ATOL).all(-1).mean())
    ray_rel = abs(sum(rays["cuda"]) - sum(rays["cpu"])) / sum(rays["cpu"])
    print(f"128x72 d4: pixels within rtol {PIX_RTOL}/atol {PIX_ATOL}: {share:.5f}; "
          f"rays cuda {rays['cuda']} cpu {rays['cpu']} (rel {ray_rel:.2e})", flush=True)
    assert np.isfinite(imgs["cuda"]).all() and imgs["cuda"].mean() > 0.0
    assert share >= PIX_SHARE, f"slice: only {share:.4f} of pixels agree"
    assert ray_rel <= RAY_REL, f"slice: ray counts differ by {ray_rel:.2e}"
    # The same slice through the fused shading stage: card vs CPU, and fused
    # vs unfused on the card.
    f_imgs, f_rays = {}, {}
    for where in ("cuda", "cpu"):
        r = R.Renderer(small, run_cfg, device=where, packed=acc, fused_shade=True)
        f_rays[where] = []
        for _ in range(2):
            r.step()
            f_rays[where].append(r.last_rays)
        f_imgs[where] = r.accum.cpu().numpy()
    assert np.isfinite(f_imgs["cuda"]).all() and f_imgs["cuda"].mean() > 0.0
    for what, (ia, ra), (ib, rb) in (
        ("fused cuda vs cpu", (f_imgs["cuda"], f_rays["cuda"]), (f_imgs["cpu"], f_rays["cpu"])),
        ("fused vs unfused (cuda)", (f_imgs["cuda"], f_rays["cuda"]),
         (imgs["cuda"], rays["cuda"])),
    ):
        share = float(np.isclose(ia, ib, rtol=PIX_RTOL, atol=PIX_ATOL).all(-1).mean())
        ray_rel = abs(sum(ra) - sum(rb)) / sum(rb)
        print(f"128x72 d4 {what}: pixels within tolerance {share:.5f}; rays {ra} vs {rb} "
              f"(rel {ray_rel:.2e})", flush=True)
        assert share >= PIX_SHARE, f"slice {what}: only {share:.4f} of pixels agree"
        assert ray_rel <= RAY_REL, f"slice {what}: ray counts differ by {ray_rel:.2e}"

    # ---- 5. main path ------------------------------------------------------
    phase("main path")
    t0 = time.time()
    scene = R.build_scene(geom, mats, lights, cam, atlas=atlas)
    tables_s = time.time() - t0
    cfg = RenderConfig(width=1920, height=1080, max_depth=4, max_samples=1, pbr_mode=PBR_GLTF,
                       firefly_clamp=10.0, use_sun_sky=True)
    torch.cuda.reset_peak_memory_stats(dev)
    tf.reset_launches()
    sf.reset_launches()
    t0 = time.time()
    r = R.Renderer(scene, cfg, device=dev)
    renderer_s = time.time() - t0
    build = {"scene_gen_s": scene_gen_s, "scene_tables_s": tables_s,
             "renderer_s": renderer_s, **r.build_times}
    warm_s, frame_s, frame_rays = run_frames(r)
    launches = dict(tf.LAUNCHES)
    img = r.accum.cpu().numpy()
    ldr = r.postprocess().cpu().numpy()
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    s_frame = float(np.mean(frame_s))
    mrays = float(np.sum(frame_rays) / np.sum(frame_s) / 1e6)
    build_txt = ", ".join(f"{k} {v:.2f}" for k, v in build.items())
    print(f"warm-up frame {warm_s:.3f} s; frames {['%.4f' % s for s in frame_s]} s; "
          f"rays/frame {frame_rays}; launches {launches}")
    assert all(launches[m] > 0 for m in ATRIUM_KERNELS), f"a traversal kernel never launched: {launches}"
    assert launches["candidate"] == 0, f"a per-round alpha launch ran: {launches}"
    assert np.isfinite(img).all() and np.isfinite(ldr).all(), "non-finite pixels"
    assert img.mean() > 0.0 and ldr.max() > 0.0, "black image"
    assert min(frame_rays) > 1920 * 1080, "fewer rays than primary rays"
    print(f"atrium 1080p d4 1spp: {s_frame:.4f} s/frame, {mrays:.4f} Mrays/s, "
          f"peak {peak_mb:.1f} MiB allocated, mean radiance {img.mean():.4f}; "
          f"build s: {build_txt} [{card}]", flush=True)

    # ---- 6. the stage kernel vs the plain stage on the card ----------------
    phase("shade stage vs plain")
    from vk_raytrace_torch.integrator.path import mip_lod_enabled, pixel_spread

    stage_report(card)
    run_cfg = r._run_cfg
    oc, dc = camera_rays(cam_dev, 1920, 1080, n, rng, dev)
    hit = tf.closest_hit_fused(gbundle.opaque_planar, oc, dc)
    st = StageState(rng, dc, origin=oc)
    spread = pixel_spread(r.scene, 1080)
    main = (run_cfg.sun_disk, run_cfg.full_mis, mip_lod_enabled(r.scene, run_cfg))
    stage_res = stage_cases("atrium", r.scene, sf.stage_tables(r.scene), r.features, hit, st,
                            None, main, spread, run_cfg.hdr_multiplier, rng, card)

    # The body alone (vkrt_shade) on gathered inputs, with its every-branch gate.
    seed = torch.tensor(rng.integers(0, 2**32, n), device=dev)
    zeros3 = torch.zeros(n, 3, device=dev)
    x = sf.shade_inputs(
        r.scene, r.features, run_cfg.full_mis, 0.5, run_cfg.hdr_multiplier, hit, oc, dc, seed,
        None, zeros3, torch.ones(n, 3, device=dev), zeros3, torch.zeros(n, device=dev),
        sun_disk=run_cfg.sun_disk,
        mip=(spread, torch.clamp(hit.t, max=1e30)),
    )
    real = (x.srow, x.taps, x.aux, x.flags)
    sets = [("atrium camera hits", real)]
    for full_mis in (True, False):
        sets.append((f"every branch, full_mis={full_mis}", every_branch(x, rng, full_mis)))
    shade_err = 0.0
    for what, args in sets:
        kern = sf.shade(*args)
        torch.cuda.synchronize()
        err, agree = compare_shade(kern, sf._shade_plain(*args))
        shade_err = max(shade_err, err)
        print(f"body alone, {what}: {n} lanes, alive {float(kern[1].float().mean()):.4f}, masks "
              f"agree {agree:.6f}, max |err| {err:.3g} -> OK", flush=True)
    shade_ms = tb.cuda_time(lambda: sf.shade(*real), 20)
    shade_plain_ms = tb.cuda_time(lambda: sf._shade_plain(*real), 2)
    s_bytes, s_ops = shade_bytes(n, x.flags), n * SHADE_OPS_PER_LANE
    shade_bound = tb.bound(s_bytes, s_ops)
    print(f"body alone {shade_ms:.3f} ms, plain {shade_plain_ms:.3f} ms at {n} lanes; bound "
          f"{shade_bound[0]:.4f} ms by {shade_bound[1]} ({s_bytes / 1e6:.1f} MB, "
          f"{s_bytes / n:.0f} B per lane, {s_ops / 1e9:.3f} Gop; flags {x.flags}; "
          f"{shade_ms / shade_bound[0]:.1f}x the bound) ({card})", flush=True)

    # ---- 7. main path, fused shading ----------------------------------------
    phase("main path, fused shading")
    del r, x, real, sets, kern, hit  # the peak below is the fused renderer's own
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    tf.reset_launches()
    sf.reset_launches()
    rf = R.Renderer(scene, cfg, device=dev, packed=bundle, fused_shade=True)
    f_warm_s, f_frame_s, f_frame_rays = run_frames(rf)
    f_launches = {**tf.LAUNCHES, **sf.LAUNCHES}
    f_img = rf.accum.cpu().numpy()
    f_ldr = rf.postprocess().cpu().numpy()
    f_peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    f_s_frame = float(np.mean(f_frame_s))
    f_mrays = float(np.sum(f_frame_rays) / np.sum(f_frame_s) / 1e6)
    print(f"warm-up frame {f_warm_s:.3f} s; frames {['%.4f' % s for s in f_frame_s]} s; "
          f"rays/frame {f_frame_rays}; launches {f_launches}")
    assert f_launches["shade_stage"] > 0, f"the stage kernel never launched: {f_launches}"
    assert f_launches["shade_bounce"] == 0, f"the body alone launched: {f_launches}"
    assert all(f_launches[m] > 0 for m in ATRIUM_KERNELS), f"a traversal kernel never launched: {f_launches}"
    assert f_launches["candidate"] == 0, f"a per-round alpha launch ran: {f_launches}"
    assert np.isfinite(f_img).all() and np.isfinite(f_ldr).all(), "fused: non-finite pixels"
    assert f_img.mean() > 0.0 and f_ldr.max() > 0.0, "fused: black image"
    assert min(f_frame_rays) > 1920 * 1080, "fused: fewer rays than primary rays"
    print(f"atrium 1080p d4 1spp fused: {f_s_frame:.4f} s/frame, {f_mrays:.4f} Mrays/s, peak "
          f"{f_peak_mb:.1f} MiB allocated, mean radiance {f_img.mean():.4f}; unfused in this "
          f"call: {s_frame:.4f} s/frame, {mrays:.4f} Mrays/s, peak {peak_mb:.1f} MiB [{card}]",
          flush=True)

    # ---- 8. traversal with per-lane roots on the full bistro ---------------
    phase("roots kernel vs twin")
    from vk_raytrace_torch.ops import tlas

    del rf  # the fused atrium renderer's memory is done with
    torch.cuda.empty_cache()
    t0 = time.time()
    pool, inst, b_mats, b_lights, b_cam, b_atlas = procedural.bistro_scene()
    b_gen_s = time.time() - t0
    t0 = time.time()
    bscene = R.build_instanced_scene(pool, inst, b_mats, b_lights, b_cam, atlas=b_atlas)
    b_tables_s = time.time() - t0
    acc = bscene.instances.to(dev)
    n_inst_tris = int(np.asarray(pool.tri_count)[np.asarray(inst.mesh_id)].sum())
    print(f"bistro: {len(pool.geometry.indices)} unique triangles, {n_inst_tris} instanced, "
          f"{len(inst.mesh_id)} instances of {len(pool.tri_start)} meshes; rows full "
          f"{acc.blas_planar.rows.shape[0]}, opaque {acc.blas_planar_opq.rows.shape[0]} (stack "
          f"{acc.blas_planar_opq.stack_depth}), alpha {acc.blas_planar_alp.rows.shape[0]} (stack "
          f"{acc.blas_planar_alp.stack_depth}); scene {b_gen_s:.2f} s, tables and accel "
          f"{b_tables_s:.2f} s", flush=True)
    bcam_dev = with_aspect(b_cam, 1920, 1080).to(dev)
    oc, dc = camera_rays(bcam_dev, 1920, 1080, 2 * n, rng, dev)
    t_far = torch.full((2 * n,), tf.INF, device=dev)
    t_near = torch.tensor(rng.uniform(0.5, 20.0, 2 * n), dtype=torch.float32, device=dev)
    # Mode c: rays from around the camera toward the foliage instances.
    leaf_inst = np.nonzero(np.asarray(bscene.instances.inst_alpha))[0]
    eye = np.asarray(b_cam.view_inverse)[:3, 3]
    o_leaf, d_leaf = rays_toward_instances(rng, pool, inst, rng.choice(leaf_inst, 2 * n),
                                           eye + rng.uniform(-2.0, 2.0, (2 * n, 3)), dev)
    root_cases = {
        "closest": ("opq", oc, dc, t_far, True),
        "any": ("opq", oc, dc, t_near, False),
        "candidate": ("alp", o_leaf, d_leaf, t_far, True),
    }
    def roots_cases(acc, suffix):
        """Phase 8's world rays at each mode's first instance candidates of
        ``acc``, against the twin (kept for phase 12's width-32 tables)."""
        for mode, (subset, oo, dd, tm, cull) in root_cases.items():
            name = f"{mode}_roots{suffix}"
            planar = getattr(acc, f"blas_planar_{subset}")
            oo, dd, tm, root0, share_c = first_candidates(acc, subset, oo, dd, tm, n)
            errors[name], times[name], bounds[name] = traversal_case(
                name, planar, oo, dd, tm, mode, cull, card, root0,
                f" ({subset} subset, {share_c:.3f} of the generated rays enter an instance box)")

    roots_cases(acc, "")

    # ---- 9. two-level render slice: card vs CPU twin ------------------------
    phase("bistro slice vs twin")
    sp, si, sm, sl, sc, sa = procedural.bistro_scene(detail=0.05)
    bsmall = R.build_instanced_scene(sp, si, sm, sl, sc, atlas=sa)
    cfg_b = RenderConfig(width=128, height=72, pbr_mode=PBR_GLTF, **BISTRO_CFG)
    bsmall, brun_cfg = R.prepare_sun_sky(bsmall, cfg_b, "cpu")
    b_imgs, b_rays = {}, {}
    for fused in (False, True):
        for where in ("cuda", "cpu"):
            r = R.Renderer(bsmall, brun_cfg, device=where, fused_shade=fused)
            b_rays[fused, where] = []
            for _ in range(2):
                r.step()
                b_rays[fused, where].append(r.last_rays)
            b_imgs[fused, where] = r.accum.cpu().numpy()
    assert np.isfinite(b_imgs[True, "cuda"]).all() and b_imgs[True, "cuda"].mean() > 0.0
    for what, ka, kb in (("cuda vs cpu", (False, "cuda"), (False, "cpu")),
                         ("fused cuda vs cpu", (True, "cuda"), (True, "cpu")),
                         ("fused vs unfused (cuda)", (True, "cuda"), (False, "cuda"))):
        share = float(np.isclose(b_imgs[ka], b_imgs[kb], rtol=PIX_RTOL, atol=PIX_ATOL)
                      .all(-1).mean())
        ray_rel = abs(sum(b_rays[ka]) - sum(b_rays[kb])) / sum(b_rays[kb])
        print(f"bistro 128x72 d4 {what}: pixels within tolerance {share:.5f}; rays "
              f"{b_rays[ka]} vs {b_rays[kb]} (rel {ray_rel:.2e})", flush=True)
        assert share >= PIX_SHARE, f"bistro slice {what}: only {share:.4f} of pixels agree"
        assert ray_rel <= RAY_REL, f"bistro slice {what}: ray counts differ by {ray_rel:.2e}"

    # ---- 10. instanced shading kernel vs plain on the card -------------------
    phase("instanced shade stage vs plain")
    b_cfg = RenderConfig(width=1920, height=1080, pbr_mode=PBR_GLTF, **BISTRO_CFG)
    t0 = time.time()
    rb = R.Renderer(bscene, b_cfg, device=dev, fused_shade=True)
    b_renderer_s = time.time() - t0
    b_inst = bscene.instances  # host tables, for phase 17
    del acc, bscene
    b_run = rb._run_cfg
    oc, dc = camera_rays(rb.scene.camera, 1920, 1080, n, rng, dev)
    seed = torch.tensor(rng.integers(0, 2**32, n), device=dev)
    hit, _ = tlas.closest_hit_instanced(rb.packed, rb.alpha_pack, oc, dc, seed=seed)
    assert rb._shade_tables is not None and rb._shade_tables.o2w is not None
    st = StageState(rng, dc, origin=oc)
    spread = pixel_spread(rb.scene, 1080)
    main = (b_run.sun_disk, b_run.full_mis, mip_lod_enabled(rb.scene, b_run))
    stage_inst_res = stage_cases("bistro", rb.scene, rb._shade_tables, rb.features, hit, st,
                                 rb.packed.inst, main, spread, b_run.hdr_multiplier, rng, card)
    x = sf.shade_inputs(
        rb.scene, rb.features, b_run.full_mis, 0.5, b_run.hdr_multiplier, hit, oc, dc, seed, None,
        zeros3, torch.ones(n, 3, device=dev), zeros3, torch.zeros(n, device=dev),
        instances=rb.packed.inst, sun_disk=b_run.sun_disk,
        mip=(spread, torch.clamp(hit.t, max=1e30)),
    )
    assert x.flags.instanced and x.aux.shape[1] == sf.aux_width(True)
    real = (x.srow, x.taps, x.aux, x.flags)
    sets = [("bistro camera hits", real)]
    for full_mis in (True, False):
        sets.append((f"every branch, instanced, full_mis={full_mis}", every_branch(x, rng, full_mis)))
    inst_err = 0.0
    for what, args in sets:
        kern = sf.shade(*args)
        torch.cuda.synchronize()
        err, agree = compare_shade(kern, sf._shade_plain(*args))
        inst_err = max(inst_err, err)
        print(f"body alone, {what}: {n} lanes, alive {float(kern[1].float().mean()):.4f}, masks "
              f"agree {agree:.6f}, max |err| {err:.3g} -> OK", flush=True)
    inst_ms = tb.cuda_time(lambda: sf.shade(*real), 20)
    inst_plain_ms = tb.cuda_time(lambda: sf._shade_plain(*real), 2)
    i_bytes, i_ops = shade_bytes(n, x.flags), n * SHADE_INST_OPS_PER_LANE
    inst_bound = tb.bound(i_bytes, i_ops)
    print(f"instanced body alone {inst_ms:.3f} ms, plain {inst_plain_ms:.3f} ms at {n} lanes; "
          f"bound {inst_bound[0]:.4f} ms by {inst_bound[1]} ({i_bytes / 1e6:.1f} MB, "
          f"{i_bytes / n:.0f} B per lane, {i_ops / 1e9:.3f} Gop; flags {x.flags}; "
          f"{inst_ms / inst_bound[0]:.1f}x the bound) ({card})", flush=True)
    del x, real, sets, kern, hit, oc, dc

    # ---- 11. the two-level main path ----------------------------------------
    phase("two-level main path")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    tf.reset_launches()
    sf.reset_launches()
    b_warm_s, b_frame_s, b_frame_rays = run_frames(rb)
    b_launches = {**tf.LAUNCHES, **sf.LAUNCHES}
    b_img = rb.accum.cpu().numpy()
    b_ldr = rb.postprocess().cpu().numpy()
    b_peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    b_s_frame = float(np.mean(b_frame_s))
    b_mrays = float(np.sum(b_frame_rays) / np.sum(b_frame_s) / 1e6)
    b_build = {"scene_gen_s": b_gen_s, "scene_tables_and_accel_s": b_tables_s,
               "renderer_s": b_renderer_s, **rb.build_times}
    print(f"warm-up frame {b_warm_s:.3f} s; frames {['%.4f' % s for s in b_frame_s]} s; "
          f"rays/frame {b_frame_rays}; launches {b_launches}")
    want = ("opaque_machine", "alpha_machine", "shade_stage")
    assert all(b_launches[m] > 0 for m in want), f"a kernel never launched: {b_launches}"
    assert b_launches["shade_bounce"] == 0, f"the body alone launched: {b_launches}"
    assert not any(b_launches[m] for m in tf.ROOT_MODES), f"a per-round launch ran: {b_launches}"
    assert np.isfinite(b_img).all() and np.isfinite(b_ldr).all(), "bistro: non-finite pixels"
    assert b_img.mean() > 0.0 and b_ldr.max() > 0.0, "bistro: black image"
    assert min(b_frame_rays) > 1920 * 1080, "bistro: fewer rays than primary rays"
    print(f"bistro 1080p d4 1spp fused: {b_s_frame:.4f} s/frame, {b_mrays:.4f} Mrays/s, peak "
          f"{b_peak_mb:.1f} MiB allocated, mean radiance {b_img.mean():.4f}; build s: "
          + ", ".join(f"{k} {v:.2f}" for k, v in b_build.items()) + f" [{card}]", flush=True)

    # ---- 12. the width-32 kernel against its twin ---------------------------
    phase("width-32 kernel vs twin")
    del rb
    torch.cuda.empty_cache()
    t0 = time.time()
    bundle32 = build_accel_bundle(geom, width=32)
    accel32_s = time.time() - t0
    g32 = bundle32.to(dev)
    print(f"atrium width 32: opaque rows {g32.opaque_planar.rows.shape[0]} (stack "
          f"{bundle32.opaque_planar.stack_depth}), alpha rows {g32.alpha_planar.rows.shape[0]} "
          f"(stack {bundle32.alpha_planar.stack_depth}); accel {accel32_s:.2f} s", flush=True)
    for mode, (planar, oo, dd, tm, cull) in cases.items():
        planar = g32.alpha_planar if mode == "candidate" else g32.opaque_planar
        name = f"{mode}_w32"
        errors[name], times[name], bounds[name] = traversal_case(
            name, planar, oo, dd, tm, mode, cull, card)
    t0 = time.time()
    bscene32 = R.build_instanced_scene(pool, inst, b_mats, b_lights, b_cam, atlas=b_atlas,
                                       width=32)
    b_tables32_s = time.time() - t0
    acc32 = bscene32.instances.to(dev)
    print(f"bistro width 32: rows full {acc32.blas_planar.rows.shape[0]}, opaque "
          f"{acc32.blas_planar_opq.rows.shape[0]} (stack {acc32.blas_planar_opq.stack_depth}), "
          f"alpha {acc32.blas_planar_alp.rows.shape[0]} (stack "
          f"{acc32.blas_planar_alp.stack_depth}); tables and accel {b_tables32_s:.2f} s",
          flush=True)
    roots_cases(acc32, "_w32")
    del acc32

    # ---- 13. the child sort against its plain version -----------------------
    phase("child sort vs plain")
    sort_res = {}
    for width in tf.WIDTHS:
        name = tf.launch_key("sort_children", width)
        keys = torch.tensor(rng.integers(0, 8, (n, width)) / 4.0 - 0.5, dtype=torch.float32,
                            device=dev)
        keys[torch.tensor(rng.random((n, width)) < 0.3, device=dev)] = tf.INF  # misses
        keys[torch.tensor(rng.random((n, width)) < 0.02, device=dev)] = float("nan")
        refs = torch.tensor(rng.integers(-2**30, 2**30, (n, width)), dtype=torch.int32,
                            device=dev)
        kern = tf.sort_children(keys, refs)
        plain = tf._sort_children_plain(keys, refs)
        torch.cuda.synchronize()
        assert tb.same_sort(kern, plain), f"{name}: differs"
        s_err = tb.sort_err(kern, plain)
        ms = tb.cuda_time(lambda: tf.sort_children(keys, refs), 20)
        plain_ms = tb.cuda_time(lambda: tf._sort_children_plain(keys, refs), 5)
        lib_ms = tb.cuda_time(lambda: torch.sort(keys, dim=1, stable=True), 20)
        s_bytes, s_ops = tb.sort_bytes(keys), tb.sort_ops(keys)
        sort_res[name] = (s_err, ms, plain_ms, lib_ms, tb.bound(s_bytes, s_ops))
        print(f"{name}: {n} rows of {width}, hits/row {float(plain[2].float().mean()):.2f}, "
              f"max |err| {s_err:.3g} -> OK; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.sort {lib_ms:.4f} ms; bound {sort_res[name][4][0]:.4f} ms by "
              f"{sort_res[name][4][1]} "
              f"({s_bytes / 1e6:.1f} MB, {s_ops / 1e6:.1f} Mop) ({card})", flush=True)
    del keys, refs, kern, plain

    # ---- 14. the traversal micro-bench --------------------------------------
    phase("traversal micro-bench")
    tf.reset_launches()
    bench = {(x["variant"], x["width"]): x for x in tb.run(
        dev, {16: gbundle.opaque_planar, 32: g32.opaque_planar}, cam, card=card)}
    t_launches = dict(tf.LAUNCHES)
    print(f"launches {t_launches}", flush=True)
    bench_keys = tf.CAPPED_KEYS + tf.SORT_KEYS
    assert all(t_launches[m] > 0 for m in bench_keys), f"a bench kernel never launched: {t_launches}"

    def frames(r, what, want, refuse, beside):
        """Phase 15/16: warm-up and three frames of renderer ``r``; the kernels
        ``want`` must launch and ``refuse`` (width 16, and the per-round
        kernels of the modes the machines run) must not."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        tf.reset_launches()
        sf.reset_launches()
        warm, f_s, f_rays = run_frames(r)
        lau = {**tf.LAUNCHES, **sf.LAUNCHES}
        img, ldr = r.accum.cpu().numpy(), r.postprocess().cpu().numpy()
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        print(f"warm-up frame {warm:.3f} s; frames {['%.4f' % x for x in f_s]} s; rays/frame "
              f"{f_rays}; launches {lau}")
        assert all(lau[m] > 0 for m in want), f"{what}: a width-32 kernel never launched: {lau}"
        assert not any(lau[m] for m in refuse), f"{what}: a refused kernel launched: {lau}"
        assert lau["shade_stage"] > 0, f"{what}: the stage kernel never launched: {lau}"
        assert lau["shade_bounce"] == 0, f"{what}: the body alone launched: {lau}"
        assert np.isfinite(img).all() and np.isfinite(ldr).all(), f"{what}: non-finite pixels"
        assert img.mean() > 0.0 and ldr.max() > 0.0, f"{what}: black image"
        assert min(f_rays) > 1920 * 1080, f"{what}: fewer rays than primary rays"
        s_f = float(np.mean(f_s))
        mr = float(np.sum(f_rays) / np.sum(f_s) / 1e6)
        print(f"{what} 1080p d4 1spp fused, width 32: {s_f:.4f} s/frame, {mr:.4f} Mrays/s, "
              f"peak {peak:.1f} MiB allocated, {float(np.mean(f_rays)):.0f} rays/frame, mean "
              f"radiance {img.mean():.4f}; width 16 in this call: {beside} [{card}]", flush=True)
        return lau

    # ---- 15. the atrium main path at width 32 -------------------------------
    phase("main path, width 32")
    del g32
    w16_keys = tf.MODES + tf.ROOT_MODES + ("alpha_machine", "alpha_rounds", "opaque_machine")
    r32 = R.Renderer(scene, cfg, device=dev, packed=bundle32, fused_shade=True)
    w_launches = frames(
        r32, "atrium", [f"{m}_w32" for m in ATRIUM_KERNELS],
        w16_keys + ("candidate_w32",) + tuple(f"{m}_w32" for m in tf.ROOT_MODES),
        f"{f_s_frame:.4f} s/frame, {f_mrays:.4f} Mrays/s, peak {f_peak_mb:.1f} MiB, "
        f"{float(np.mean(f_frame_rays)):.0f} rays/frame")
    del r32

    # ---- 16. the bistro main path at width 32 -------------------------------
    phase("two-level main path, width 32")
    rb32 = R.Renderer(bscene32, b_cfg, device=dev, fused_shade=True)
    wb_launches = frames(
        rb32, "bistro", ["opaque_machine_w32", "alpha_machine_w32"],
        w16_keys + tuple(f"{m}_w32" for m in tf.ROOT_MODES),
        f"{b_s_frame:.4f} s/frame, {b_mrays:.4f} Mrays/s, peak {b_peak_mb:.1f} MiB, "
        f"{float(np.mean(b_frame_rays)):.0f} rays/frame")
    del rb32

    # ---- 17. the alpha machine against the round loops ----------------------
    phase("alpha machine vs round loops")
    torch.cuda.empty_cache()
    sc = bscene32.to(dev)
    b_pack = make_alpha_pack(sc.materials, sc.atlas, sc.geometry.tri_material)
    act = torch.tensor(rng.random(n) < 0.95, device=dev)
    seed = torch.tensor(rng.integers(0, 2**32, n), device=dev)
    t_shadow = torch.tensor(rng.uniform(1.0, 60.0, n), dtype=torch.float32, device=dev)
    machine_res, loop_launches = {}, {}
    b_accs = (("", b_inst.to(dev)), ("_w32", sc.instances))
    for suffix, a in b_accs:
        for any_hit in (False, True):
            tm = t_shadow if any_hit else t_far[:n]
            name = f"alpha_machine{'_any' if any_hit else ''}{suffix}"
            machine_res[name], lau = alpha_machine_case(
                name, a, b_pack, o_leaf[:n].contiguous(), d_leaf[:n].contiguous(), tm, seed, act,
                any_hit, card)
            key = f"candidate_roots{suffix}"
            loop_launches[key] = loop_launches.get(key, 0) + lau
    del sc, b_pack

    # ---- 18. the single-level alpha rounds against the round loops -----------
    phase("alpha rounds vs round loops")
    a_scene = scene.to(dev)
    a_pack = make_alpha_pack(a_scene.materials, a_scene.atlas, a_scene.geometry.tri_material)
    for suffix, bnd_ in (("", gbundle), ("_w32", bundle32.to(dev))):
        t_open = tf.closest_hit_fused(bnd_.opaque_planar, oa, da).t
        for any_hit in (False, True):
            name = f"alpha_rounds{'_any' if any_hit else ''}{suffix}"
            machine_res[name], lau = alpha_rounds_case(
                name, bnd_.alpha_planar, a_pack, oa, da, t_short if any_hit else t_open, seed,
                act, not any_hit, card)
            key = f"candidate{suffix}"
            loop_launches[key] = loop_launches.get(key, 0) + lau
    del a_scene, a_pack, bnd_

    # ---- 19. the two-level opaque rounds against the round loops -------------
    phase("opaque machine vs round loops")
    oc, dc = camera_rays(bcam_dev, 1920, 1080, n, rng, dev)
    for suffix, a in b_accs:
        for table, subset in (("", "opq"), ("_full", "full")):
            for any_hit in (False, True):
                name = f"opaque_machine{'_any' if any_hit else ''}{table}{suffix}"
                machine_res[name], lau = opaque_machine_case(
                    name, a, subset, oc, dc, t_near[:n] if any_hit else t_far[:n], act, any_hit,
                    card)
                key = f"{'any' if any_hit else 'closest'}_roots{suffix}"
                loop_launches[key] = loop_launches.get(key, 0) + lau
    del b_accs, a, oc, dc

    def traverse_entry(m, lau, replaces):
        """``launches``: the main path's count (``lau``). The per-round kernels
        of the modes the machines run (mode c from the root, modes a/b/c with
        roots) are off the main path, so theirs is 0; ``loop_launches`` gives
        their launches in phases 17-19's round loops (one call each case)."""
        entry = {"name": f"traverse_{m}", "route": "cuda", "source": SOURCE,
                 "replaces": replaces, "launches": lau[m], "max_abs_err": errors[m],
                 "ms": times[m][0], "plain_ms": times[m][1], "bound_ms": bounds[m][0],
                 "bound_by": bounds[m][1], "library_ms": None}
        if m in loop_launches:
            entry["loop_launches"] = loop_launches[m]
        return entry

    kernels = [traverse_entry(m, launches, REPLACES) for m in tf.MODES]
    def stage_entry(name, lau, res):
        """The stage kernel's row, timed on the main path's flags."""
        _, ms, plain_ms, (b_ms, b_by) = res["main"]
        return {"name": name, "route": "cuda", "source": SHADE_SOURCE, "replaces": STAGE_REPLACES,
                "launches": lau["shade_stage"], "max_abs_err": res["err"], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    kernels.append(stage_entry("shade_stage", f_launches, stage_res))
    kernels.append(
        {"name": "shade_bounce", "route": "cuda", "source": SHADE_SOURCE,
         "replaces": SHADE_REPLACES, "launches": f_launches["shade_bounce"],
         "max_abs_err": shade_err, "ms": shade_ms, "plain_ms": shade_plain_ms,
         "bound_ms": shade_bound[0], "bound_by": shade_bound[1], "library_ms": None}
    )
    kernels += [traverse_entry(m, b_launches, ROOTS_REPLACES) for m in tf.ROOT_MODES]
    kernels.append(stage_entry("shade_stage_instanced", b_launches, stage_inst_res))
    kernels.append(
        {"name": "shade_bounce_instanced", "route": "cuda", "source": SHADE_SOURCE,
         "replaces": SHADE_INST_REPLACES, "launches": b_launches["shade_bounce"],
         "max_abs_err": inst_err, "ms": inst_ms, "plain_ms": inst_plain_ms,
         "bound_ms": inst_bound[0], "bound_by": inst_bound[1], "library_ms": None}
    )
    kernels += [traverse_entry(f"{m}_w32", w_launches, REPLACES) for m in tf.MODES]
    kernels += [traverse_entry(f"{m}_w32", wb_launches, ROOTS_REPLACES) for m in tf.ROOT_MODES]
    for key, lau, replaces in (
        ("alpha_machine", b_launches, MACHINE_REPLACES),
        ("alpha_machine_w32", wb_launches, MACHINE_REPLACES),
        ("alpha_rounds", launches, ROUNDS_REPLACES),
        ("alpha_rounds_w32", w_launches, ROUNDS_REPLACES),
        ("opaque_machine", b_launches, OPAQUE_REPLACES),
        ("opaque_machine_w32", wb_launches, OPAQUE_REPLACES),
    ):
        # Times and bound: the closest-hit case (the opaque subset for the
        # opaque machine); the error: the largest of all its cases.
        err, (ms, plain_ms), (b_ms, b_by) = machine_res[key]
        err = max(v[0] for k, v in machine_res.items()
                  if k.startswith(key.replace("_w32", "")) and k.endswith("_w32") == key.endswith("_w32"))
        kernels.append({"name": key, "route": "cuda", "source": SOURCE,
                        "replaces": replaces, "launches": lau[key], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None})
    for name, (s_err, ms, plain_ms, lib_ms, (b_ms, b_by)) in sort_res.items():
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": SORT_REPLACES, "launches": t_launches[name],
                        "max_abs_err": s_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": lib_ms})
    for key in tf.CAPPED_KEYS:
        x = bench[(f"{key.split('_')[0]}8", 32 if key.endswith("_w32") else 16)]
        kernels.append({"name": f"traverse_{key}", "route": "cuda", "source": SOURCE,
                        "replaces": NOGATHER_REPLACES if key.startswith("nogather") else REPLACES,
                        "launches": t_launches[key], "max_abs_err": x["max_abs_err"],
                        "ms": x["ms"],
                        "plain_ms": x["plain_ms"], "bound_ms": x["bound_ms"],
                        "bound_by": x["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
