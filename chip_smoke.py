#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases, each printing its own lines (any failure raises and exits non-zero):

1. environment: the card's name and power limit; CUDA must be available;
2. build: the traversal kernels (``vk_raytrace_torch/csrc/traverse.cu``,
   one library per row width), the wide back end's kernels
   (``traverse_wide.cu``), the shading kernel (``shade.cu``) and the
   wavefront loop's kernels (``wavefront.cu``), nvcc processes started
   together, and the native host runtime
   (``csrc/native.cpp``, g++), from this checkout;
3. traversal kernel against its plain torch twin on the card, for modes a
   (closest hit), b (any hit) and c (alpha candidates, with culling and
   without: each a kernel of its own), on the full atrium's
   trees at 2^18 rays (the main path's pool width), and both timed there;
   every mode bit for bit in t, tri, u, v and steps (mode c also in its
   texture uv), each kernel (modes a and b the a/b entry, mode c the
   per-round entry) printed with its registers, stack frame and spill
   (ptxas), its resident blocks per SM, the deepest stack its rays reached
   and the tree's stack bound;
4. the render slice on the card against the same slice on the CPU twin:
   a small atrium at 128x72, depth 4, 1 spp, 2 frames, identical tables and
   random streams; then the same with the fused shading stage on the card
   and on the CPU, and fused against unfused on the card;
5. the main path: the full atrium (~217k triangles) at 1920x1080, depth 4,
   1 spp, sun&sky, one warm-up and three timed frames; modes a and b, the
   alpha rounds kernel and the loop's kernels (``vkrt_regenerate``,
   ``vkrt_retire``) must have launched, and the per-round mode c and the
   standalone root prefilter (folded into the rounds' ray intake) not: no
   phase's path may launch the standalone prefilter;
   the sun&sky environment built a second time equals the renderer's byte
   for byte (image, alias table, pdfs, rows);
6. the shading stage kernel (``vkrt_shade_stage``, the whole fused stage)
   against the plain stage (``shade_inputs`` + ``_shade_plain``) on the
   card at 2^18 lanes: the hits of atrium camera rays with random lane
   states, sun disk / full MIS / mip LOD each both ways, then every branch through a
   synthetic shade-row and tap-row table (``tri = arange(R)``); each timed,
   with its ``stage_bytes`` bound and the ptxas report of each
   instantiation; the main flags again under an ``active`` mask with 30%
   of the lanes dead among the live ones (the pooled loop's form); then
   the body alone (``vkrt_shade``) on gathered inputs:
   the camera hits, and every branch with full MIS on and off; timed;
7. the main path with the fused shading stage (``Renderer(...,
   fused_shade=True)``): one warm-up and three timed frames; the stage
   kernel and the kernels of phase 5 must have launched, and neither the
   body alone nor the per-round mode c;
8. traversal with per-lane roots (the two-level path's kernel modes)
   against its twin on the full bistro (579k unique, >1M instanced
   triangles) at 2^18 rays: each ray's first instance candidate, moved into
   that instance's object space; modes a and b over the opaque-subset
   table, c (with culling and without) over the alpha-subset table toward
   the foliage; each bit for
   bit with the twin, with its per-round kernel's line as in phase 3; all
   timed;
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
    the alpha machine, the stage kernel and the loop's kernels must have
    launched, and no
    per-round kernel with roots and not the body alone;
12. the width-32 traversal kernel (1024-byte rows, 16-triangle leaves)
    against its twin: the full atrium's width-32 trees on phase 3's ray
    sets, then per-lane roots on the full bistro's width-32 tables on phase
    8's; each bit for bit, with its kernel's line; all timed;
13. the child sort (``sort_children``) against its plain version at 2^18
    rows of 16 and of 32 keys with ties, misses and NaN, exact; timed beside
    one stable ``torch.sort``;
14. the traversal micro-bench (``vk_raytrace_torch.travbench``) at full
    size on the atrium, widths 16 and 32: each capped and no-gather kernel
    at caps 8 and 24 (at width 16 the ring of shared stack entries and the
    spilling stack) against its plain version (exact) and timed, with the full
    traversal and the root child order; the capped, no-gather and sort
    kernels must have launched (and no other phase's path launches the
    capped entry); per variant its time per node visited, ptxas report and
    resident blocks beside the full traversal's (the a/b kernel's);
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
    ``ops/traverse_alpha.py``'s rounds in one launch, persistent warps) on
    the full atrium at 2^18 rays toward the banners, at widths 16 and 32,
    closest (windowed by the opaque hit) and any hit: the same comparisons
    and times as phase 17, against the round loop driving the per-round
    mode c;
19. the two-level opaque machine kernel (``vkrt_opaque_machine``, the
    opaque rounds of ``ops/tlas.py`` in one launch) on the full bistro at
    2^18 camera rays, at widths 16 and 32, closest and any hit, over the
    opaque subsets and over the full table: the same, against the round
    loop driving modes a/b with roots.

Phases 17-19 also print how each machine's rounds would spread over warps
of a thread per ray (32 consecutive rays, the first design's grouping): the
mean rounds per ray, the mean of each warp's most, and the share of the
warps' lane-rounds that do work. The round machines run in persistent
warps; for each of their instantiations phases 17, 18, 19, 28 and
30 print registers, stack frame, spill and static shared memory (ptxas),
resident blocks per SM, the deepest stack its rays reached, the share of
its warps' lane-steps that do work (the kernel's own counts) and the first
design's time on the same rays (``MACHINE_FIRST_MS``), and run the pass
once more under torch's sync debug mode (no host sync inside a pass).

Then the Disney path, the unrolled integrator and the anchor, each render
phase printing s/frame, Mrays/s, the counted kernel launches per frame,
build s and peak MiB beside the card's name and power limit:

20. BASELINE configuration #4 (``disney_materials_d8``,
    ``scripts/baseline_configs.py:72-73``) at full size: the material grid
    (25 spheres and the ground, 55,202 triangles) under the procedural sky,
    512x512, 4 spp, depth 8, the Disney BSDF, HDR 1.0, firefly clamp 10,
    ``full_mis=False``; one warm-up and three timed frames through the
    pooled wavefront; modes a and b must have launched and the eager stage
    run (the reference keeps Disney off the fused stage);
21. BASELINE configuration #2 (``helmet_512_16spp``, ``:66-67``) at full
    size: the helmet (146,690 triangles, 1024^2 and 512^2 textures) under
    the same sky, 512x512, 16 spp, depth 5, glTF, eager and then
    ``fused_shade=True``; the fused frames must have launched the stage
    kernel;
22. the unrolled integrator on the card: every debug mode 1-12 on the full
    atrium (banners on) at 160x90, depth 4, through ``Renderer.step``'s row
    strips; modes a/b and the alpha rounds kernel must have launched; the
    first-hit modes 1-8 against the same render on the CPU at depth 1 (a
    first-hit state does not depend on the depth), 99% of pixels within
    rtol 1e-3 / atol 1e-4;
23. the anchor on the card: the Cornell box at 64x64 and the material grid
    (n=2) at 48x32 through the BVH kernels and through ``BruteTracer``, the
    configurations of ``tests/test_anchor.py``, under its criterion
    (``integrator/brute.images_match``).

Then the application path, through the entry points a user calls, at
full size (each CLI run prints s/frame, Mrays/s, launches per frame, build
s and peak MiB beside the card's name and power limit):

24. the CLI (``vk_raytrace_torch.cli.main``) at the reference CLI's own
    defaults: the atrium with sun&sky at 1280x720, depth 10, 16 spp, Disney
    (the eager stage); modes a/b and the alpha rounds kernel must have
    launched; then 8 spp with ``--checkpoint`` and 8 more resumed from it,
    held against the straight 16 (bit for bit is printed; the slice's pixel
    tolerance is asserted); the PNG decodes with ``utils/png.py`` and is lit;
    then the bistro, glTF PBR, ``--fused-shade``, sun&sky, 1280x720, depth
    10, 4 spp (two levels): the opaque and alpha machines and the stage
    kernel must have launched;
25. glTF: ``tests/assets/quirks.glb`` loaded baked and two-level, each
    rendered at 128x72 on the card against the CPU (phase 9's pixel share;
    the single-level kernels, then the machines, must have launched), then
    through the CLI at 1280x720, depth 10, 16 spp;
26. ``Renderer.pick`` on 256 pixels of the atrium and of the bistro on the
    card, against ``pick_many`` of the same pixels on the CPU: the same
    hits, triangle, material and instance equal where t is not tied, t
    within rtol 1e-5; mode a (the opaque machine in the bistro) must have
    launched;
27. the scene cache (``utils/cache.py``): the atrium's accel built cold
    into a temporary cache directory, then loaded warm; both bit-identical
    to a fresh build; and the sun&sky bake on the card timed against a load
    of its tables from the cache.

Then two-level scenes beyond 512 instances: the plaza (:func:`write_plaza`,
a glTF this script writes: 48 x 48 trees, each an opaque trunk and an
alpha-MASK foliage cluster, and the ground; 4,609 instances of 3 meshes,
1,032,194 instanced triangles; its instance table, 76 B an instance, does
not fit a block's 232,448 B of shared memory):

28. each round machine on 2^18 plaza rays (camera rays at 1280x720 and the
    shadow rays of their hits), closest and any hit, the opaque machine over
    the opaque subsets and the alpha machine over the alpha subsets (the
    instance table read from global memory): bit for bit against its round
    loop on the card (the twin each round, the chunked candidate scan),
    timed, with its bound and, beside it, the per-round instance scans;
    then the bistro's table padded with 400 masked instances (the global
    path) against the same table unpadded (shared memory): bit for bit,
    both timed;
29. the CLI on the plaza at the reference CLI's defaults (1280x720, depth
    10, Disney, ``--instancing auto``) with sun&sky and 4 spp, then with
    ``--pbr gltf --fused-shade``; the machines (and the stage kernel) must
    have launched; then the plaza at 128x72, depth 4, on the card against
    the CPU (the chunked loops), as phase 25 holds quirks.glb;
30. the instance-level split: the plaza's foliage alone (2,304 instances,
    every triangle alpha-tested, so no subset tables) through the CLI at
    128x72 on the card against the CPU; the alpha machine over the full
    tables on 2^18 rays bit for bit against its round loop on the card,
    timed as in phase 28; and ``closest_hit_instanced`` /
    ``any_hit_instanced`` (that one launch alone) equal to it.

Then the last modules of the port, each path driven with the launch
counters set to 0 just before it and read just after:

31. sharding (``parallel/sharding.py``) on phase 5's configuration (the
    full atrium, 1920x1080, depth 4, 1 spp, glTF, sun&sky): NCCL at world
    size 1 in this process (NCCL refuses two ranks on one card), one
    warm-up and three timed frames, against ``Renderer.step`` on the same
    tables (the pixels that differ printed, at most
    :data:`SHARD_DIFFER_MAX` of them, none, the slice's criterion asserted,
    the rays equal); then 2 gloo ranks on cuda:0, spawned, the backend
    asked for by name: tile 2 x sample 1 held the same way, against this
    process's render and rank 0's own (each rank builds its own tables,
    and since C5 they give the same image), tile 1 x sample 2 with its
    mean within 10% of the single render; modes a/b and the
    alpha rounds must have launched in each rank; s/frame, Mrays/s and
    peak MiB of every rank;
32. the viewer (``vk_raytrace_torch.viewer``) at the reference CLI's
    defaults (the atrium with sun&sky, 1280x720, depth 10, Disney), its
    HTTP server on localhost: ``/frame.png`` decodes with ``utils/png.py``
    and is lit, ``/state``'s frame count grows, a POST orbit gives
    descaled frames and a reset and then full-resolution accumulation
    again, ``/pick`` at 16 pixels equals ``Renderer.pick`` on the camera
    the service used; the ms/frame and Mrays/s rings printed;
33. ``graft_entry.entry()`` on the card: one Cornell frame, lit, against
    the same entry on the CPU under phase 9's pixel share;
34. JPEG: the textures of ``tests/assets/jpeg_textures.glb`` (baseline
    4:2:0 and 4:4:4, grey, 4:2:2 with a restart interval, progressive
    4:2:0) decoded by the port without Pillow, each equal to the Pillow RGBA
    committed beside it; ``tests/assets/jpeg_2k_420.jpg`` (2048x2048
    4:2:0, the size a scene loads) decoded three times and timed, each
    decode's RGBA held against the SHA-256 of Pillow's committed beside it;
    the scene at 128x72, depth 4, on the card against the CPU.

Then the wide back end (``renderer="wide"``: the 8-wide trees,
``csrc/traverse_wide.cu``'s ``vkrt_traverse_wide`` for one tree and
``vkrt_wide_machine`` for the two-level rounds, the alpha test inside the
traversal, both in persistent warps with the stack in shared memory), each
path driven with the launch counters set to 0 just before it and read just
after:

35. the tree kernel against its plain version on the 1080p atrium's 2^18
    camera rays and their shadow rays toward the sun: closest and any hit
    over the opaque tree, closest from per-lane roots (interior rows at
    most two levels below the root), the closest-hit alpha pass windowed by the opaque
    t and the any-hit alpha pass on the rays the opaque tree left open,
    with seeds, and both alpha passes on rays toward the banners; every
    output bit for bit (t, tri, u, v, steps, seed); each timed with its
    bound (distinct 256-byte rows in 32-byte sectors, nodes x 26·8
    operations, the alpha tests' pack rows and texels), beside the first
    design's time (a thread per ray, the stack in local memory),
    registers, stack frame, spill and resident blocks (ptxas, the occupancy
    query), the deepest stack a ray reached, and the fused back end's
    kernels on the same rays;
36. the atrium at 1080p (d4, 1 spp, glTF, sun&sky) with
    ``renderer="wide"`` against ``"fused"`` in one process: rays within
    0.1%, the pixels that differ printed (the alpha draws come in another
    order, so the random streams of paths that meet the banners part);
    s/frame, launches a frame and peak MiB of both; the wide run may launch
    no fused traversal kernel, and both must launch the loop's kernels;
37. the full bistro at 1080p (fused shading) wide against fused on the
    same criterion: the wide frame may launch no ``vkrt_traverse_wide`` (a
    two-level call is one ``vkrt_wide_machine`` launch a pass); then the
    machine against its round loops on the bistro's 2^18 camera rays (the
    opaque and the alpha pass of the instance-level split, closest and any)
    and on 2^18 rays toward the foliage: every output bit for bit against
    its plain version, the round loop ``tlas._wide_rounds``, no host sync inside a pass (torch's sync debug mode),
    rounds per ray and per warp, each timed with its bound beside the fused
    back end's machines on the same rays; the CLI's ``--renderer wide`` at
    the reference CLI's defaults on the atrium; the viewer on the atrium
    switched to wide over HTTP, its picks equal to
    ``Renderer(renderer="wide").pick``;
38. the plaza of phase 28 (4,609 instances: the machine's instance table
    in global memory): the machine against its round loops on 2^18 world
    rays (closest and any, the opaque instances without the pack and the
    alpha instances with it), bit for bit, timed beside the fused back end's
    opaque and alpha machines on the same rays.

The pooled wavefront's loop (``integrator/wavefront.py``: the reference's
form, the state over the whole pool under its mask, the tiered tail, the
loop control on the card) and its two kernels (``csrc/wavefront.cu``):

39. ``vkrt_regenerate`` and ``vkrt_retire`` against their plain versions
    (``integrator/pool.py``) on the pools of a real 1080p fused atrium
    frame, as each stage met them at the loop's first iteration (a fresh
    pool of 2^18 lanes), its third (a full pool, some lanes regenerating)
    and the first of each tier (2^16, 2^14 lanes): every field, the loop
    control, the occupancy entry, the retired units' radiance and the step
    record bit for bit, and on the full pool cut to 1, 3 and 2,085 lanes
    (grids of one block and off a block's multiple); each timed on fresh copies with CUDA events beside
    the plain version and its bound (this pool's bytes: the flags, the
    granted lanes, the gated / visible / lit / alive / retiring lanes); the
    fused atrium, the fused atrium with ``renderer="wide"`` and the fused
    bistro at 1080p, frame 1, through the kernels and through the plain
    versions on the card, byte for byte and ray for ray; and a frame of each
    under torch's sync debug mode "error" inside every iteration
    (``wavefront.CHECK_SYNCS``): the iterations, one host read of the loop
    control an iteration, and the launches a frame and an iteration.

The alpha pass's need mask (``traverse_fused.alpha_need``), one launch of
``vkrt_root_prefilter`` a call, and its fold into ``vkrt_alpha_rounds``'
ray intake (the main path's form: no launch of its own):

40. the kernel against its plain version ``_alpha_need_plain`` on the card,
    the same bools, at widths 16 and 32: on the fused atrium's closest
    (t_limit the opaque hit) and shadow passes of a real 1080p frame at
    the loop's iterations 0, 2, 10 and 11 (2^18, 2^18, 2^16 and 2^14
    lanes), each timed on fresh copies beside the plain version and its
    bound (the flags, t_limit and rays the data needs, the children tested
    up to the first hit); and on every synthetic set of
    ``prefilter_rays`` (random, along the axes with +-0 and components
    below 1e-20, NaN and +-inf, t_limit <= 0 / INF / inf / NaN,
    subnormals) with ``active`` absent, about half and none; on each of
    those passes and sets the alpha pass's two forms, (a) the prefilter,
    then the rounds on its mask and (b) the rounds alone on the pass's
    ``active``, equal bit for bit in t, tri, u, v, seed and steps, with
    (b)'s intake counts (rays fetched, rays that needed the rounds) and, at
    width 16, its warps' busy / slot lane-steps; the frame's passes timed in
    both forms.

The script keeps its files (checkpoints, images, the port's scene cache)
in a temporary directory that it removes at exit. No depth was cut for
time: the whole script ran in about half its time limit on the card.

The line before the last is the per-kernel JSON summary (times, launches,
errors and each kernel's bound on this card; ``paths_launches``: the
launches of phases 31-34's paths, and for the wide kernels of phase 37's);
the last line is
``{"ok": true, "device": {...}}``.
"""

import atexit
import contextlib
import copy
import dataclasses
import io
import json
import os
import shutil
import sys
import tempfile
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
# the instance boxes is this design's choice, not counted (SCAN_OPS below).
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
# The two-level machines' instance scan (next_instance in csrc/traverse.cu),
# one a ray and one a round, per instance: the root test; for an instance
# inside the pass's mask its slab test (6 subtracts, 6 multiplies, 10
# min/max) and the 8 compares of the hit and (entry t, id) order tests: 31
# in all. Its bytes through L1 (every lane of a warp reads the same
# instance): the box and the root, 28 B, for a masked-in instance, the root
# alone otherwise. None of it is in the bound: a ray needs no test of every
# instance in every round (a tree over the instances would test a few), so
# the scans are printed beside the bound, with a second bound that counts
# them, and not in the kernels line.
SCAN_OPS, SCAN_L1_BYTES = 31, 28


def scan_work(n_rays, n_rounds, mask, n_inst):
    """(operations, L1 bytes) of the machines' instance scans: one scan a
    ray and one a round that moves on (``n_rounds``: the alpha machine's
    rejecting rounds stay and do not scan) over ``n_inst`` instances,
    ``mask`` (None: all) those inside the pass."""
    n_in = n_inst if mask is None else int(mask.sum())
    scans = n_rays + n_rounds
    return (scans * (n_inst + (SCAN_OPS - 1) * n_in),
            scans * (n_in * SCAN_L1_BYTES + (n_inst - n_in) * 4))


def scan_text(scans, n_bytes, n_ops):
    """The instance scans' line beside a machine's bound: their operations
    (every round's rescan), the bound with them counted, and their L1 bytes
    at the memory rate."""
    from vk_raytrace_torch import travbench as tb

    s_ops, l1_bytes = scans
    return (f"the instance scans (this design's work, not in the bound) {s_ops / 1e9:.3f} Gop, "
            f"with them the bound {tb.bound(n_bytes, n_ops + s_ops)[0]:.4f} ms; their L1 bytes "
            f"{l1_bytes / 1e9:.2f} GB, at the memory rate "
            f"{tb.bound(n_bytes + l1_bytes, n_ops + s_ops)[0]:.3f} ms")
# The round machines' first design (a thread per ray through trace<>, the
# stack and child list in local memory) on phases 17, 18, 19, 28 and 30's
# rays: ms per case as this script measured it then (NVIDIA H100 80GB
# HBM3, 700 W; PERF.md section 6). The cases it did not time are missing.
MACHINE_FIRST_MS = {
    "alpha_rounds": 0.392, "alpha_rounds_any": 0.264, "alpha_rounds_w32": 0.544,
    "alpha_rounds_any_w32": 0.360,
    "alpha_machine": 8.230, "alpha_machine_any": 5.239, "alpha_machine_w32": 12.494,
    "alpha_machine_any_w32": 8.336, "opaque_machine": 0.496, "opaque_machine_any": 0.304,
    "opaque_machine_full": 1.552, "opaque_machine_w32": 0.667, "opaque_machine_any_w32": 0.373,
    "opaque_machine_full_w32": 2.193, "plaza opaque_machine": 7.220,
    "plaza opaque_machine_any": 5.310, "plaza alpha_machine": 16.004,
    "plaza alpha_machine_any": 12.630, "all-alpha plaza alpha_machine (full tables)": 16.880,
    "all-alpha plaza alpha_machine_any (full tables)": 13.800,
}


# The arrays of an environment that the renderer samples and reads.
ENV_ARRAYS = ("image", "q", "alias", "pdf", "alias_pdf", "rows")


def environment_arrays(env):
    """An environment's tensors by name (:data:`ENV_ARRAYS`): the baked
    image, its alias table (q, alias), the pdfs and the packed rows."""
    a = env.accel
    return dict(image=env.image, q=a.q, alias=a.alias, pdf=a.pdf, alias_pdf=a.alias_pdf,
                rows=env.rows)


def same_environment(r, scene, cfg):
    """Renderer ``r``'s sun&sky environment against a second build of it on
    its device (``render.prepare_sun_sky``, as the renderer builds it):
    every array of :data:`ENV_ARRAYS` byte for byte. Returns the bytes
    compared."""
    from vk_raytrace_torch import render as R

    mine = environment_arrays(r.scene.env)
    again = environment_arrays(R.prepare_sun_sky(scene, cfg, r.device)[0].env)
    n = 0
    for k in ENV_ARRAYS:
        a, b = (x.contiguous().view(torch.uint8) for x in (mine[k], again[k]))
        assert mine[k].dtype == again[k].dtype and torch.equal(a, b), (
            f"two builds of the environment differ in {k}")
        n += a.numel()
    return n


def no_host_sync(run):
    """``run()`` (one pass) under torch's sync debug mode: it raises on a
    host sync inside the pass."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return run()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def machine_report(name, kind, planar, any_hit, n_inst, dev):
    """What the persistent machine's last call on ``dev``'s current stream
    shows (call it right after that call): ptxas of its instantiation
    (registers, stack frame, spill, static shared memory), its resident
    blocks of 128 an SM (with this instance table), the deepest stack its
    rays reached against the tree's bound, the share of its warps'
    lane-steps that did work (the kernel's own counts: the lanes' node steps
    over the lane slots of the warps' node loops), and the first design's
    time (:data:`MACHINE_FIRST_MS` under ``name``), as one text. ``kind``:
    False the opaque machine, True the alpha machine, ``tf.ROUNDS`` the
    single-level alpha rounds (``any_hit``: without culling), whose warps
    count their steps at width 16 only."""
    from vk_raytrace_torch import cuda_build
    from vk_raytrace_torch.ops import traverse_fused as tf

    w = planar.width
    if kind == tf.ROUNDS:
        entry = f"alpha_rounds_kernelILb{int(not any_hit)}ELi{w}EE"
    else:
        entry = (f"{'alpha' if kind else 'opaque'}_machine_kernelILb{int(any_hit)}ELi{w}ELb"
                 f"{int(n_inst > 512)}E")
    res = cuda_build.resources(f"traverse{w}", entry)
    busy, slots = tf._AB_GRIDS[w].lane_steps(dev)
    first = MACHINE_FIRST_MS.get(name)
    return (f"persistent warps: {res['registers']} registers, {res['stack_frame']} B stack "
            f"frame, {res['spill_stores'] + res['spill_loads']} B spill, {res['smem']} B static "
            f"shared, {tf.machine_occupancy(w, kind, any_hit, n_inst)} blocks of 128 an SM; "
            f"deepest stack {tf.stack_reached(w, dev)} of the tree's {planar.stack_depth}; "
            + (f"{busy / slots:.3f} of the warps' lane-steps busy ({busy} node steps)" if slots
               else "its warps count no steps at this width")
            + "; the first design "
            + (f"{first:.3f} ms" if first is not None else "not timed on these rays"))


# The bistro's render configuration (BASELINE config #5,
# scripts/baseline_configs.py:74-75, 93-97), at the main path's size.
BISTRO_CFG = dict(max_depth=4, max_samples=1, hdr_multiplier=1.0, firefly_clamp=10.0,
                  use_sun_sky=True, full_mis=False)
# Shading kernel vs its plain version on the card: the same float32
# operations in the same order with the same device math functions.
SHADE_RTOL, SHADE_ATOL, SHADE_MASK_SHARE = 1e-5, 1e-6, 0.9999
SMALL_ATRIUM = dict(bays_x=2, bays_z=2, column_segments=16, column_rows=12)
# BASELINE configurations #4 and #2 (scripts/baseline_configs.py:66-73, with
# the config's fixed fields at :85-89): the reference-compat estimator.
BASELINE4_CFG = dict(width=512, height=512, max_samples=4, max_depth=8, hdr_multiplier=1.0,
                     firefly_clamp=10.0, full_mis=False)
BASELINE2_CFG = dict(width=512, height=512, max_samples=16, max_depth=5, hdr_multiplier=1.0,
                     firefly_clamp=10.0, full_mis=False)
# The debug-mode phase: the full atrium at reduced resolution.
DEBUG_W, DEBUG_H, DEBUG_DEPTH = 160, 90, 4
# The single-level main path's kernels (LAUNCHES keys at width 16): modes a
# and b over the opaque tree and the alpha rounds over the alpha tree (whose
# ray intake runs the alpha pass's root prefilter).
ATRIUM_KERNELS = ("closest", "any", "alpha_rounds")
# The standalone root prefilter (vkrt_root_prefilter, both widths): folded
# into the alpha rounds' ray intake, so no path launches it; phase 40 holds
# it against its plain version and against the fold.
FOLDED_KERNELS = ("root_prefilter", "root_prefilter_w32")
# The capped entry (vkrt_traverse_capped, capped and no-gather, both widths):
# the traversal micro-bench's only (phase 14), so no main path launches it.
BENCH_KERNELS = ("capped", "nogather", "capped_w32", "nogather_w32")
# Kernel vs twin: the same float32 operations in the same order, rounded
# per operation on both sides (nvcc -fmad=false); t/u/v within a few ulp.
RTOL, ATOL = 1e-5, 1e-5
# Slice vs CPU twin: the CUDA and CPU math libraries round transcendentals
# differently, which flips a rare Russian-roulette or alpha branch.
PIX_RTOL, PIX_ATOL, PIX_SHARE, RAY_REL = 1e-3, 1e-4, 0.99, 1e-3


T_START = time.time()


def assert_folded(what, launches):
    """No path launches the standalone root prefilter (the alpha rounds'
    intake runs it) or the capped entry (the micro-bench's)."""
    assert not any(launches.get(k, 0) for k in FOLDED_KERNELS), (
        f"{what}: the standalone root prefilter launched: {launches}")
    assert not any(launches.get(k, 0) for k in BENCH_KERNELS), (
        f"{what}: the capped entry launched: {launches}")


def bench_report(bench, card):
    """Phase 14's summary of the micro-bench's lines ``bench`` ({(variant,
    width): line}): per width, each traversal variant's time per node
    visited (full, capped and no-gather all run mode a's persistent node
    loops), its kernel's ptxas report and resident blocks beside the full
    traversal's, the no-gather rows' bound both ways, and the a/b kernels'
    ptxas."""
    from vk_raytrace_torch import cuda_build
    from vk_raytrace_torch import travbench as tb
    from vk_raytrace_torch.ops import traverse_fused as tf

    for width in (16, 32):
        for name in tb.VARIANTS:
            x = bench[(name, width)]
            if name == "root_order":
                continue
            nodes = x["nodes_per_ray"] * x["rays"]
            kind = ("ring" if x["ring"] else "spilling stack") if "ring" in x else "a/b kernel"
            line = (f"w{width} {name}: {x['ms']:.4f} ms, {x['nodes_per_ray']:.3f} nodes/ray, "
                    f"{x['ms'] * 1e6 / nodes:.4f} ns per node; {x['registers']} registers, "
                    f"{x['stack_frame']} B frame, {x['spill_bytes']} B spill, "
                    f"{x['blocks_per_sm']} blocks/SM ({kind}), deepest stack "
                    f"{x['deepest_stack']}; bound {x['bound_ms']:.4f} ms by {x['bound_by']}")
            if "bytes_per_step" in x:
                line += (f" (its rows once; {x['bound_per_step_ms']:.4f} ms by "
                         f"{x['bound_per_step_by']} with each ray's row read at every step)")
            print(line + f" [{card}]", flush=True)
        for mode in ("closest", "any"):
            r = cuda_build.resources(f"traverse{width}",
                                     f"persistent_traverse_kernelILi{tf._MODE_ID[mode]}E")
            now = (r["registers"], r["stack_frame"], r["spill_stores"] + r["spill_loads"])
            print(f"w{width} vkrt_traverse_ab {mode}: {now[0]} registers, {now[1]} B frame, "
                  f"{now[2]} B spill", flush=True)


def phase(name):
    print(f"== {name} (at {time.time() - T_START:.1f} s)", flush=True)


def shade_lanes(flags):
    """The lanes of the shading body's inputs that csrc/shade.cu reads under
    ``flags``: (merged-row words, tap words, aux words). Not the
    uv-transform and texture-placement lanes, which the prologue reads, nor
    the row's padding."""
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
    return srow, taps, aux


def shade_bytes(n, flags):
    """Bytes the shading kernel moves for ``n`` lanes under ``flags``,
    counted from csrc/shade.cu in 32-byte sectors: the merged-row lanes it
    loads, the taps and footprint weights of the enabled textures, the rest
    of aux (:func:`shade_lanes`), and the outputs."""
    from vk_raytrace_torch.integrator import shade_fused as sf

    def sectors(lanes):
        return len({4 * i // 32 for i in lanes}) * 32

    return n * (sum(sectors(x) for x in shade_lanes(flags)) + sf.OUT_W * 4 + 2)


def build_kernels():
    """nvcc of every kernel source at once (one process each) and g++ of the
    native runtime meanwhile; returns seconds per library."""
    from concurrent.futures import ThreadPoolExecutor

    from vk_raytrace_torch import runtime
    from vk_raytrace_torch.integrator import pool as wp
    from vk_raytrace_torch.integrator import shade_fused as sf
    from vk_raytrace_torch.ops import traverse_fused as tf

    def timed(fn, *args, **kw):
        t0 = time.time()
        fn(*args, **kw)
        return time.time() - t0

    from vk_raytrace_torch.ops import traverse_wide as tw

    with ThreadPoolExecutor(6) as pool:
        futures = {
            "native": pool.submit(timed, runtime.build),
            **{f"traverse{w}": pool.submit(timed, tf.build, w, verbose=True) for w in tf.WIDTHS},
            "shade": pool.submit(timed, sf.build, verbose=True),
            "traverse_wide": pool.submit(timed, tw.build, verbose=True),
            "wavefront": pool.submit(timed, wp.build, verbose=True),
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


def render_phase(what, make, card, n=3, want=(), stage=None, black_ok=False):
    """Build a renderer with ``make()`` on a fresh peak and fresh counters,
    run one warm-up and ``n`` timed frames, check the image and the
    launches, and print s/frame, Mrays/s, counted launches per frame, build
    s and peak MiB. Returns (renderer, s/frame, Mrays/s, launches per
    frame, peak MiB)."""
    from vk_raytrace_torch.integrator import pool as wp
    from vk_raytrace_torch.integrator import shade_fused as sf
    from vk_raytrace_torch.ops import traverse_fused as tf

    dev = torch.device("cuda", 0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    tf.reset_launches()
    sf.reset_launches()
    wp.reset_launches()
    t0 = time.time()
    r = make()
    torch.cuda.synchronize()
    renderer_s = time.time() - t0
    warm_s, frame_s, frame_rays = run_frames(r, n)
    per_frame = {k: v / (n + 1) for k, v in {**tf.LAUNCHES, **sf.LAUNCHES, **wp.LAUNCHES}.items()
                 if v}
    img = r.hdr().cpu().numpy()
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    s_frame = float(np.mean(frame_s))
    mrays = float(np.sum(frame_rays) / np.sum(frame_s) / 1e6)
    assert np.isfinite(img).all(), f"{what}: non-finite pixels"
    assert black_ok or img.mean() > 0.0, f"{what}: black image"
    assert all(per_frame.get(k, 0) > 0 for k in want), f"{what}: a kernel never launched: {per_frame}"
    assert_folded(what, per_frame)
    if stage is not None:
        assert r.stage == stage, f"{what}: the {r.stage} stage ran, not the {stage} one"
    print(f"{what}: {s_frame:.4f} s/frame (frames {['%.4f' % x for x in frame_s]}, warm-up "
          f"{warm_s:.3f}), {mrays:.4f} Mrays/s, rays/frame {frame_rays}, {r.stage} shading, "
          f"launches/frame {per_frame}, build s: renderer {renderer_s:.2f}, "
          + ", ".join(f"{k} {v:.2f}" for k, v in r.build_times.items())
          + f"; peak {peak_mb:.1f} MiB allocated, mean radiance {img.mean():.4f} [{card}]",
          flush=True)
    return r, s_frame, mrays, per_frame, peak_mb


def random_rays(rng, positions, n, dev):
    """Origins inside the scene's bounds, uniform random directions."""
    lo, hi = positions.min(0), positions.max(0)
    o = rng.uniform(lo + 0.05 * (hi - lo), hi - 0.05 * (hi - lo), (n, 3))
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.tensor(o, dtype=torch.float32, device=dev),
            torch.tensor(d, dtype=torch.float32, device=dev))


# The root prefilter's synthetic ray sets (prefilter_rays) and its active
# masks: none (every ray), about half, none active.
PREFILTER_CASES = ("random", "axes", "nan", "t_limit", "subnormal")
PREFILTER_ACTIVE = ("absent", "partial", "none")


def prefilter_rays(case, planar, n, rng):
    """``n`` rays for the alpha pass's root prefilter (``tf.alpha_need``)
    against ``planar``'s root row, from the numpy generator ``rng``:
    ``random``: origins inside and around the root children's union box,
    half aimed at a point of a random child's box, t_limit in (0.1, twice
    the box) or INF (a quarter); ``axes``: directions along +-x, y or z with
    the other components among +-0 and normal magnitudes below 1e-20, a
    tenth tiny in every component, a fifth of the origins on a child's
    bounding plane; ``nan``: NaN or +-inf in one component of the origin or
    the direction, or in t_limit, +-3e38 in the origin or t_limit (an eighth
    of the rays left clean); ``t_limit``: t_limit among -1, +-0, 1e-30,
    1e-3, INF, inf, -inf and NaN; ``subnormal``: a subnormal component of
    the direction or the origin, or a direction component so large that its
    reciprocal is subnormal. Returns float32 CPU tensors (origin,
    direction, t_limit)."""
    row = planar.rows[0].cpu().numpy().astype(np.float64)
    w = planar.width
    bmin, bmax = row[:3 * w].reshape(3, w).T, row[3 * w:6 * w].reshape(3, w).T
    kids = np.flatnonzero(row[:w] <= row[3 * w:4 * w])
    lo, hi = bmin[kids].min(0), bmax[kids].max(0)
    ext = hi - lo
    o = rng.uniform(lo - 0.5 * ext, hi + 0.5 * ext, (n, 3))
    pick = rng.choice(kids, n)
    d = rng.normal(size=(n, 3))
    aim = rng.random(n) < 0.5
    d[aim] = rng.uniform(bmin[pick], bmax[pick])[aim] - o[aim]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_limit = np.where(rng.random(n) < 0.25, 1e32, rng.uniform(0.1, 2.0 * ext.max(), n))
    rows_n = np.arange(n)
    k = rng.integers(0, 3, n)  # a component per ray
    if case == "axes":
        tiny = np.array([0.0, -0.0, 1e-21, -1e-21, 9.9e-21, -9.9e-21, 2e-38, -2e-38])
        d = tiny[rng.integers(0, len(tiny), (n, 3))]
        main = rng.random(n) >= 0.1
        d[rows_n[main], k[main]] = rng.choice([-1.0, 1.0], int(main.sum()))
        plane = rng.random(n) < 0.2
        j = (k + 1) % 3
        face = np.where(rng.random(n) < 0.5, bmin[pick, j], bmax[pick, j])
        o[rows_n[plane], j[plane]] = face[plane]
    elif case == "nan":
        bad = np.array([np.nan, np.inf, -np.inf, 3e38, -3e38])[rng.integers(0, 5, n)]
        bad_d = np.where(np.abs(bad) == 3e38, np.nan, bad)  # 1 / 3e38 is subnormal
        where = rng.integers(0, 8, n)  # 0 origin, 1 direction, 2 t_limit, 3-7 clean
        o[rows_n[where == 0], k[where == 0]] = bad[where == 0]
        d[rows_n[where == 1], k[where == 1]] = bad_d[where == 1]
        t_limit[where == 2] = bad[where == 2]
    elif case == "t_limit":
        t_limit = np.array([-1.0, 0.0, -0.0, 1e-30, 1e-3, 1e32, np.inf, -np.inf,
                            np.nan])[rng.integers(0, 9, n)]
    elif case == "subnormal":
        sub = np.array([1e-40, -1e-40, 1e-44, -1e-44, 3e38, -3e38, 1e38, -1e38])
        where = rng.integers(0, 3, n)  # 0 direction, 1 origin (subnormal only), 2 clean
        d[rows_n[where == 0], k[where == 0]] = sub[rng.integers(0, len(sub), n)][where == 0]
        o[rows_n[where == 1], k[where == 1]] = sub[rng.integers(0, 4, n)][where == 1]
    elif case != "random":
        raise ValueError(f"no prefilter case {case!r}")
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))  # noqa: E731
    return f32(o), f32(d), f32(t_limit)


def prefilter_active(kind, n, rng):
    """The active mask of :data:`PREFILTER_ACTIVE` kind ``kind`` (None: absent)."""
    if kind == "absent":
        return None
    return torch.from_numpy(rng.random(n) < (0.5 if kind == "partial" else 0.0))


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


# The plaza (phases 28-30): a 48 x 48 grid of trees, each an opaque trunk and
# an alpha-MASK foliage cluster (two nodes of shared meshes), and the ground:
# 4,609 instances, more than a block's shared memory holds (76 B each).
PLAZA = dict(nx=48, nz=48, trunk_segments=16, trunk_rings=8, cards=96)


def write_plaza(path, nx, nz, trunk_segments, trunk_rings, cards, ground=True, trunks=True):
    """Write a glTF of an ``nx`` x ``nz`` grid of trees: each position a
    trunk node (an open cylinder of ``2 * trunk_segments * trunk_rings``
    opaque triangles) and a foliage node (``cards`` double-sided vertical
    quads around the trunk's top, ``alphaMode: MASK`` with an 8-bit RGBA
    texture whose alpha cuts gaps into the cards), plus one ground node and
    a camera over a corner looking across the grid. ``trunks``/``ground``
    False leaves those nodes out (without both, every triangle is
    alpha-tested). The meshes are shared, so ``--instancing auto`` loads two
    levels. Returns the number of nodes that draw a mesh."""
    import base64

    from vk_raytrace_torch.utils import png as png_mod

    spacing, tex = 3.0, 32  # metres between trees; the texture's side in texels

    def ring(k, y, r):
        a = 2 * np.pi * k / trunk_segments
        return [r * np.cos(a), y, r * np.sin(a)]

    # The trunk: rings of vertices up a tapering cylinder, quads between.
    tv = [ring(k, 2.2 * j / trunk_rings, 0.18 - 0.06 * j / trunk_rings)
          for j in range(trunk_rings + 1) for k in range(trunk_segments)]
    ti = []
    for j in range(trunk_rings):
        for k in range(trunk_segments):
            a, b = j * trunk_segments + k, j * trunk_segments + (k + 1) % trunk_segments
            ti += [[a, b + trunk_segments, b], [a, a + trunk_segments, b + trunk_segments]]
    tuv = [[k / trunk_segments, j / trunk_rings] for j in range(trunk_rings + 1)
           for k in range(trunk_segments)]
    # The foliage: vertical cards turned about the axis, at rising heights.
    fv, fi, fuv = [], [], []
    for c in range(cards):
        a = np.pi * c / cards * 7.0
        y0 = 1.4 + 1.6 * ((c * 0.618) % 1.0)
        dx, dz = 0.9 * np.cos(a), 0.9 * np.sin(a)
        base = len(fv)
        fv += [[-dx, y0, -dz], [dx, y0, dz], [dx, y0 + 1.2, dz], [-dx, y0 + 1.2, -dz]]
        fuv += [[0, 1], [1, 1], [1, 0], [0, 0]]
        fi += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    half = spacing * max(nx, nz) / 2 + 4.0
    gv = [[-half, 0, -half], [half, 0, -half], [half, 0, half], [-half, 0, half]]
    gi = [[0, 2, 1], [0, 3, 2]]
    guv = [[0, 0], [1, 0], [1, 1], [0, 1]]

    blob, views, accessors = bytearray(), [], []

    def add(arr, ctype, kind, target):
        data = np.ascontiguousarray(arr).tobytes()
        views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": len(data),
                      "target": target})
        blob.extend(data + b"\0" * (-len(data) % 4))
        acc = {"bufferView": len(views) - 1, "componentType": ctype, "count": len(arr),
               "type": kind}
        if kind == "VEC3":
            acc["min"] = np.asarray(arr).min(0).tolist()
            acc["max"] = np.asarray(arr).max(0).tolist()
        accessors.append(acc)
        return len(accessors) - 1

    def mesh(v, i, uv, mat):
        prim = {"attributes": {"POSITION": add(np.asarray(v, np.float32), 5126, "VEC3", 34962),
                               "TEXCOORD_0": add(np.asarray(uv, np.float32), 5126, "VEC2", 34962)},
                "indices": add(np.asarray(i, np.uint32).ravel(), 5125, "SCALAR", 34963),
                "material": mat}
        return {"primitives": [prim]}

    # The foliage texture: green cards with round holes (alpha 0) in them.
    yy, xx = np.mgrid[0:tex, 0:tex]
    holes = ((xx % 8 - 3.5) ** 2 + (yy % 8 - 3.5) ** 2) < 6.0
    rgba = np.stack([40 + (xx * 3) % 60, 120 + (yy * 5) % 100, np.full_like(xx, 30),
                     np.where(holes, 0, 255)], -1).astype(np.uint8)
    img_uri = "data:image/png;base64," + base64.b64encode(png_mod.encode(rgba)).decode()
    meshes = [mesh(gv, gi, guv, 0), mesh(tv, ti, tuv, 1), mesh(fv, fi, fuv, 2)]
    nodes = [{"mesh": 0}] if ground else []
    for ix in range(nx):
        for iz in range(nz):
            turn = 0.37 * (ix * nz + iz)
            rot = [0.0, float(np.sin(turn / 2)), 0.0, float(np.cos(turn / 2))]
            at = [spacing * (ix - (nx - 1) / 2), 0.0, spacing * (iz - (nz - 1) / 2)]
            if trunks:
                nodes.append({"mesh": 1, "translation": at, "rotation": rot})
            nodes.append({"mesh": 2, "translation": at, "rotation": rot,
                          "scale": [1.0, 0.8 + 0.4 * ((ix + 2 * iz) % 5) / 4, 1.0]})
    n_draw = len(nodes)
    # The camera over a corner, looking across the grid and down at it.
    eye = np.array([-spacing * nx / 2 - 2.0, 9.0, -spacing * nz / 2 - 2.0])
    fwd = -eye * np.array([1.0, 0.0, 1.0]) / np.linalg.norm(eye[[0, 2]]) + [0, -0.35, 0]
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0, 1, 0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, up, -fwd, eye
    nodes.append({"camera": 0, "matrix": m.T.ravel().tolist()})
    doc = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes, "meshes": meshes,
        "cameras": [{"type": "perspective", "perspective": {"yfov": 0.8, "aspectRatio": 16 / 9,
                                                            "znear": 0.1}}],
        "materials": [
            {"pbrMetallicRoughness": {"baseColorFactor": [0.5, 0.48, 0.45, 1.0],
                                      "roughnessFactor": 0.9, "metallicFactor": 0.0}},
            {"pbrMetallicRoughness": {"baseColorFactor": [0.35, 0.22, 0.12, 1.0],
                                      "roughnessFactor": 0.8, "metallicFactor": 0.0}},
            {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                      "roughnessFactor": 0.6, "metallicFactor": 0.0},
             "alphaMode": "MASK", "alphaCutoff": 0.5, "doubleSided": True},
        ],
        "textures": [{"source": 0, "sampler": 0}], "samplers": [{}],
        "images": [{"uri": img_uri}],
        "accessors": accessors, "bufferViews": views,
        "buffers": [{"byteLength": len(blob),
                     "uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(bytes(blob)).decode()}],
    }
    with open(path, "w") as f:
        json.dump(doc, f)
    return n_draw


def cloud_instances(rng, n_tris=1500, n_inst=6, width=16):
    """A two-level scene whose traversals go deep, for the persistent
    machines' stack spill: an opaque and an alpha-blended (alpha 0.5) cloud
    of ``n_tris`` large random triangles about the unit cube, whose boxes
    overlap, so that a ray entering a cloud enters most child boxes of every
    row it meets and pushes them; each cloud instanced ``n_inst // 2`` times
    along x. Returns (accel, alpha pack) on the CPU, the pack per triangle."""
    from vk_raytrace_torch.models import schema as S
    from vk_raytrace_torch.models.instances import InstancedSceneBuilder
    from vk_raytrace_torch.ops import tlas
    from vk_raytrace_torch.ops.traverse_wide import make_alpha_pack

    b = InstancedSceneBuilder()
    meshes = []
    for mat, mode in ((0, S.ALPHA_OPAQUE), (1, S.ALPHA_BLEND)):
        pos = rng.uniform(0.0, 1.0, (n_tris, 1, 3)) + rng.normal(0.0, 0.3, (n_tris, 3, 3))
        meshes.append(b.add_mesh(pos.reshape(-1, 3), np.arange(3 * n_tris).reshape(-1, 3), mat,
                                 uv=rng.uniform(0.0, 1.0, (3 * n_tris, 2)), alpha_mode=mode))
    for i in range(n_inst):
        x = np.eye(4)
        x[:3, 3] = (1.25 * i, 0.1 * (i % 3), 0.0)
        b.add_instance(meshes[i % 2], x)
    pool, inst = b.build()
    mats = S.make_materials([dict(), dict(alpha_mode=S.ALPHA_BLEND,
                                          base_color_factor=[1, 1, 1, 0.5])]).to("cpu")
    pack = make_alpha_pack(mats, S.dummy_atlas().to("cpu"),
                           torch.as_tensor(np.asarray(pool.geometry.tri_material)).long())
    return tlas.build_instanced_accel(pool, inst, width).to("cpu"), pack


def alpha_cloud(rng, n_tris, dev, width=16, n_rays=4099):
    """A single-level scene whose alpha rounds go deep, for the spill of the
    rounds kernel's stack: an alpha-blended (alpha 0.5) cloud of ``n_tris``
    large random triangles about the unit cube, whose boxes overlap, so that
    a ray entering it enters most child boxes of every row it meets and
    pushes them. Returns (alpha tree, alpha pack, (origin, direction,
    window, seed, need)) on ``dev``: ``n_rays`` rays from beside the cloud
    into it, windows 1 to 8 long, 95% of them active."""
    from vk_raytrace_torch.models import schema as S
    from vk_raytrace_torch.models.builder import GeometryBuilder
    from vk_raytrace_torch.ops.bvh8 import build_accel_bundle
    from vk_raytrace_torch.ops.traverse_wide import make_alpha_pack

    b = GeometryBuilder()
    pos = rng.uniform(0.0, 1.0, (n_tris, 1, 3)) + rng.normal(0.0, 0.3, (n_tris, 3, 3))
    b.add_mesh(pos.reshape(-1, 3), np.arange(3 * n_tris).reshape(-1, 3), 0,
               uv=rng.uniform(0.0, 1.0, (3 * n_tris, 2)), alpha_mode=S.ALPHA_BLEND)
    geom = b.build()
    mats = S.make_materials([dict(alpha_mode=S.ALPHA_BLEND, base_color_factor=[1, 1, 1, 0.5])])
    pack = make_alpha_pack(mats.to(dev), S.dummy_atlas().to(dev),
                           torch.as_tensor(np.asarray(geom.tri_material), device=dev).long())
    planar = build_accel_bundle(geom, width=width).alpha_planar.to(dev)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    o = f32(rng.uniform([-1.0, 0.0, 0.0], [-0.2, 1.0, 1.0], (n_rays, 3)))
    d = f32(rng.normal([1.0, 0.0, 0.0], 0.3, (n_rays, 3)))
    d = (d / d.norm(dim=1, keepdim=True)).contiguous()
    rays = (o, d, f32(rng.uniform(1.0, 8.0, n_rays)),
            torch.tensor(rng.integers(0, 2**32, n_rays), dtype=torch.int64, device=dev),
            torch.tensor(rng.random(n_rays) < 0.95, device=dev))
    return planar, pack, rays


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
        self.active = None  # every lane live

    def masked(self, rng, live_share):
        """The same lanes under an ``active`` mask with ``1 - live_share``
        of them dead, scattered among the live ones (the pooled loop's
        state)."""
        out = copy.copy(self)
        out.active = torch.tensor(rng.random(self.seed.shape[0]) < live_share,
                                  device=self.seed.device)
        return out

    def lanes(self):
        return (self.origin, self.direction, self.seed, self.active, self.radiance,
                self.throughput, self.absorption, self.bsdf_pdf)


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
    path's (sun disk, full MIS, mip) ``main``; the same under an ``active``
    mask with 30% of the lanes dead; with each of the three flipped; and
    every branch (:func:`every_branch_stage`) with full MIS on and off.
    Returns {"main": result on the main path's flags, "err": max
    |err| of all}."""
    sun, mis, mip = main
    sp = lambda on: spread if on else None  # noqa: E731
    flags = f"sun disk {sun}, full MIS {mis}, mip {mip}"
    res = {"main": stage_case(f"{name} camera hits, the main path's flags ({flags})", scene,
                              tables, features, hit, st, instances, sun, mis, sp(mip), hdr_mult,
                              card)}
    errs = [res["main"][0]]
    # The pooled loop's form: dead lanes among the live ones, under the mask.
    errs.append(stage_case(f"{name} camera hits, the main path's flags, 30% of the lanes dead "
                           f"(active mask)", scene, tables, features, hit, st.masked(rng, 0.7),
                           instances, sun, mis, sp(mip), hdr_mult, card, reps=3)[0])
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
    stack frame, spill) from the shading library's build; for the body, its
    blocks' staged inputs (dynamic shared memory) and blocks an SM."""
    from vk_raytrace_torch import cuda_build
    from vk_raytrace_torch.integrator import shade_fused as sf

    lib = sf._load()
    for label, entry in (("stage single-level", "shade_stage_kernelILb0E"),
                         ("stage instanced", "shade_stage_kernelILb1E"),
                         ("body single-level", "shade_kernelILb0E"),
                         ("body instanced", "shade_kernelILb1E")):
        rep = cuda_build.resources("shade", entry)
        extra = ""
        if label.startswith("body"):
            inst = int(label.endswith("instanced"))
            extra = (f", {lib.vkrt_shade_body_smem(inst)} B dynamic shared a block, "
                     f"{lib.vkrt_shade_body_occupancy(inst)} blocks/SM")
        print(f"ptxas {label}: {rep['registers']} registers, {rep['stack_frame']} B stack "
              f"frame, {rep['spill_stores']} B spill stores, {rep['spill_loads']} B spill "
              f"loads, {rep['smem']} B shared{extra} ({card})", flush=True)


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
    assert tb.same_hits(kern, twin), f"{name}: t/tri/u/v/steps not bit-exact with the twin"
    if mode == "candidate":
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(kern[5:], twin[5:])), f"{name}: uvu/uvv not bit-exact"
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
    # The kernel's own line (the deepest stack: its last timed call's): the
    # a/b entry from the root, else the per-round entry.
    if root0 is None and mode != "candidate":
        rep, which = tb.ab_report(planar.width, mode, oo.device), "a/b"
    else:
        rep = tb.round_report(planar.width, mode, cull, root0 is not None, oo.device)
        which = "per-round"
    note += (f" [{which} kernel: bit-exact; {rep['registers']} registers, "
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


def warp_steps(nodes):
    """The share of a thread-per-ray warp's lane-steps that do work (32
    consecutive rays a warp, each warp running its longest ray's node
    steps), from each ray's node steps: an upper bound for the first design,
    which also split a warp between interior and leaf rows within a step."""
    w = nodes.double()
    w = torch.nn.functional.pad(w, (0, (-w.numel()) % 32)).view(-1, 32)
    return float(w.sum() / (32 * w.amax(dim=1)).sum().clamp(min=1))


def machine_case(name, planar, kernel, loop, key, loop_key, exact, work_bytes_ops, card,
                 report=None, round_steps=1):
    """A round machine kernel (``kernel()``, one launch of ``key``) against
    its round loop driving the per-round kernel (``loop()``, launches of
    ``loop_key``) and against the fully plain round loop (``loop(trav=the
    twin, rounds=...)``): the output fields ``exact`` equal, the others
    (t, u, v) within RTOL/ATOL. The kernel is timed (CUDA events), the round
    loop's wall (CUDA events, which span its host syncs) and device time
    (profiler), the plain loop once on the host clock; the bound is counted
    by ``work_bytes_ops(seen rows, rounds per ray, candidates, plain outputs,
    rejected candidates)`` -> (bytes, operations, the instance scans'
    (operations, L1 bytes) or None, printed beside the bound) from the plain
    run, which also gives the rounds per warp (a thread per ray, 32
    consecutive rays a warp: the first design's grouping). ``report`` (the
    persistent machines), called right after the kernel's first call, gives
    the kernel's own line (:func:`machine_report`); the pass then runs once
    more under torch's sync debug mode (no host sync inside).
    ``round_steps``: the steps each round adds to the plain steps (the last
    output) beside its nodes.
    Returns ((max |err|, (ms, plain_ms), bound), the per-round kernel's
    launches in one round-loop call)."""
    import chip_profile
    from vk_raytrace_torch import travbench as tb
    from vk_raytrace_torch.ops import traverse_fused as tf

    before = dict(tf.LAUNCHES)
    kern = kernel()
    torch.cuda.synchronize()
    assert tf.LAUNCHES[key] == before[key] + 1 and tf.LAUNCHES[loop_key] == before[loop_key], (
        f"{name}: the pass did not run as one {key} launch")
    own = ""
    if report is not None:
        own = "; " + report()
        no_host_sync(kernel)
        own += "; no host sync in the pass"
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
    with counting_rejects() as rejects:
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
    n_bytes, n_ops, scans = work_bytes_ops(seen, rounds, cands[0], plain, rejects[0])
    bnd = tb.bound(n_bytes, n_ops)
    mean_r, warp_max, used = warp_rounds(rounds)
    scan_note = "" if scans is None else "; " + scan_text(scans, n_bytes, n_ops)
    if report is not None:
        own += (f"; a thread-per-ray warp's lane-steps busy at most "
                f"{warp_steps(plain[-1] - round_steps * rounds):.3f}")
    print(f"{name}: {n} rays, {int(rounds.sum())} rounds ({mean_r:.2f} per ray; a thread per "
          f"ray: the warps' most {warp_max:.2f} on average, {used:.3f} of their lane-rounds used; at most "
          f"{int(rounds.max())}), {cands[0]} candidates, hit {float((kern[1] >= 0).float().mean()):.4f}; "
          f"exact vs round loop and plain loop, max |err| {err:.3g} -> OK; kernel {ms:.3f} ms "
          f"(1 launch); round loop {loop_ms:.3f} ms wall, {loop_busy:.3f} ms device busy, "
          f"{len(events)} device activities, {loop_launches} per-round launches; plain loop "
          f"{plain_ms:.1f} ms; bound {bnd[0]:.4f} ms by {bnd[1]} ({n_bytes / 1e6:.1f} MB, "
          f"{int((seen == 1).sum())} interior + {int((seen == 2).sum())} leaf rows of "
          f"{planar.rows.shape[0]}, {n_ops / 1e9:.3f} Gop; {ms / bnd[0]:.1f}x the bound)"
          f"{scan_note}{own} ({card})", flush=True)
    return (err, (ms, plain_ms), bnd), loop_launches


def alpha_machine_case(name, acc, pack, o, d, t_max, seed, act, any_hit, card):
    """Phase 17: the alpha machine kernel on these world rays; see
    :func:`machine_case`. Bound: MACHINE_* per ray, instance and candidate,
    each distinct alpha BLAS row, and the rounds' nodes; the instance scans
    beside it."""
    from vk_raytrace_torch import travbench as tb
    from vk_raytrace_torch.ops import tlas
    from vk_raytrace_torch.ops import traverse_fused as tf

    planar = acc.blas_planar_alp
    args = (acc, pack, o, d, t_max, seed, act, any_hit, not any_hit)
    n, n_inst = o.shape[0], acc.inst.aabb_min.shape[0]

    def work(seen, rounds, cands, plain, rejects):
        n_rounds = float(rounds.double().sum())
        nodes = float(plain[6].double().sum()) - n_rounds
        rows_b, _, _ = tb.traversal_bytes(0, 0, seen, planar.width, "candidate")
        return (n * MACHINE_RAY_BYTES + n_inst * MACHINE_INST_BYTES + rows_b
                + cands * MACHINE_CAND_BYTES,
                nodes * tb.ops_per_node(planar.width) + n_rounds * MACHINE_ROUND_OPS
                + cands * MACHINE_CAND_OPS,
                scan_work(n, n_rounds - rejects, acc.inst_alpha, n_inst))

    return machine_case(
        name, planar, lambda: tlas._two_level_alpha_pass(*args),
        lambda **kw: tlas._alpha_rounds(*args, **kw), tf.launch_key("alpha_machine", planar.width),
        tf.launch_key("candidate_roots", planar.width), (1, 4, 5, 6), work, card,
        report=lambda: machine_report(name, True, planar, any_hit, n_inst, o.device))


def alpha_rounds_case(name, planar, pack, o, d, t_lim, seed, act, cull, card):
    """Phase 18: the single-level alpha rounds kernel (persistent warps) on
    these rays, with the window the caller gives them
    (``traverse_alpha._alpha_rounds``: active, a window past 0 and the root
    prefilter); see :func:`machine_case`; its own line (:func:`machine_report`).
    Bound: ROUNDS_* per ray and round, MACHINE_CAND_* per candidate, each
    distinct alpha row, and the rounds' nodes."""
    from vk_raytrace_torch import travbench as tb
    from vk_raytrace_torch.ops import traverse_alpha as ta
    from vk_raytrace_torch.ops import traverse_fused as tf

    need = act & (t_lim > 0.0) & tf.root_prefilter(planar, o, d, t_lim)
    args = (planar, pack, o, d, t_lim, seed, need, cull)
    n = o.shape[0]

    def work(seen, rounds, cands, plain, rejects):
        rows_b, _, _ = tb.traversal_bytes(0, 0, seen, planar.width, "candidate")
        return (n * ROUNDS_RAY_BYTES + rows_b + cands * MACHINE_CAND_BYTES,
                float(plain[5].double().sum()) * tb.ops_per_node(planar.width)
                + float(rounds.double().sum()) * ROUNDS_ROUND_OPS + cands * MACHINE_CAND_OPS,
                None)

    return machine_case(
        name, planar, lambda: ta._rounds(*args), lambda **kw: ta._rounds_core(*args, **kw),
        tf.launch_key("alpha_rounds", planar.width), tf.launch_key("candidate", planar.width),
        (1, 4, 5), work, card,
        report=lambda: machine_report(name, tf.ROUNDS, planar, not cull, 0, o.device),
        round_steps=0)


def opaque_machine_case(name, acc, subset, o, d, t_max, act, any_hit, card):
    """Phase 19: the two-level opaque machine kernel on these world rays over
    ``acc``'s ``subset`` ("opq" or "full", ``tlas._subset``); see
    :func:`machine_case`. Bound: OPAQUE_* per ray and round,
    MACHINE_INST_BYTES per instance, each distinct BLAS row, and the rounds'
    nodes; the instance scans beside it."""
    from vk_raytrace_torch import travbench as tb
    from vk_raytrace_torch.ops import tlas
    from vk_raytrace_torch.ops import traverse_fused as tf

    planar, roots, inst, mask = tlas._subset(acc, subset)
    args = (planar, roots, inst, o, d, t_max, act, mask, not any_hit, any_hit)
    mode = "any" if any_hit else "closest"
    n, n_inst = o.shape[0], inst.aabb_min.shape[0]

    def work(seen, rounds, cands, plain, rejects):
        n_rounds = float(rounds.double().sum())
        nodes = float(plain[5].double().sum()) - n_rounds
        rows_b, _, _ = tb.traversal_bytes(0, 0, seen, planar.width, mode)
        return (n * OPAQUE_RAY_BYTES + n_inst * MACHINE_INST_BYTES + rows_b,
                nodes * tb.ops_per_node(planar.width) + n_rounds * OPAQUE_ROUND_OPS,
                scan_work(n, n_rounds, mask, n_inst))

    return machine_case(
        name, planar,
        lambda: tlas._two_level_opaque_pass(acc, subset, o, d, t_max, act, not any_hit, any_hit),
        lambda **kw: tlas._two_level_pass(*args, **kw),
        tf.launch_key("opaque_machine", planar.width), tf.launch_key(f"{mode}_roots", planar.width),
        (1, 4, 5), work, card,
        report=lambda: machine_report(name, False, planar, any_hit, n_inst, o.device))


@contextlib.contextmanager
def counting_rejects():
    """Count the alpha tests that reject a candidate while the block runs
    (``traverse_alpha._alpha_accept``, which the round loops look up at
    call time); yields a one-element list."""
    from vk_raytrace_torch.ops import traverse_alpha as ta

    real, count = ta._alpha_accept, [0]

    def counted(pack, tri, uvu, uvv, seed, cand):
        passed, seed = real(pack, tri, uvu, uvv, seed, cand)
        count[0] += int((cand & ~passed).sum())
        return passed, seed

    ta._alpha_accept = counted
    try:
        yield count
    finally:
        ta._alpha_accept = real


def plaza_machine_case(name, acc, subset, pack, o, d, t_max, seed, act, any_hit, card):
    """Phases 28 and 30: one round machine (the opaque machine over
    ``subset``, or the alpha machine over it with ``pack``) against its
    round loop on the card, every round's traversal by the twin and the
    candidates by the chunked scan above 512 instances: every output bit
    for bit. The kernel timed (CUDA events), the loop once on the host
    clock; the bound counts the rays once, the instance table once, each
    distinct BLAS row once and the rounds' nodes; the instance scans
    (:func:`scan_work`) are printed beside it (:func:`scan_text`). Returns
    (max |err|, (ms, plain_ms), bound) and the kernel's launches."""
    from vk_raytrace_torch import travbench as tb
    from vk_raytrace_torch.ops import tlas
    from vk_raytrace_torch.ops import traverse_fused as tf

    planar, roots, inst, mask = tlas._subset(acc, subset)
    alpha = pack is not None
    key = tf.launch_key("alpha_machine" if alpha else "opaque_machine", planar.width)
    if alpha:
        args = (acc, pack, o, d, t_max, seed, act, any_hit, not any_hit)

        def run():
            return tlas._two_level_alpha_pass(*args, subset=subset)

        def loop(**kw):
            return tlas._alpha_rounds(*args, subset=subset, **kw)
    else:
        def run():
            return tlas._two_level_opaque_pass(acc, subset, o, d, t_max, act, not any_hit,
                                               any_hit)

        def loop(**kw):
            return tlas._two_level_pass(planar, roots, inst, o, d, t_max, act, mask,
                                        not any_hit, any_hit, **kw)
    before = tf.LAUNCHES[key]
    kern = run()
    torch.cuda.synchronize()
    launches = tf.LAUNCHES[key] - before
    assert launches == 1, f"{name}: {launches} launches of {key}"
    own = machine_report(name, alpha, planar, any_hit, acc.inst.aabb_min.shape[0], o.device)
    no_host_sync(run)
    seen = torch.zeros(planar.rows.shape[0], dtype=torch.int8, device=planar.rows.device)
    cands = [0]

    def plain_trav(planar, o, d, tm, active, mode, cull, root0=None):
        out = tf._traverse_plain(planar, o, d, tm, active, mode, cull, seen, root0=root0)
        cands[0] += int((out[1] >= 0).sum())
        return out

    n = o.shape[0]
    rounds = torch.zeros(n, dtype=torch.int32, device=o.device)
    t0 = time.perf_counter()
    with counting_rejects() as rejects:
        plain = loop(trav=plain_trav, rounds=rounds)
        torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    for k, (a, b) in enumerate(zip(kern, plain)):
        a, b = a.to(b.dtype), b
        same = (torch.equal(a.view(torch.int32), b.view(torch.int32)) if b.dtype == torch.float32
                else torch.equal(a, b))
        assert same, f"{name}: output {k} not bit-exact with the chunked round loop"
    ms = tb.cuda_time(run, 5)
    n_inst = acc.inst.aabb_min.shape[0]
    n_in = int(mask.sum()) if mask is not None else n_inst
    n_rounds = float(rounds.double().sum())
    steps = plain[6] if alpha else plain[5]
    nodes = float(steps.double().sum()) - n_rounds
    mode = "candidate" if alpha else ("any" if any_hit else "closest")
    rows_b, _, _ = tb.traversal_bytes(0, 0, seen, planar.width, mode)
    scans = scan_work(n, n_rounds - rejects[0], mask, n_inst)
    n_bytes = (n * (MACHINE_RAY_BYTES if alpha else OPAQUE_RAY_BYTES)
               + n_inst * MACHINE_INST_BYTES + rows_b + (cands[0] * MACHINE_CAND_BYTES if alpha
                                                         else 0))
    n_ops = (nodes * tb.ops_per_node(planar.width)
             + n_rounds * (MACHINE_ROUND_OPS if alpha else OPAQUE_ROUND_OPS)
             + (cands[0] * MACHINE_CAND_OPS if alpha else 0))
    bnd = tb.bound(n_bytes, n_ops)
    mean_r, warp_max, used = warp_rounds(rounds)
    own += (f"; a thread-per-ray warp's lane-steps busy at most "
            f"{warp_steps(steps - rounds):.3f}")
    print(f"{name}: {n} rays, {n_inst} instances ({n_in} in the pass, table in "
          f"{'global' if n_inst > tlas._DENSE_I_MAX else 'shared'} memory), {int(n_rounds)} "
          f"rounds ({mean_r:.2f} per ray; a thread per ray: the warps' most {warp_max:.2f} on "
          f"average, {used:.3f} of their lane-rounds used; at most {int(rounds.max())}), "
          f"{cands[0]} candidates, hit {float((kern[1] >= 0).float().mean()):.4f}; bit-exact vs "
          f"the chunked round loop -> OK; no host sync in the pass; kernel {ms:.3f} ms (1 "
          f"launch); plain loop {plain_ms:.1f} ms; bound {bnd[0]:.4f} ms by {bnd[1]} "
          f"({n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.3f} Gop; {ms / bnd[0]:.1f}x the bound); "
          f"{scan_text(scans, n_bytes, n_ops)}; {own} ({card})", flush=True)
    return (0.0, (ms, plain_ms), bnd), launches


def cli_run(what, argv, card, want=(), stage=None):
    """``cli.main(argv + ["--profile"])`` on a fresh peak and fresh counters:
    checks its exit code, the counted launches (``want`` must have
    launched) and the shading stage, prints the CLI's own lines and s/frame
    (the frames after the first, which carries the warm-up), Mrays/s, build
    s and peak MiB. Returns (profile dict, launches)."""
    from vk_raytrace_torch import cli
    from vk_raytrace_torch.integrator import pool as wp
    from vk_raytrace_torch.integrator import shade_fused as sf
    from vk_raytrace_torch.ops import traverse_fused as tf

    dev = torch.device("cuda", 0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    tf.reset_launches()
    sf.reset_launches()
    err = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stderr(err):
        rc = cli.main([*argv, "--profile"])
    wall = time.time() - t0
    lau = {k: v for k, v in {**tf.LAUNCHES, **sf.LAUNCHES}.items() if v}
    lines = err.getvalue().splitlines()
    prof = json.loads([ln for ln in lines if ln.startswith('{"profile"')][-1])["profile"]
    for ln in lines:
        if not ln.startswith('{"profile"'):
            print(f"  cli: {ln}")
    assert rc == 0, f"{what}: the CLI returned {rc}"
    assert all(lau.get(k, 0) > 0 for k in want), f"{what}: a kernel never launched: {lau}"
    assert_folded(what, lau)
    if stage is not None:
        assert prof["stage"] == stage, f"{what}: the {prof['stage']} stage ran, not {stage}"
    timed = prof["frame_s"][1:] or prof["frame_s"]
    rays = prof["rays"][1:] or prof["rays"]
    s_frame = float(np.mean(timed))
    mrays = float(np.sum(rays) / np.sum(timed) / 1e6)
    frames = len(prof["frame_s"])
    print(f"{what}: {s_frame:.4f} s/frame (frames 2-{frames}; first {prof['frame_s'][0]:.3f}), "
          f"{mrays:.4f} Mrays/s, rays/frame {prof['rays'][-1]}, {prof['stage']} shading, "
          f"launches/frame {({k: v / frames for k, v in lau.items()})}, build s: "
          + ", ".join(f"{k} {v:.3f}" for k, v in prof["build_s"].items())
          + f"; peak {prof['peak_mib']:.1f} MiB allocated; wall {wall:.1f} s [{card}]", flush=True)
    return prof, lau


def check_picks(what, card_p, cpu_p):
    """The card's picks against the CPU's: the same hits; triangle, material
    and instance equal wherever t is not tied; t within rtol 1e-5. Returns
    (hits, picks differing by a tie)."""
    assert [p is None for p in card_p] == [p is None for p in cpu_p], f"{what}: hits differ"
    ties = 0
    for a, b in zip(card_p, cpu_p):
        if a is None:
            continue
        assert abs(a["t"] - b["t"]) <= RTOL * abs(b["t"]), f"{what}: t {a} vs {b}"
        if (a["triangle"], a.get("instance")) != (b["triangle"], b.get("instance")):
            assert a["t"] == b["t"], f"{what}: differ where t is not tied: {a} vs {b}"
            ties += 1
        else:
            assert a["material"] == b["material"], f"{what}: {a} vs {b}"
    return sum(p is not None for p in card_p), ties


# ---- Phases 31-34: the last modules (sharding, the viewer, the graft entry, JPEG) ----

# Phase 5's configuration: the full atrium at 1080p, depth 4, 1 spp, glTF, sun&sky.
SHARD_CFG = dict(width=1920, height=1080, max_depth=4, max_samples=1, pbr_mode=1,
                 firefly_clamp=10.0, use_sun_sky=True)
SHARD_FRAMES = 3  # timed, after one warm-up
# The pixels a sharded image may differ by from Renderer.step's: none.
# Since the environment's alias table is built on the CPU (C5), the card's
# image is the same from run to run and from process to process (tables
# built in two processes included); every comparison of phase 31 printed 0
# of 2,073,600 pixels and equal rays in two runs on the H100 (PERF.md), so
# a loss of reproducibility fails here.
SHARD_DIFFER_MAX = 0
JPEG_GLB = os.path.join("tests", "assets", "jpeg_textures.glb")
JPEG_2K = os.path.join("tests", "assets", "jpeg_2k_420.jpg")
JPEG_2K_SHA = os.path.join("tests", "assets", "jpeg_2k_420.sha256")


def atrium_renderer(device):
    """The full atrium at :data:`SHARD_CFG` on ``device``."""
    from vk_raytrace_torch import render as R
    from vk_raytrace_torch.models import procedural
    from vk_raytrace_torch.models.schema import RenderConfig

    geom, mats, lights, cam, atlas = procedural.atrium_scene()
    return R.Renderer(R.build_scene(geom, mats, lights, cam, atlas=atlas),
                      RenderConfig(**SHARD_CFG), device=device)


def sharded_run(mesh, r, n=SHARD_FRAMES):
    """Renderer ``r``'s frames through ``sharding.sharded_render_step`` over
    ``mesh``: rank 0's tables replicated, then one warm-up and ``n`` timed
    frames from a zero image with fresh launch counters. Returns the whole
    image, the seconds and rays of every frame, the launches and the peak
    MiB of this rank."""
    from vk_raytrace_torch.integrator import shade_fused as sf
    from vk_raytrace_torch.ops import traverse_fused as tf
    from vk_raytrace_torch.parallel import sharding

    sharding.replicate(mesh, (r.scene, r.packed, r.alpha_pack, r._shade_tables))
    step = sharding.sharded_render_step(
        mesh, r.scene, r.packed, r._run_cfg, alpha_pack=r.alpha_pack, features=r.features,
        fused_shade=r.fused_shade, shade_tables=r._shade_tables)
    rows = sharding.shard_accum(mesh, torch.zeros(r.cfg.height, r.cfg.width, 3, device=r.device))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(r.device)
    tf.reset_launches()
    sf.reset_launches()
    frame_s, rays = [], []
    for f in range(n + 1):
        t0 = time.perf_counter()
        rows, k = step(rows, f)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
        rays.append(k)
    launches = {k: v for k, v in {**tf.LAUNCHES, **sf.LAUNCHES}.items() if v}
    img = sharding.gather_accum(mesh, rows).cpu().numpy()
    return dict(img=img, frame_s=frame_s, rays=rays, launches=launches,
                peak_mib=torch.cuda.max_memory_allocated(r.device) / 2**20)


def sharded_card_rank(rank, world_size, out_dir, cases):
    """A rank of phase 31's gloo launch on the card (both ranks on cuda:0):
    each case ``(name, tile, sample)`` through :func:`sharded_run`; each rank
    writes ``<name>_rank<r>.json`` (and rank 0 ``<name>.npy``, the image).
    Then rank 0 renders the same frames with ``Renderer.step`` on its own
    tables (``single_rank0.json`` / ``.npy``): the sharded frames against
    the one-device frames of the same process."""
    from vk_raytrace_torch.parallel import sharding

    r = atrium_renderer("cuda:0")
    for name, tile, sample in cases:
        mesh = sharding.make_mesh("cuda", tile=tile, sample=sample, backend="gloo",
                                  device="cuda:0")
        res = sharded_run(mesh, r)
        img = res.pop("img")
        if rank == 0:
            np.save(os.path.join(out_dir, f"{name}.npy"), img)
        with open(os.path.join(out_dir, f"{name}_rank{rank}.json"), "w") as f:
            json.dump(res, f)
    if rank == 0:
        r.reset()
        _, frame_s, rays = run_frames(r, SHARD_FRAMES)
        np.save(os.path.join(out_dir, "single_rank0.npy"), r.accum.cpu().numpy())
        with open(os.path.join(out_dir, "single_rank0.json"), "w") as f:
            json.dump({"frame_s": frame_s, "rays": rays}, f)


def frames_text(frame_s, rays):
    """s/frame and Mrays/s of the timed frames (after the warm-up)."""
    timed, timed_rays = frame_s[1:], rays[1:]
    return (f"{float(np.mean(timed)):.4f} s/frame (frames {['%.4f' % x for x in timed]}, warm-up "
            f"{frame_s[0]:.3f}), {np.sum(timed_rays) / np.sum(timed) / 1e6:.4f} Mrays/s")


def hold(what, img, ref, rays=None, ref_rays=None):
    """``img`` against ``ref`` under the slice's criterion (and the rays
    within :data:`RAY_REL`); prints the pixels that differ at all."""
    differ = int((img != ref).any(-1).sum())
    share = float(np.isclose(img, ref, rtol=PIX_RTOL, atol=PIX_ATOL).all(-1).mean())
    text = (f"{what}: {differ} of {img.shape[0] * img.shape[1]} pixels differ, within rtol "
            f"{PIX_RTOL}/atol {PIX_ATOL}: {share:.5f}")
    if rays is not None:
        text += f"; rays {rays} vs {ref_rays} ({'equal' if rays == ref_rays else 'NOT equal'})"
    print(text, flush=True)
    assert np.isfinite(img).all() and img.mean() > 0.0, f"{what}: unlit or non-finite"
    assert share >= PIX_SHARE, f"{what}: only {share:.4f} of pixels agree"
    if rays is not None:
        rel = abs(sum(rays) - sum(ref_rays)) / sum(ref_rays)
        assert rel <= RAY_REL, f"{what}: rays differ by {rel:.2e}"
    return differ, share


def hold_equal(what, img, ref, rays, ref_rays):
    """Phase 31's comparison: :func:`hold`, then the rays equal and at most
    :data:`SHARD_DIFFER_MAX` pixels differing."""
    differ, _ = hold(what, img, ref, rays, ref_rays)
    assert rays == ref_rays, f"{what}: rays {rays} vs {ref_rays}"
    assert differ <= SHARD_DIFFER_MAX, f"{what}: {differ} pixels differ"


def phase_sharding(card, work):
    """Phase 31. Returns the launches of each sharded run (rank 0)."""
    import torch.distributed as dist

    from vk_raytrace_torch.parallel import sharding

    dev = torch.device("cuda", 0)
    r = atrium_renderer(dev)
    # NCCL at world size 1 in this process: the real NCCL path (NCCL refuses
    # two ranks on one card). Sharded and one-device frames alternate, both
    # while the process group lives: sharded, single, sharded, single.
    backend = sharding.init_process_group("cuda", 0, 1, f"tcp://127.0.0.1:{sharding.free_port()}")
    assert backend == "nccl", backend
    runs = []
    try:
        mesh = sharding.make_mesh("cuda")
        for _ in range(2):
            res = sharded_run(mesh, r)
            r.reset()
            _, single_s, single_rays = run_frames(r, SHARD_FRAMES)
            runs.append((res, single_s, single_rays))
    finally:
        dist.destroy_process_group()
    single = r.accum.cpu().numpy()
    for k, (res, single_s, single_rays) in enumerate(runs):
        print(f"sharded NCCL world 1 (tile 1 x sample 1), atrium 1920x1080 d4, pair {k + 1} of 2: "
              f"{frames_text(res['frame_s'], res['rays'])}, launches/frame "
              f"{({m: v / (SHARD_FRAMES + 1) for m, v in res['launches'].items()})}, peak "
              f"{res['peak_mib']:.1f} MiB; then Renderer.step {float(np.mean(single_s)):.4f} "
              f"s/frame (frames {['%.4f' % x for x in single_s]}) [{card}]", flush=True)
        assert all(res["launches"].get(m, 0) > 0 for m in ATRIUM_KERNELS), res["launches"]
        assert_folded("sharded NCCL", res["launches"])
        hold_equal(f"sharded NCCL against Renderer.step (4 frames), pair {k + 1}", res["img"],
                   single, res["rays"][1:], single_rays)
    launches = {"sharded_nccl": res["launches"]}
    # Two gloo ranks on the same card, asked for by name: tile 2 x 1, then 1 x 2.
    d = os.path.join(work, "sharded")
    os.makedirs(d, exist_ok=True)
    t0 = time.time()
    sharding.spawn_ranks(sharded_card_rank, 2, (d, (("t2", 2, 1), ("s2", 1, 2))),
                         timeout_s=600, device_type="cuda", backend="gloo")
    spawn_s = time.time() - t0
    for name, what in (("t2", "tile 2 x sample 1"), ("s2", "tile 1 x sample 2")):
        ranks = []
        for k in range(2):
            with open(os.path.join(d, f"{name}_rank{k}.json")) as f:
                ranks.append(json.load(f))
        img = np.load(os.path.join(d, f"{name}.npy"))
        for k, rr in enumerate(ranks):
            assert all(rr["launches"].get(m, 0) > 0 for m in ATRIUM_KERNELS), (name, k, rr)
            assert_folded(f"sharded gloo {name}, rank {k}", rr["launches"])
            print(f"sharded gloo {what}, rank {k} on cuda:0: "
                  f"{frames_text(rr['frame_s'], rr['rays'])}, launches/frame "
                  f"{({m: v / (SHARD_FRAMES + 1) for m, v in rr['launches'].items()})}, peak "
                  f"{rr['peak_mib']:.1f} MiB [{card}]", flush=True)
        if name == "t2":
            t2_rays = ranks[0]["rays"][1:]
            hold_equal(f"sharded gloo {what} against Renderer.step (4 frames)", img, single,
                       t2_rays, single_rays)
        else:
            rel = abs(img.mean() - single.mean()) / single.mean()
            print(f"sharded gloo {what}: image mean {img.mean():.5f} against the single render's "
                  f"{single.mean():.5f} (rel {rel:.4f}); rays/frame {ranks[0]['rays']} (both "
                  f"sample shards)", flush=True)
            assert np.isfinite(img).all() and rel < 0.1, rel
        launches[f"sharded_gloo_{name}"] = ranks[0]["launches"]
    with open(os.path.join(d, "single_rank0.json")) as f:
        own = json.load(f)
    hold_equal("sharded gloo tile 2 x sample 1 against Renderer.step in rank 0 (its own tables)",
               np.load(os.path.join(d, "t2.npy")), np.load(os.path.join(d, "single_rank0.npy")),
               t2_rays, own["rays"])
    hold_equal("Renderer.step in rank 0 against Renderer.step here (tables built in two "
               "processes)", np.load(os.path.join(d, "single_rank0.npy")), single, own["rays"],
               single_rays)
    print(f"sharded gloo: 2 ranks spawned, built, ran and joined in {spawn_s:.1f} s", flush=True)
    return launches


def phase_viewer(card):
    """Phase 32: the viewer at the reference CLI's defaults on the card,
    driven over HTTP on localhost. Returns its launches."""
    import urllib.request

    from vk_raytrace_torch import render as R
    from vk_raytrace_torch import viewer as V
    from vk_raytrace_torch.integrator import shade_fused as sf
    from vk_raytrace_torch.ops import traverse_fused as tf
    from vk_raytrace_torch.utils import png as png_mod

    import threading

    tf.reset_launches()
    sf.reset_launches()
    svc = V.ViewerService(V.build_parser().parse_args(
        ["--scene", "atrium", "--sun-sky", "--size", "1280", "720", "--depth", "10"]))
    t = threading.Thread(target=svc.run_render_loop, daemon=True)
    t.start()
    httpd = V.serve(svc, "127.0.0.1", 0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=120) as resp:
            return resp.read()

    def state():
        return json.loads(get("/state"))

    def wait(pred, timeout=300.0):
        t0 = time.time()
        while time.time() - t0 < timeout:
            st = state()
            if pred(st):
                return st
            assert t.is_alive(), "the viewer's render loop died"
            time.sleep(0.05)
        raise AssertionError(f"viewer: timeout, last state {st}")

    try:
        t0 = time.time()
        st = wait(lambda s: s.get("frame", 0) >= 3)
        first_s = time.time() - t0
        vw, vh = svc.args.size
        px = png_mod.decode_rgba(get("/frame.png"))
        assert px.shape == (vh, vw, 4) and px[..., :3].mean() > 5.0, "viewer: unlit frame"
        f0 = st["frame"]
        wait(lambda s: s["frame"] > f0)
        req = urllib.request.Request(base + "/control", method="POST",
                                     data=json.dumps({"cmd": "orbit", "dx": 40.0, "dy": 10.0}).encode())
        urllib.request.urlopen(req, timeout=60).close()
        st1 = wait(lambda s: s["descale_frames"] > st["descale_frames"] and s["resets"] > st["resets"])
        st2 = wait(lambda s: not s["descaled"] and s["frame"] >= 2)
        lau = {k: v for k, v in {**tf.LAUNCHES, **sf.LAUNCHES}.items() if v}  # before the picks
        # /pick at 16 pixels against Renderer.pick on the camera the service
        # used (each pick moves the pivot, so the camera is read before each).
        ref = R.Renderer(svc._scene0, svc._renderer.cfg, device=svc.device,
                         packed=svc._renderer.packed)
        prng = np.random.default_rng(32)
        hits = 0
        for x, y in zip(prng.integers(0, vw, 16), prng.integers(0, vh, 16)):
            resets = state()["resets"]
            cam = svc._renderer.scene.camera
            got = json.loads(get(f"/pick?x={x}&y={y}"))
            ref.scene = dataclasses.replace(ref.scene, camera=cam)
            want = ref.pick(int(x), int(y))
            assert (got is None) == (want is None), (x, y, got, want)
            if got is not None:
                hits += 1
                assert (got["triangle"], got["material"], got["t"]) == (
                    want["triangle"], want["material"], want["t"]), (x, y, got, want)
                np.testing.assert_array_equal(np.asarray(got["position"], np.float32),
                                              want["position"])
                wait(lambda s: s["resets"] > resets)  # the pick's pivot applied
        assert hits >= 8, hits
        st3 = state()
        assert all(lau.get(k, 0) > 0 for k in ATRIUM_KERNELS), lau
        assert_folded("viewer", lau)
        ms, mrays, mem = (st3["hist"][k] for k in ("ms", "mrays", "mem"))
        print(f"viewer atrium {vw}x{vh} d10 (Disney, sun&sky) on the card over HTTP: first 3 "
              f"frames in {first_s:.1f} s; the orbit gave {st1['descale_frames'] - st['descale_frames']}"
              f"+ descaled frames and a reset, then full-resolution frame {st2['frame']}; /pick "
              f"at 16 pixels = Renderer.pick ({hits} hits); ms/frame ring "
              f"(last {len(ms)}) mean {np.mean(ms):.1f}, min {min(ms):.1f}, max {max(ms):.1f}; "
              f"Mrays/s ring mean {np.mean(mrays):.3f}; dev mem ring last {mem[-1] if mem else -1} "
              f"MiB; launches before the picks {lau} [{card}]", flush=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=30)
        svc._stop = True
        t.join(timeout=120)
    assert not t.is_alive(), "viewer: the render loop did not stop"
    return lau


def phase_graft_entry(card):
    """Phase 33: ``graft_entry.entry()`` on the card against the CPU."""
    from vk_raytrace_torch import graft_entry
    from vk_raytrace_torch.ops import traverse_fused as tf

    fn, (accum, frame) = graft_entry.entry()
    tf.reset_launches()
    t0 = time.perf_counter()
    out = fn(accum, frame)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    lau = {k: v for k, v in tf.LAUNCHES.items() if v}
    cfn, (caccum, cframe) = graft_entry.entry("cpu")
    cpu = cfn(caccum, cframe).numpy()
    img = out.cpu().numpy()
    print(f"graft_entry.entry(): Cornell 64x64 d2 frame on the card in {ms:.1f} ms, launches "
          f"{lau} [{card}]", flush=True)
    assert img.shape == (64, 64, 3) and all(lau.get(k, 0) > 0 for k in ("closest", "any")), lau
    hold("graft_entry.entry() card against CPU", img, cpu)
    return lau


def glb_images(path):
    """The encoded images of a GLB's buffer views, in image order."""
    import struct

    with open(path, "rb") as f:
        glb = f.read()
    (js_len,) = struct.unpack_from("<I", glb, 12)
    doc = json.loads(glb[20:20 + js_len])
    blob = glb[20 + js_len + 8:]
    views = [doc["bufferViews"][im["bufferView"]] for im in doc["images"]]
    return [blob[v.get("byteOffset", 0):v.get("byteOffset", 0) + v["byteLength"]] for v in views]


def phase_jpeg(card):
    """Phase 34: the committed JPEG textures decoded without Pillow, equal to
    the Pillow RGBA stored beside them; the glTF at 128x72 card vs CPU."""
    import importlib.util

    from vk_raytrace_torch import render as R
    from vk_raytrace_torch.models.gltf import load_gltf
    from vk_raytrace_torch.models.schema import PBR_GLTF, RenderConfig
    from vk_raytrace_torch.ops import traverse_fused as tf
    from vk_raytrace_torch.utils import png as png_mod

    glb = os.path.join(REPO, JPEG_GLB)
    for k, data in enumerate(glb_images(glb)):
        t0 = time.perf_counter()
        px = png_mod.decode_image(data, f"image {k} of {JPEG_GLB}")
        dec_ms = (time.perf_counter() - t0) * 1e3
        want = np.load(os.path.join(REPO, "tests", "assets", f"jpeg_texture_{k}.npy"))
        assert px.shape == want.shape and np.array_equal(px, want), f"JPEG texture {k} differs"
        print(f"JPEG texture {k}: {px.shape[1]}x{px.shape[0]}, {len(data)} bytes, decoded in "
              f"{dec_ms:.2f} ms, equal to Pillow's RGBA", flush=True)
    # A texture at the size a scene loads, held against the SHA-256 of
    # Pillow's RGBA of it (tests/assets/jpeg_2k_420.sha256).
    import hashlib

    with open(os.path.join(REPO, JPEG_2K), "rb") as f:
        data = f.read()
    with open(os.path.join(REPO, JPEG_2K_SHA)) as f:
        digest, shape = f.read().split()
    big_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        px = png_mod.decode_image(data, JPEG_2K)
        big_ms.append((time.perf_counter() - t0) * 1e3)
        assert "x".join(map(str, px.shape)) == shape, (px.shape, shape)
        assert hashlib.sha256(np.ascontiguousarray(px).tobytes()).hexdigest() == digest, (
            f"{JPEG_2K} differs from Pillow's RGBA")
    print(f"JPEG {JPEG_2K}: {px.shape[1]}x{px.shape[0]} 4:2:0, {len(data)} bytes, decoded in "
          f"{['%.2f' % x for x in big_ms]} ms (3 decodes, host), SHA-256 equal to Pillow's "
          f"RGBA [{card}]", flush=True)
    assert "PIL" not in sys.modules, "the JPEG path imported Pillow"
    print(f"Pillow on this machine: {'installed' if importlib.util.find_spec('PIL') else 'absent'}"
          "; not imported", flush=True)
    g, m, l, c, a = load_gltf(glb, instancing="bake")
    cfg = RenderConfig(width=128, height=72, max_depth=4, max_samples=1, pbr_mode=PBR_GLTF,
                       firefly_clamp=10.0, use_sun_sky=True)
    scene, run_cfg = R.prepare_sun_sky(R.build_scene(g, m, l, c, atlas=a), cfg, "cpu")
    imgs, rays = {}, {}
    for where in ("cuda", "cpu"):
        tf.reset_launches()
        r = R.Renderer(scene, run_cfg, device=where)
        rays[where] = []
        for _ in range(2):
            r.step()
            rays[where].append(r.last_rays)
        imgs[where] = r.accum.cpu().numpy()
        if where == "cuda":
            lau = {k: v for k, v in tf.LAUNCHES.items() if v}
    print(f"jpeg_textures.glb 128x72 d4 (glTF, sun&sky): card launches {lau} [{card}]", flush=True)
    assert all(lau.get(k, 0) > 0 for k in ("closest", "any")), lau
    hold("jpeg_textures.glb card against CPU", imgs["cuda"], imgs["cpu"], rays["cuda"],
         rays["cpu"])
    return lau


def last_modules(card, work):
    """Phases 31-34; the launches of each new path (counters set to 0 just
    before it, read just after)."""
    phase("31. sharding on the card: NCCL at world size 1, 2 gloo ranks on cuda:0")
    launches = phase_sharding(card, work)
    phase("32. the viewer on the card over HTTP")
    launches["viewer"] = phase_viewer(card)
    phase("33. graft_entry.entry() on the card")
    launches["graft_entry"] = phase_graft_entry(card)
    phase("34. JPEG textures without Pillow")
    launches["jpeg_gltf"] = phase_jpeg(card)
    return launches


# ---- Phases 35-38: the wide back end (renderer="wide") ----------------------

WIDE_SOURCE = "vk_raytrace_torch/csrc/traverse_wide.cu"
# The reference's wide traversal: an XLA body (the RayQuery analog), not a
# pallas_call; and the XLA while-loops of its two-level rounds around it.
WIDE_REPLACES = "vk_raytrace_tpu/ops/traverse_wide.py:114"
WIDE_REPLACES_KIND = "XLA body (_traverse_wide), not a pallas_call"
WIDE_MACHINE_REPLACES = "vk_raytrace_tpu/ops/tlas.py:432"
WIDE_MACHINE_REPLACES_KIND = ("XLA body (_two_level_pass around _traverse_wide), not a "
                              "pallas_call")
# Its bytes per ray: origin, direction, t_max (28 B) in, an active byte and
# an 8-byte seed where given, and t, tri, u, v, steps and the seed (28 B)
# out; each distinct 256-byte row once in 32-byte sectors
# (travbench.wide_row_bytes); per alpha test its AlphaPack row and a texel
# sector (MACHINE_CAND_BYTES) and about MACHINE_CAND_OPS operations.
WIDE_RAY_IN, WIDE_RAY_OUT = 28, 28
# The main path's sizes: 2^18 rays (the pool width), 1080p frames; the
# viewer's atrium at a size whose frames keep the phase short.
WIDE_RAYS, WIDE_W, WIDE_H = 1 << 18, 1920, 1080
WIDE_VIEWER = ["--scene", "atrium", "--sun-sky", "--size", "640", "360", "--depth", "4"]
# The first design of vkrt_traverse_wide (a thread per ray, a 64-entry stack
# in local memory) on phase 35's rays: ms per case as this script measured
# it then (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6), and its ptxas
# report.
WIDE_FIRST_MS = {"closest": 0.2270, "any": 0.1618, "alpha_closest": 0.0568,
                 "alpha_any": 0.1053, "alpha_closest_banners": 0.1556,
                 "alpha_any_banners": 0.0704}
WIDE_FIRST_PTXAS = "56-72 registers, 320-352 B stack frame, no spill"


def resident_blocks(slots):
    """Blocks of 128 threads an SM holds, from a persistent grid's slots."""
    return slots / (128 * torch.cuda.get_device_properties(0).multi_processor_count)


def wide_case(name, key, wide, pack, o, d, t_max, seed, active, any_hit, card, root0=None):
    """``vkrt_traverse_wide`` against its plain version on these rays (with
    ``root0``: from each ray's own interior row), every output (t, tri, u,
    v, steps, seed) bit for bit; both timed, and the call's bound counted
    from the rows the plain version visits and the alpha tests it draws;
    printed beside the first design's time (:data:`WIDE_FIRST_MS` under
    ``key``, where it was measured). Returns (max |err|, (ms, plain_ms),
    (bound_ms, bound_by), registers)."""
    from vk_raytrace_torch import cuda_build
    from vk_raytrace_torch import travbench as tb
    from vk_raytrace_torch.ops import traverse_wide as tw

    n = o.shape[0]
    seen = torch.zeros(wide.rows.shape[0], dtype=torch.int8, device=o.device)
    draws = torch.zeros(n, dtype=torch.int64, device=o.device)
    plain = tw._traverse_wide_plain(wide, pack, o, d, t_max, seed, active, any_hit, root0=root0,
                                    seen=seen, draws=draws)
    kern = tw.traverse_wide(wide, pack, o, d, t_max, seed, active, any_hit, root0=root0)
    torch.cuda.synchronize()
    for what, a, b in zip(("t", "tri", "u", "v", "steps", "seed"), kern, plain):
        same = torch.equal(a.view(torch.int32), b.view(torch.int32)) if a.is_floating_point() \
            else torch.equal(a, b)
        assert same, f"wide {name}: {what} differs from the plain version"
    deepest = tw.stack_reached(o.device)
    slots = tw._GRID.slots[(o.device, (0, int(any_hit), int(pack is not None), 0))]
    hit_share = float((kern[1] >= 0).float().mean())
    steps = float(kern[4].double().mean())
    n_draws = int(draws.sum())
    ms = tb.cuda_time(
        lambda: tw.traverse_wide(wide, pack, o, d, t_max, seed, active, any_hit, root0=root0), 20)
    plain_ms = tb.cuda_time(
        lambda: tw._traverse_wide_plain(wide, pack, o, d, t_max, seed, active, any_hit,
                                        root0=root0), 2)
    ray_b = (WIDE_RAY_IN + (1 if active is not None else 0) + (8 if seed is not None else 0)
             + (4 if root0 is not None else 0) + WIDE_RAY_OUT)
    n_bytes, n_inner, n_leaf = tb.traversal_bytes(n, ray_b, seen, 8, "closest")
    n_bytes += n_draws * MACHINE_CAND_BYTES
    n_ops = float(kern[4].double().sum()) * tb.ops_per_node(8) + n_draws * MACHINE_CAND_OPS
    bnd = tb.bound(n_bytes, n_ops)
    res = cuda_build.resources("traverse_wide",
                               f"wide_kernelILb{int(any_hit)}ELb{int(pack is not None)}E")
    first = (f"the first design {WIDE_FIRST_MS[key]:.4f} ms" if key in WIDE_FIRST_MS
             else "the first design not timed on these rays")
    print(f"wide {name}: {n} rays, hit share {hit_share:.4f}, mean nodes/ray {steps:.2f}, alpha "
          f"tests {n_draws} ({n_draws / n:.3f}/ray), deepest stack {deepest} of "
          f"{wide.stack_depth}, bit for bit (t, tri, u, v, steps, seed) -> OK; kernel {ms:.4f} "
          f"ms ({first}, {WIDE_FIRST_PTXAS}), plain "
          f"{plain_ms:.2f} ms, bound {bnd[0]:.4f} ms by {bnd[1]} ({n_bytes / 1e6:.1f} MB with "
          f"{n_inner} interior + {n_leaf} leaf rows of {wide.rows.shape[0]} visited, "
          f"{n_ops / 1e9:.3f} Gop; {ms / bnd[0]:.1f}x the bound); {res['registers']} registers, "
          f"{res['stack_frame']} B stack frame, {res['spill_stores'] + res['spill_loads']} B "
          f"spill, {res['smem']} B static shared, {resident_blocks(slots):.0f} blocks of 128 an "
          f"SM ({card})", flush=True)
    return 0.0, (ms, plain_ms), bnd, res["registers"]


def wide_machine_case(name, acc, part, pack, o, d, t_max, seed, act, any_hit, card):
    """``vkrt_wide_machine`` (one launch, no host sync: torch's sync debug
    mode raises around a warm call) against its plain version, the round
    loop ``tlas._wide_rounds``, on the same CUDA tensors: every output
    (t_best, tri, u, v, inst, seed, steps) bit for bit. The machine
    timed (CUDA events), the plain loop once on the host clock; the bound
    counts the rays once, the instance table once, each distinct BLAS row
    once, the rounds' nodes and transforms and the alpha tests; the instance
    scans (:func:`scan_work`) printed beside it. Returns ((max |err|, (ms,
    plain_ms), bound), the machine's outputs, rounds per ray)."""
    from vk_raytrace_torch import cuda_build
    from vk_raytrace_torch import travbench as tb
    from vk_raytrace_torch.ops import tlas
    from vk_raytrace_torch.ops import traverse_fused as tf
    from vk_raytrace_torch.ops import traverse_wide as tw

    args = (acc, pack, o, d, t_max, seed, act, part, any_hit)
    before = tf.LAUNCHES["wide_machine"]
    kern = tlas._wide_pass(*args)
    torch.cuda.synchronize()
    assert tf.LAUNCHES["wide_machine"] == before + 1, f"{name}: not one machine launch"
    deepest = tw.stack_reached(o.device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        tlas._wide_pass(*args)  # raises on a host sync inside the pass
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n = o.shape[0]
    rounds = torch.zeros(n, dtype=torch.int64, device=o.device)
    seen = torch.zeros(acc.blas.rows.shape[0], dtype=torch.int8, device=o.device)
    n_draws = torch.zeros(n, dtype=torch.int64, device=o.device)
    t0 = time.perf_counter()
    plain = tlas._wide_rounds(*args, rounds=rounds, seen=seen, draws=n_draws)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    for k, (a, b) in enumerate(zip(kern, plain)):
        a = a.to(b.dtype)
        same = (torch.equal(a.view(torch.int32), b.view(torch.int32))
                if b.dtype == torch.float32 else torch.equal(a, b))
        assert same, f"{name}: output {k} not bit-exact with the plain round loop"
    draws = int(n_draws.sum())
    ms = tb.cuda_time(lambda: tlas._wide_pass(*args), 5)
    n_inst = acc.inst.aabb_min.shape[0]
    mask = tlas._wide_mask(acc, part)
    n_in = int(mask.sum()) if mask is not None else n_inst
    n_rounds = float(rounds.double().sum())
    nodes = float(plain[6].double().sum()) - n_rounds
    rows_b, _, _ = tb.traversal_bytes(0, 0, seen, 8, "closest")
    n_bytes = n * MACHINE_RAY_BYTES + n_inst * MACHINE_INST_BYTES + rows_b + (
        draws * MACHINE_CAND_BYTES)
    n_ops = (nodes * tb.ops_per_node(8) + n_rounds * OPAQUE_ROUND_OPS
             + draws * MACHINE_CAND_OPS)
    bnd = tb.bound(n_bytes, n_ops)
    scans = scan_work(n, n_rounds, mask, n_inst)
    mean_r, warp_max, used = warp_rounds(rounds)
    table = "global" if n_inst > tlas._DENSE_I_MAX else "shared"
    res = cuda_build.resources(
        "traverse_wide", f"wide_machine_kernelILb{int(any_hit)}ELb{int(pack is not None)}ELb"
                         f"{int(table == 'global')}E")
    slots = tw._GRID.slots[(o.device, (1, int(any_hit), int(pack is not None), n_inst))]
    print(f"{name}: {n} rays, {n_inst} instances ({n_in} in the pass, table in {table} memory), "
          f"{int(n_rounds)} rounds ({mean_r:.2f} per ray, the warps' most {warp_max:.2f} on "
          f"average, {used:.3f} of the warps' lane-rounds used, at most {int(rounds.max())}), "
          f"{draws} alpha tests, hit {float((kern[1] >= 0).float().mean()):.4f}, deepest "
          f"stack {deepest}; bit-exact vs the plain round loop -> OK; no host sync in the pass; kernel {ms:.3f} ms (1 launch); plain loop "
          f"{plain_ms:.1f} ms; bound {bnd[0]:.4f} ms by {bnd[1]} ({n_bytes / 1e6:.1f} MB, "
          f"{n_ops / 1e9:.3f} Gop; {ms / bnd[0]:.1f}x the bound); {scan_text(scans, n_bytes, n_ops)}"
          f"; {res['registers']} registers, {res['stack_frame']} B stack frame, "
          f"{res['spill_stores'] + res['spill_loads']} B spill, {resident_blocks(slots):.0f} "
          f"blocks of 128 an SM ({card})", flush=True)
    return (0.0, (ms, plain_ms), bnd), kern, rounds


def wide_interior_rows(wide, levels):
    """The interior rows of an 8-wide tree at most ``levels`` levels below
    its root (the root included): valid children with a ref >= 0."""
    rows = wide.rows.cpu().numpy()
    found, front = [0], [0]
    for _ in range(levels):
        nxt = []
        for r in front:
            box = rows[r, :48].reshape(8, 6)
            nxt += [int(c) for c, ok in zip(rows[r, 48:56], box[:, 0] <= box[:, 3])
                    if ok and c >= 0]
        found += nxt
        front = nxt
    return np.asarray(found)


def phase_wide_kernel(card, geom, scene, cam, gbundle, rng):
    """Phase 35: the kernel against its plain version on the 1080p atrium's
    2^18 camera rays and their shadow rays toward the sun: closest and any
    hit over the opaque tree, and the alpha passes with their seeds; the
    fused back end's kernels timed on the same rays."""
    from vk_raytrace_torch import travbench as tb
    from vk_raytrace_torch.integrator.camera import with_aspect
    from vk_raytrace_torch.ops import bvh8
    from vk_raytrace_torch.ops import traverse_alpha as ta
    from vk_raytrace_torch.ops import traverse_fused as tf
    from vk_raytrace_torch.ops import traverse_wide as tw

    dev = torch.device("cuda", 0)
    t0 = time.time()
    opq, alp = (w.to(dev) for w in bvh8.build_wide(geom))
    print(f"atrium 8-wide trees: opaque {opq.rows.shape[0]} rows (stack {opq.stack_depth}), "
          f"alpha {alp.rows.shape[0]} rows (stack {alp.stack_depth}); built in "
          f"{time.time() - t0:.2f} s", flush=True)
    n = WIDE_RAYS
    o, d = camera_rays(with_aspect(cam, WIDE_W, WIDE_H).to(dev), WIDE_W, WIDE_H, n, rng, dev)
    inf = torch.full((n,), tf.INF, device=dev)
    sc = scene.to(dev)
    pack = tw.make_alpha_pack(sc.materials, sc.atlas, sc.geometry.tri_material)
    seed = torch.tensor(rng.integers(0, 2**32, n), device=dev)
    res = {"closest": wide_case("closest, opaque tree (camera rays)", "closest", opq, None, o,
                                d, inf, None, None, False, card)}
    # Per-lane roots (the entry's other route): the same rays, each from an
    # interior row at most two levels below the root (drawn from a generator
    # of their own, so that the other cases keep their rays).
    starts = wide_interior_rows(opq, 2)
    pick = np.random.default_rng(35).integers(0, len(starts), n)
    root0 = torch.tensor(starts[pick], dtype=torch.int32, device=dev)
    res["roots"] = wide_case(f"closest from per-lane roots ({len(starts)} interior rows), "
                             "opaque tree (camera rays)", "roots", opq, None, o, d, inf, None,
                             None, False, card, root0=root0)
    hit_o, _ = tw.closest_hit_wide(opq, None, o, d)
    hit = hit_o.tri >= 0
    sun = torch.as_tensor(np.asarray(scene.sun_sky.sun_direction, np.float32), device=dev)
    sun = sun / torch.linalg.vector_norm(sun)
    so = (o + d * torch.where(hit, hit_o.t, 0.0)[:, None] + sun * 1e-3).contiguous()
    sd = sun.expand(n, 3).contiguous()
    t_sh = torch.full((n,), 1e4, device=dev)
    res["any"] = wide_case("any, opaque tree (shadow rays of the hits toward the sun)", "any",
                           opq, None, so, sd, t_sh, None, hit, True, card)
    res["alpha_closest"] = wide_case(
        "closest, alpha tree windowed by the opaque t, test inline", "alpha_closest", alp, pack,
        o, d, hit_o.t.contiguous(), seed, None, False, card)
    occ, _ = tw.any_hit_wide(opq, None, so, sd, t_sh, None, hit)
    res["alpha_any"] = wide_case("any, alpha tree (shadow rays the opaque tree left open)",
                                 "alpha_any", alp, pack, so, sd, t_sh, seed, hit & ~occ, True,
                                 card)
    # Rays toward the banners (phase 18's kind), where most meet a candidate.
    oa, da = rays_at(rng, geom, np.where(np.asarray(geom.tri_flags) & 2)[0], n, dev)
    t_ba = tw.closest_hit_wide(opq, None, oa, da)[0].t.contiguous()
    t_bs = torch.tensor(rng.uniform(0.5, 20.0, n), dtype=torch.float32, device=dev)
    open_b = ~tw.any_hit_wide(opq, None, oa, da, t_bs)[0]
    res["alpha_closest_banners"] = wide_case(
        "closest, alpha tree, rays toward the banners", "alpha_closest_banners", alp, pack, oa,
        da, t_ba, seed, None, False, card)
    res["alpha_any_banners"] = wide_case(
        "any, alpha tree, rays toward the banners", "alpha_any_banners", alp, pack, oa, da, t_bs,
        seed, open_b, True, card)
    # The fused back end's kernels on the same rays, in the same call.
    f_t = tf.closest_hit_fused(gbundle.opaque_planar, o, d).t
    f_ba = tf.closest_hit_fused(gbundle.opaque_planar, oa, da).t
    fused = {
        "closest": lambda: tf.closest_hit_fused(gbundle.opaque_planar, o, d),
        "any": lambda: tf.any_hit_fused(gbundle.opaque_planar, so, sd, t_sh, active=hit),
        "alpha_closest": lambda: ta.closest_hit_alpha(gbundle.alpha_planar, pack, o, d, f_t,
                                                      seed=seed),
        "alpha_any": lambda: ta.any_hit_alpha(gbundle.alpha_planar, pack, so, sd, t_sh,
                                              seed=seed, active=hit & ~occ),
        "alpha_closest_banners": lambda: ta.closest_hit_alpha(gbundle.alpha_planar, pack, oa, da,
                                                              f_ba, seed=seed),
        "alpha_any_banners": lambda: ta.any_hit_alpha(gbundle.alpha_planar, pack, oa, da, t_bs,
                                                      seed=seed, active=open_b),
    }
    fused_ms = {k: tb.cuda_time(fn, 20) for k, fn in fused.items()}
    print("the same rays through the fused back end's kernels (mode a, mode b, the alpha rounds "
          "kernel): " + ", ".join(f"{k} {v:.4f} ms (wide {res[k][1][0]:.4f} ms)"
                                        for k, v in fused_ms.items()) + f" [{card}]", flush=True)
    return res, fused_ms


def compare_frames(what, a, b, card):
    """Two renderers' accumulated frames (the same frames of one scene):
    their last frame's rays within RAY_REL; the pixels that differ (outside
    rtol PIX_RTOL / atol PIX_ATOL) printed."""
    ia, ib = a.hdr().cpu().numpy(), b.hdr().cpu().numpy()
    close = np.isclose(ia, ib, rtol=PIX_RTOL, atol=PIX_ATOL).all(-1)
    ray_rel = abs(a.last_rays - b.last_rays) / b.last_rays
    print(f"{what}: rays {a.last_rays} vs {b.last_rays} (rel {ray_rel:.2e}); pixels within "
          f"rtol {PIX_RTOL}/atol {PIX_ATOL}: {close.mean():.5f} ({int((~close).sum())} of "
          f"{close.size} differ); mean radiance {ia.mean():.5f} vs {ib.mean():.5f} [{card}]",
          flush=True)
    assert np.isfinite(ia).all() and ia.mean() > 0.0, f"{what}: black or non-finite"
    assert ray_rel <= RAY_REL, f"{what}: ray counts differ by {ray_rel:.2e}"
    return ray_rel, int((~close).sum())


def phase_wide_frames(card, scene):
    """Phase 36: the 1080p atrium with renderer="wide" against "fused" in
    one process. Returns the wide run's launches and per-frame numbers."""
    from vk_raytrace_torch import render as R
    from vk_raytrace_torch.models.schema import PBR_GLTF, RenderConfig
    from vk_raytrace_torch.ops import traverse_fused as tf

    dev = torch.device("cuda", 0)
    cfg = RenderConfig(width=WIDE_W, height=WIDE_H, max_depth=4, max_samples=1, pbr_mode=PBR_GLTF,
                       firefly_clamp=10.0, use_sun_sky=True)
    rw, w_s, w_mrays, w_frame, w_peak = render_phase(
        "atrium 1080p d4 1spp, renderer=wide", lambda: R.Renderer(scene, cfg, device=dev,
                                                                  renderer="wide"),
        card, want=("traverse_wide", *WAVEFRONT_KERNELS))
    w_launches = dict(tf.LAUNCHES)
    assert not any(w_frame.get(k) for k in ATRIUM_KERNELS), f"wide: a fused kernel ran: {w_frame}"
    rf, f_s, f_mrays, f_frame, f_peak = render_phase(
        "atrium 1080p d4 1spp, renderer=fused", lambda: R.Renderer(scene, cfg, device=dev),
        card, want=(*ATRIUM_KERNELS, *WAVEFRONT_KERNELS))
    assert not f_frame.get("traverse_wide"), f"fused: the wide kernel ran: {f_frame}"
    compare_frames("atrium 1080p wide vs fused", rw, rf, card)
    print(f"atrium 1080p: wide {w_s:.4f} s/frame ({w_mrays:.3f} Mrays/s, peak {w_peak:.1f} MiB, "
          f"launches/frame {w_frame}) vs fused {f_s:.4f} s/frame ({f_mrays:.3f} Mrays/s, peak "
          f"{f_peak:.1f} MiB, launches/frame {f_frame}) [{card}]", flush=True)
    del rw, rf
    torch.cuda.empty_cache()
    return w_launches, {"s_frame": w_s, "launches_per_frame": w_frame.get("traverse_wide", 0)}


def phase_wide_bistro(card, pool, inst, b_mats, b_lights, b_cam, b_atlas, rng):
    """Phase 37a: the full bistro at 1080p, wide against fused (the wide
    frame makes no ``vkrt_traverse_wide`` launch: each two-level call is a
    ``vkrt_wide_machine`` launch a pass); then the wide machine against its
    round loops on 2^18 camera rays (the opaque and the alpha pass of the
    split, closest and any) and on 2^18 rays toward the foliage, beside the
    fused back end's machines on the same rays."""
    from vk_raytrace_torch import render as R
    from vk_raytrace_torch import travbench as tb
    from vk_raytrace_torch.integrator.camera import with_aspect
    from vk_raytrace_torch.models.schema import PBR_GLTF, RenderConfig
    from vk_raytrace_torch.ops import tlas
    from vk_raytrace_torch.ops import traverse_fused as tf
    from vk_raytrace_torch.ops.traverse_wide import make_alpha_pack

    dev = torch.device("cuda", 0)
    bscene = R.build_instanced_scene(pool, inst, b_mats, b_lights, b_cam, atlas=b_atlas)
    t0 = time.time()
    acc_w = tlas.with_wide(bscene.instances, bscene.geometry)
    print(f"bistro 8-wide BLAS: {acc_w.blas.rows.shape[0]} rows (stack {acc_w.blas.stack_depth}) "
          f"built in {time.time() - t0:.2f} s", flush=True)
    b_cfg = RenderConfig(width=WIDE_W, height=WIDE_H, pbr_mode=PBR_GLTF, **BISTRO_CFG)
    scene_w = dataclasses.replace(bscene, instances=acc_w)
    rw, w_s, w_mrays, w_frame, w_peak = render_phase(
        "bistro 1080p d4 1spp fused shading, renderer=wide",
        lambda: R.Renderer(scene_w, b_cfg, device=dev, fused_shade=True, renderer="wide"), card,
        want=("wide_machine", "shade_stage"))
    w_launches = dict(tf.LAUNCHES)
    assert not w_frame.get("traverse_wide"), f"bistro wide: a per-round launch ran: {w_frame}"
    assert not w_frame.get("opaque_machine") and not w_frame.get("alpha_machine"), w_frame
    rf, f_s, f_mrays, f_frame, f_peak = render_phase(
        "bistro 1080p d4 1spp fused shading, renderer=fused",
        lambda: R.Renderer(bscene, b_cfg, device=dev, fused_shade=True), card,
        want=("opaque_machine", "alpha_machine", "shade_stage"))
    compare_frames("bistro 1080p wide vs fused", rw, rf, card)
    print(f"bistro 1080p: wide {w_s:.4f} s/frame ({w_mrays:.3f} Mrays/s, peak {w_peak:.1f} MiB, "
          f"launches/frame {w_frame}) vs fused {f_s:.4f} s/frame ({f_mrays:.3f} Mrays/s, peak "
          f"{f_peak:.1f} MiB, launches/frame {f_frame}); wide/fused {w_s / f_s:.2f}x [{card}]",
          flush=True)
    acc_d = rw.packed
    del rw, rf
    torch.cuda.empty_cache()
    n = WIDE_RAYS
    o, d = camera_rays(with_aspect(b_cam, WIDE_W, WIDE_H).to(dev), WIDE_W, WIDE_H, n, rng, dev)
    sc = bscene.to(dev)
    pack = make_alpha_pack(sc.materials, sc.atlas, sc.geometry.tri_material)
    seed = torch.tensor(rng.integers(0, 2**32, n), device=dev)
    act = torch.ones(n, dtype=torch.bool, device=dev)
    inf = torch.full((n,), tf.INF, device=dev)
    t_sh = torch.tensor(rng.uniform(1.0, 60.0, n), dtype=torch.float32, device=dev)
    res = {}
    res["closest"], out_o, r_o = wide_machine_case(
        "bistro wide machine, camera rays, closest, the opaque instances", acc_d, "opaque", None,
        o, d, inf, seed, act, False, card)
    res["alpha_closest"], _, r_a = wide_machine_case(
        "bistro wide machine, camera rays, closest, the alpha instances windowed by the opaque "
        "t, test inline", acc_d, "alpha", pack, o, d, out_o[0].contiguous(), seed, act, False,
        card)
    res["any"], occ, _ = wide_machine_case(
        "bistro wide machine, camera rays within 1-60, any, the opaque instances", acc_d,
        "opaque", None, o, d, t_sh, seed, act, True, card)
    res["alpha_any"], _, _ = wide_machine_case(
        "bistro wide machine, camera rays within 1-60, any, the alpha instances for the rays "
        "left open, test inline", acc_d, "alpha", pack, o, d, t_sh, seed, occ[1] < 0, True, card)
    # The fused back end's rounds per ray on the same camera rays.
    fr_o = torch.zeros(n, dtype=torch.int64, device=dev)
    fr_a = torch.zeros(n, dtype=torch.int64, device=dev)
    planar, roots, view, mask = tlas._subset(acc_d, "opq")
    ft_o, *_ = tlas._two_level_pass(planar, roots, view, o, d, inf, act, mask, True, False,
                                    rounds=fr_o)
    tlas._alpha_rounds(acc_d, pack, o, d, ft_o, seed, act, False, True, rounds=fr_a)
    print("bistro camera rays, rounds per ray (mean, mean of each warp's most, busy share): "
          f"wide opaque pass {warp_rounds(r_o)}, wide alpha pass {warp_rounds(r_a)}; fused "
          f"opaque rounds {warp_rounds(fr_o)}, fused alpha rounds {warp_rounds(fr_a)}", flush=True)
    leaf = np.nonzero(np.asarray(bscene.instances.inst_alpha))[0]
    eye = np.asarray(b_cam.view_inverse)[:3, 3]
    ol, dl = rays_toward_instances(rng, pool, inst, rng.choice(leaf, n),
                                   eye + rng.uniform(-2.0, 2.0, (n, 3)), dev)
    tl, *_ = tlas._two_level_opaque_pass(acc_d, "opq", ol, dl, inf, act, True, False)
    tl = tl.contiguous()
    res["foliage"], _, ra = wide_machine_case(
        "bistro wide machine, 2^18 rays toward the foliage, closest, the alpha instances "
        "windowed by the opaque t", acc_d, "alpha", pack, ol, dl, tl, seed, act, False, card)
    w_ms = res["foliage"][1][0]
    m_ms = tb.cuda_time(lambda: tlas._two_level_alpha_pass(acc_d, pack, ol, dl, tl, seed, act,
                                                           False, True), 10)
    o_ms = tb.cuda_time(lambda: tlas._two_level_opaque_pass(acc_d, "opq", o, d, inf, act, True,
                                                            False), 10)
    print(f"bistro, the same rays through the fused back end's machines: the alpha pass toward "
          f"the foliage, wide machine {w_ms:.3f} ms ({warp_rounds(ra)[0]:.2f} rounds/ray) "
          f"against the alpha machine {m_ms:.3f} ms; the camera rays' opaque pass, wide machine "
          f"{res['closest'][1][0]:.3f} ms against the opaque machine {o_ms:.3f} ms [{card}]",
          flush=True)
    return w_launches, res, {
        "s_frame": w_s, "fused_s_frame": f_s,
        "launches_per_frame": w_frame.get("wide_machine", 0),
        "rounds_per_ray": warp_rounds(r_o)[0] + warp_rounds(r_a)[0],
        "alpha_pass_ms": w_ms, "alpha_machine_ms": m_ms, "opaque_machine_ms": o_ms}


def phase_wide_plaza(card, plaza, rng):
    """Phase 38: the plaza (4,609 instances: the wide machine's instance
    table in global memory) from phase 28's glTF, the wide machine against
    its round loops on 2^18 world rays (camera rays at 1280x720 and the
    shadow rays of their hits toward the sun), the two passes of the
    instance-level split: closest over the opaque instances without the
    pack, then over the alpha instances with it windowed by that t; any over
    the opaque instances, then over the alpha instances for the rays left
    open. Timed beside the fused back end's machines on the same rays.
    Returns the cases' results and the fused machines' ms."""
    from vk_raytrace_torch import render as R
    from vk_raytrace_torch import travbench as tb
    from vk_raytrace_torch.integrator.camera import with_aspect
    from vk_raytrace_torch.models.gltf import load_gltf
    from vk_raytrace_torch.ops import tlas
    from vk_raytrace_torch.ops import traverse_fused as tf
    from vk_raytrace_torch.ops.traverse_wide import make_alpha_pack

    dev = torch.device("cuda", 0)
    (pool, inst), mats, lights, cam, atlas = load_gltf(plaza, instancing="auto")
    scene = R.build_instanced_scene(pool, inst, mats, lights, cam, atlas=atlas)
    t0 = time.time()
    acc = tlas.with_wide(scene.instances, scene.geometry).to(dev)
    n_inst = acc.inst.aabb_min.shape[0]
    assert n_inst == 4609 and n_inst > tlas._DENSE_I_MAX, n_inst
    print(f"plaza 8-wide BLAS: {acc.blas.rows.shape[0]} rows (stack {acc.blas.stack_depth}) for "
          f"{n_inst} instances, built in {time.time() - t0:.2f} s", flush=True)
    sc = scene.to(dev)
    pack = make_alpha_pack(sc.materials, sc.atlas, sc.geometry.tri_material)
    del sc
    n = WIDE_RAYS
    poc, pdc = camera_rays(with_aspect(cam, 1280, 720).to(dev), 1280, 720, n // 2, rng, dev)
    first, _ = tlas.closest_hit_instanced(acc, None, poc, pdc, backend="wide")
    hit_ids = torch.nonzero(first.tri >= 0).squeeze(1)
    hit_ids = hit_ids[torch.arange(n // 2, device=dev) % hit_ids.numel()]
    sun = torch.tensor([0.35, 0.85, 0.4], device=dev)
    sun = sun / sun.norm()
    pso = poc[hit_ids] + pdc[hit_ids] * (first.t[hit_ids] * (1.0 - 1e-4))[:, None]
    o = torch.cat([poc, pso]).contiguous()
    d = torch.cat([pdc, sun.expand(n // 2, 3)]).contiguous()
    inf = torch.full((n,), tf.INF, device=dev)
    t_short = torch.tensor(rng.uniform(1.0, 60.0, n), dtype=torch.float32, device=dev)
    seed = torch.tensor(rng.integers(0, 2**32, n), device=dev)
    act = torch.ones(n, dtype=torch.bool, device=dev)
    res = {}
    res["closest"], out_c, _ = wide_machine_case(
        "plaza wide machine, closest, the opaque instances (trunks, ground), no pack", acc,
        "opaque", None, o, d, inf, seed, act, False, card)
    res["alpha_closest"], _, _ = wide_machine_case(
        "plaza wide machine, closest, the alpha instances (foliage) with the pack, windowed by "
        "the opaque t", acc, "alpha", pack, o, d, out_c[0].contiguous(), seed, act, False, card)
    res["any"], out_a, _ = wide_machine_case(
        "plaza wide machine, any within 1-60, the opaque instances, no pack", acc, "opaque",
        None, o, d, t_short, seed, act, True, card)
    res["alpha_any"], _, _ = wide_machine_case(
        "plaza wide machine, any within 1-60, the alpha instances with the pack for the rays "
        "left open", acc, "alpha", pack, o, d, t_short, seed, out_a[1] < 0, True, card)
    fused = {
        "opaque_machine": tb.cuda_time(lambda: tlas._two_level_opaque_pass(
            acc, "opq", o, d, inf, act, True, False), 3),
        "alpha_machine": tb.cuda_time(lambda: tlas._two_level_alpha_pass(
            acc, pack, o, d, out_c[0].contiguous(), seed, act, False, True), 3),
    }
    print(f"plaza, the same rays: wide machine closest {res['closest'][1][0]:.3f} ms (the "
          f"opaque instances) and {res['alpha_closest'][1][0]:.3f} ms (the alpha instances); the "
          f"fused back end's opaque machine {fused['opaque_machine']:.3f} ms (opaque subsets), "
          f"alpha machine {fused['alpha_machine']:.3f} ms (alpha subsets, windowed by the wide "
          f"opaque t) [{card}]", flush=True)
    return res, fused


def phase_wide_viewer(card):
    """Phase 37c: the viewer on the atrium switched to wide over HTTP; its
    picks equal ``Renderer(renderer="wide").pick`` on the camera the
    service used. Returns the launches after the switch."""
    import threading
    import urllib.request

    from vk_raytrace_torch import render as R
    from vk_raytrace_torch import viewer as V
    from vk_raytrace_torch.ops import traverse_fused as tf

    svc = V.ViewerService(V.build_parser().parse_args(WIDE_VIEWER))
    t = threading.Thread(target=svc.run_render_loop, daemon=True)
    t.start()
    httpd = V.serve(svc, "127.0.0.1", 0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=120) as resp:
            return resp.read()

    def post(body):
        req = urllib.request.Request(base + "/control", method="POST",
                                     data=json.dumps(body).encode())
        urllib.request.urlopen(req, timeout=60).close()

    def wait(pred, timeout=300.0):
        t0 = time.time()
        while time.time() - t0 < timeout:
            st = json.loads(get("/state"))
            if pred(st):
                return st
            assert t.is_alive(), "the viewer's render loop died"
            time.sleep(0.05)
        raise AssertionError("viewer: timeout")

    try:
        wait(lambda s: s.get("frame", 0) >= 2)
        post({"cmd": "set", "key": "renderer", "value": "wide"})
        t0 = time.time()
        while (svc._renderer is None or svc._renderer.renderer != "wide") and time.time() - t0 < 300:
            time.sleep(0.05)
        assert svc._renderer.renderer == "wide", "viewer: the switch to wide did not happen"
        # Counted from the first frame the wide renderer finished: the frames
        # after it are its own.
        tf.reset_launches()
        f0 = json.loads(get("/state"))["frame"]
        wait(lambda s: s.get("frame", 0) >= f0 + 2)
        lau = {k: v for k, v in tf.LAUNCHES.items() if v}
        assert lau.get("traverse_wide", 0) > 0, f"viewer: the wide kernel never launched: {lau}"
        assert not any(lau.get(k) for k in ATRIUM_KERNELS), f"viewer: a fused kernel ran: {lau}"
        ref = R.Renderer(svc._scene0, svc._renderer.cfg, device=svc.device,
                         packed=svc._renderer.packed, renderer="wide")
        vw, vh = svc.args.size
        prng = np.random.default_rng(37)
        hits = 0
        # Each hit moves the pivot, so the camera is read before each pick and
        # the next waits for the pivot's reset, as in phase 32.
        for x, y in zip(prng.integers(0, vw, 8), prng.integers(0, vh, 8)):
            resets = json.loads(get("/state"))["resets"]
            cam = svc._renderer.scene.camera
            got = json.loads(get(f"/pick?x={x}&y={y}"))
            ref.scene = dataclasses.replace(ref.scene, camera=cam)
            want = ref.pick(int(x), int(y))
            assert (got is None) == (want is None), (x, y, got, want)
            if got is not None:
                hits += 1
                assert (got["triangle"], got["material"], got["t"]) == (
                    want["triangle"], want["material"], want["t"]), (x, y, got, want)
                wait(lambda s: s["resets"] > resets)  # the pick's pivot applied
        assert hits >= 4 or WIDE_VIEWER[1] != "atrium", hits
        print(f"viewer {' '.join(WIDE_VIEWER)} switched to wide over HTTP: frames go on, {hits} of 8 "
              f"picks hit, each equal to Renderer(renderer='wide').pick; launches after the "
              f"switch {lau} [{card}]", flush=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=30)
        svc._stop = True
        t.join(timeout=120)
    assert not t.is_alive(), "viewer: the render loop did not stop"
    return lau


# ---- Phase 39: the pooled wavefront's loop and its two kernels ---------------
WAVEFRONT_SOURCE = "vk_raytrace_torch/csrc/wavefront.cu"
REGEN_REPLACES = "vk_raytrace_tpu/integrator/wavefront.py:158"  # regenerate
RETIRE_REPLACES = "vk_raytrace_tpu/integrator/wavefront.py:404"  # the epilogue after the shadow ray
WAVEFRONT_REPLACES_KIND = "XLA body (render_units_pooled's regenerate / bounce epilogue), not a pallas_call"
WAVEFRONT_KERNELS = ("regenerate", "retire")
# Bytes and operations of the function: a regeneration reads every flag once and
# writes a granted lane's 101 bytes (pix, unit, seed, depth 8 each; origin,
# direction, radiance, throughput, absorption 12 each; bsdf_pdf, tdist 4
# each; the flag); a granted lane's TEA (16 rounds of ~14 integer operations), four
# PCG draws (~8 each) and camera (~60 float operations), counted at the
# float rate: ~320.
REGEN_FLAG_BYTES, REGEN_GRANT_BYTES, REGEN_GRANT_OPS = 1, 101, 320
# A retirement reads a lane's flags (active, alive, visible), depth, seed,
# radiance and throughput (43 B) and writes its radiance, throughput, seed,
# depth and flag (41 B); rr_pcont where the roulette gates (4), occluded where
# visible (1), nee where lit (12), pdf_b read and bsdf_pdf written where
# alive (8), unit read and out written where it retires (20), pix, steps and
# the step add where it is active with a step record (16). ~25 operations a
# lane (the adds, a PCG draw, the divisions, the clamp).
RETIRE_LANE_BYTES, RETIRE_LANE_OPS = 84, 25


def regen_work(st, ctrl, total_units):
    """(bytes, ops) one regeneration moves and does on this pool."""
    n = st["active"].shape[0]
    dead = int((~st["active"]).sum())
    granted = min(dead, total_units - int(ctrl[0]))
    return n * REGEN_FLAG_BYTES + granted * REGEN_GRANT_BYTES, granted * REGEN_GRANT_OPS


def retire_work(st, b, sl, track):
    """(bytes, ops) one retirement moves and does on this pool (its data:
    the gated, visible, lit, alive and retiring lanes)."""
    act = st["active"]
    gate = (st["depth"] >= sl.rr_depth) & act if sl.rr else torch.zeros_like(act)
    lit = b["visible"] & ~b["occluded"]
    n = int(act.shape[0])
    extra = (4 * int(gate.sum()) + int(b["visible"].sum()) + 12 * int(lit.sum())
             + 8 * int(b["alive"].sum()) + 20 * int((act & ~b["alive"]).sum())
             + (16 * int(act.sum()) if track else 0))
    return n * RETIRE_LANE_BYTES + extra, n * RETIRE_LANE_OPS


@contextlib.contextmanager
def plain_pool():
    """The loop's two stages through their plain versions (on the card too)."""
    from vk_raytrace_torch.integrator import pool as wp

    saved = wp.regenerate, wp.retire
    wp.regenerate, wp.retire = wp._regenerate_plain, wp._retire_plain
    try:
        yield
    finally:
        wp.regenerate, wp.retire = saved


def capture_states(r, frame):
    """Render ``frame`` through ``r`` and keep copies of the pool's state as
    each stage met it at the loop's first iteration (a fresh pool), its
    third (a full pool, some lanes regenerating) and the first at each
    tier's width (a quarter, a sixteenth). Returns (regeneration inputs,
    retirement inputs), each a list of (label, args)."""
    from vk_raytrace_torch.integrator import pool as wp

    regen, retire, seen = [], [], {"it": -1, "widths": set()}
    orig_regen, orig_retire = wp.regenerate, wp.retire

    def copy(st):
        return {k: v.clone() for k, v in st.items()}

    def label(it, width):
        return f"iteration {it}, {width} lanes"

    def want(it, width):
        return it in (0, 2) or width not in seen["widths"]

    def hook_regen(st, ctrl, occ, it, sl):
        seen["it"] = it
        width = st["active"].shape[0]
        if want(it, width):
            regen.append((label(it, width), (copy(st), ctrl.clone(), it, sl)))
        return orig_regen(st, ctrl, occ, it, sl)

    def hook_retire(st, b, ctrl, out, steps, sl):
        it, width = seen["it"], st["active"].shape[0]
        if want(it, width):
            seen["widths"].add(width)
            retire.append((label(it, width), (copy(st), {k: v.clone() for k, v in b.items()},
                                               ctrl.clone(), sl)))
        return orig_retire(st, b, ctrl, out, steps, sl)

    wp.regenerate, wp.retire = hook_regen, hook_retire
    try:
        r.render_frame(frame)
        torch.cuda.synchronize()
    finally:
        wp.regenerate, wp.retire = orig_regen, orig_retire
    return regen, retire


# Device cycles (~3 ms) that the card sleeps before a queued timing starts.
QUEUE_SLEEP_CYCLES = 5_000_000


def events_ms(calls, queue=False):
    """Mean ms per call of ``calls`` run back to back between two CUDA
    events, after the first as a warm-up (each call on inputs of its own,
    prepared beforehand, so that the events time the device's work). With
    ``queue`` the card first sleeps while the host queues every call, so
    that a kernel shorter than its host call is timed, not the host's
    launch rate."""
    calls[0]()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queue:
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    a.record()
    for call in calls[1:]:
        call()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (len(calls) - 1)


def same_bits(what, a, b):
    """Assert every field of ``a`` equal to ``b``'s bit for bit; return the
    largest |a - b| over the float fields' finite values."""
    err = 0.0
    for k in a:
        x, y = a[k], b[k]
        if x is None:
            continue
        eq = x.shape == y.shape and torch.equal(
            x.view(torch.int32) if x.dtype == torch.float32 else x,
            y.view(torch.int32) if y.dtype == torch.float32 else y)
        assert eq, f"{what}: {k} differs from the plain version"
        if x.dtype == torch.float32:
            fin = torch.isfinite(x) & torch.isfinite(y)
            if bool(fin.any()):
                err = max(err, float((x[fin] - y[fin]).abs().max()))
    return err


def regen_case(what, args, card, reps=10):
    """vkrt_regenerate against its plain version on a captured pool, bit for
    bit (every field, the loop control, the occupancy entry); both timed on
    fresh copies (the kernel's launches back to back on arguments built
    beforehand). Returns (ms, plain_ms, (bound_ms, bound_by), bytes, granted,
    max_abs_err)."""
    from vk_raytrace_torch import travbench as tb
    from vk_raytrace_torch.integrator import pool as wp

    st0, ctrl0, it, sl = args
    dev = st0["active"].device

    def fresh():
        return ({k: v.clone() for k, v in st0.items()}, ctrl0.clone(),
                torch.full((wp.OCC_LEN,), -1, dtype=torch.int32, device=dev), it, sl)

    kern, plain = fresh(), fresh()
    before = wp.LAUNCHES["regenerate"]
    wp._regenerate_cuda(*kern)
    wp._regenerate_plain(*plain)
    torch.cuda.synchronize()
    assert wp.LAUNCHES["regenerate"] == before + 1
    err = same_bits(f"regenerate, {what}", kern[0], plain[0])
    same_bits(f"regenerate, {what}", {"ctrl": kern[1], "occ": kern[2]},
              {"ctrl": plain[1], "occ": plain[2]})
    granted = int(kern[0]["active"].sum()) - int(st0["active"].sum())
    # The kernel on arguments built beforehand, one fresh pool each.
    pools = [fresh() for _ in range(reps + 1)]
    ms = events_ms([lambda x=wp.regenerate_args(*p): wp.launch("regenerate", x) for p in pools])
    plain_ms = events_ms([lambda a=fresh(): wp._regenerate_plain(*a) for _ in range(3)])
    n_bytes, n_ops = regen_work(st0, ctrl0, sl.total_units)
    bnd = tb.bound(n_bytes, n_ops)
    print(f"regenerate, {what}: {granted} lanes granted, bit for bit (max |err| {err}) -> "
          f"OK; kernel {ms:.4f} ms (one launch), plain {plain_ms:.3f} ms; bound "
          f"{bnd[0]:.4f} ms by {bnd[1]} "
          f"({n_bytes / 1e6:.2f} MB; {ms / bnd[0]:.1f}x the bound) ({card})", flush=True)
    return ms, plain_ms, bnd, n_bytes, granted, err


def retire_case(what, args, card, reps=10):
    """vkrt_retire against its plain version on a captured pool and bounce,
    with the step record, bit for bit (every field, the control, the
    retired units' rows, the steps); both timed on fresh copies, the
    kernel's launches queued behind a device sleep (its host call outlasts
    it on the tiers' pools).
    Returns (ms, plain_ms, (bound_ms, bound_by), bytes, max_abs_err)."""
    from vk_raytrace_torch import travbench as tb
    from vk_raytrace_torch.integrator import pool as wp

    st0, b, ctrl0, sl = args
    n = st0["active"].shape[0]
    dev = st0["active"].device

    def fresh():
        return ({k: v.clone() for k, v in st0.items()}, b, ctrl0.clone(),
                torch.zeros(sl.total_units + n, 3, device=dev),
                torch.zeros(sl.n_pix + 1, dtype=torch.int32, device=dev), sl)

    kern, plain = fresh(), fresh()
    wp._retire_cuda(*kern)
    wp._retire_plain(*plain)
    torch.cuda.synchronize()
    err = max(same_bits(f"retire, {what}", kern[0], plain[0]),
              same_bits(f"retire, {what}", {"ctrl": kern[2], "out": kern[3][:sl.total_units],
                                            "steps": kern[4][:sl.n_pix]},
                        {"ctrl": plain[2], "out": plain[3][:sl.total_units],
                         "steps": plain[4][:sl.n_pix]}))
    died = int((st0["active"] & ~kern[0]["active"]).sum())
    pools = [fresh() for _ in range(reps + 1)]
    ms = events_ms([lambda x=wp.retire_args(*p): wp.launch("retire", x) for p in pools],
                   queue=True)
    plain_ms = events_ms([lambda a=fresh(): wp._retire_plain(*a) for _ in range(3)])
    n_bytes, n_ops = retire_work(st0, b, sl, True)
    bnd = tb.bound(n_bytes, n_ops)
    print(f"retire, {what}: {int(st0['active'].sum())} active, {died} retired, bit for bit "
          f"(max |err| {err}) -> OK; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms; bound "
          f"{bnd[0]:.4f} ms by {bnd[1]} ({n_bytes / 1e6:.2f} MB; {ms / bnd[0]:.1f}x the bound) "
          f"({card})", flush=True)
    return ms, plain_ms, bnd, n_bytes, err


# Pools of one block or less and off a multiple of vkrt_retire's 256-lane
# block.
RETIRE_TAILS = (1, 3, 2085)


def cut_pool(args, n):
    """A captured retirement cut to its first ``n`` lanes (fresh tensors)."""
    st0, b, ctrl0, sl = args
    return ({k: v[:n].clone() for k, v in st0.items()}, {k: v[:n].clone() for k, v in b.items()},
            ctrl0.clone(), sl)


def loop_counts(what, r, frame, card):
    """One frame under torch's sync debug mode "error" inside each
    iteration (``wavefront.CHECK_SYNCS``): the loop's iterations, the host's
    reads of the loop control (one an iteration), and the launches per
    iteration and per frame. Returns the counts."""
    from vk_raytrace_torch.integrator import pool as wp
    from vk_raytrace_torch.integrator import shade_fused as sf
    from vk_raytrace_torch.integrator import wavefront as wf
    from vk_raytrace_torch.ops import traverse_fused as tf

    for m in (tf, sf, wp):
        m.reset_launches()
    wf.reset_counts()
    wf.CHECK_SYNCS = True
    try:
        r.render_frame(frame)
        torch.cuda.synchronize()
    finally:
        wf.CHECK_SYNCS = False
    it, reads = wf.LOOP["iterations"], wf.LOOP["host_reads"]
    lau = {k: v for k, v in {**tf.LAUNCHES, **sf.LAUNCHES, **wp.LAUNCHES}.items() if v}
    assert reads == it > 0, f"{what}: {reads} host reads in {it} iterations"
    assert lau.get("regenerate") == lau.get("retire") == it, f"{what}: {lau} in {it} iterations"
    print(f"{what}: {it} iterations, {reads} host reads of the loop control (one an iteration; "
          f"no other sync inside them: sync debug mode \"error\"), launches per frame {lau}, per "
          f"iteration {({k: round(v / it, 2) for k, v in lau.items()})} [{card}]", flush=True)
    return {"iterations": it, "host_reads": reads, "launches": lau}


def frames_vs_plain(what, r, card, frame=1):
    """Frame ``frame`` through the kernels and through the plain versions on
    the card: the same image bytes and rays."""
    t0 = time.perf_counter()
    img = r.render_frame(frame).cpu().numpy()
    k_s, k_rays = time.perf_counter() - t0, r.last_rays
    with plain_pool():
        t0 = time.perf_counter()
        ref = r.render_frame(frame).cpu().numpy()
        p_s, p_rays = time.perf_counter() - t0, r.last_rays
    assert np.isfinite(img).all() and img.mean() > 0.0, f"{what}: bad image"
    assert img.tobytes() == ref.tobytes(), (
        f"{what}: {int((img != ref).any(-1).sum())} pixels differ from the plain versions' frame")
    assert k_rays == p_rays, f"{what}: rays {k_rays} vs {p_rays}"
    print(f"{what}, frame {frame}: through the kernels equal to the plain versions' frame byte "
          f"for byte, rays {k_rays} both; {k_s:.4f} s vs {p_s:.4f} s [{card}]", flush=True)


def phase_wavefront(card, scene, cfg, bundle, bistro_args):
    """Phase 39: the loop's two kernels against their plain versions on the
    fused atrium's 2^18-lane pools of a real 1080p frame (a fresh pool, a
    full one, the quarter and sixteenth tiers), timed beside their bounds;
    the fused atrium, the bistro and the wide atrium at 1080p through the
    kernels against the same frames through the plain versions; the loop's
    iterations, host reads and launches a frame under the sync check.
    Returns (regenerate result, retire result, loop counts by scene)."""
    from vk_raytrace_torch import render as R
    from vk_raytrace_torch.models.schema import PBR_GLTF, RenderConfig

    dev = torch.device("cuda", 0)
    rf = R.Renderer(scene, cfg, device=dev, packed=bundle, fused_shade=True)
    rf.render_frame(0)
    regen, retire = capture_states(rf, 1)
    widths = {a[0]["active"].shape[0] for _, a in regen}
    assert R.POOL_LANES in widths and len(widths) > 1, [w for w, _ in regen]
    regen_res = {w: regen_case(w, a, card) for w, a in regen}
    full = next(a for w, a in retire if w.startswith("iteration 2,"))
    retire += [(f"iteration 2, its first {n} lanes", cut_pool(full, n)) for n in RETIRE_TAILS]
    retire_res = {w: retire_case(w, a, card) for w, a in retire}
    del regen, retire
    counts = {"atrium_fused": loop_counts("atrium 1080p fused", rf, 2, card)}
    frames_vs_plain("atrium 1080p fused", rf, card)
    del rf
    rw = R.Renderer(scene, cfg, device=dev, fused_shade=True, renderer="wide")
    rw.render_frame(0)
    counts["atrium_wide"] = loop_counts("atrium 1080p fused, renderer=wide", rw, 2, card)
    frames_vs_plain("atrium 1080p fused, renderer=wide", rw, card)
    del rw
    pool, inst, b_mats, b_lights, b_cam, b_atlas = bistro_args
    bscene = R.build_instanced_scene(pool, inst, b_mats, b_lights, b_cam, atlas=b_atlas)
    b_cfg = RenderConfig(width=1920, height=1080, pbr_mode=PBR_GLTF, **BISTRO_CFG)
    rb = R.Renderer(bscene, b_cfg, device=dev, fused_shade=True)
    rb.render_frame(0)
    counts["bistro_fused"] = loop_counts("bistro 1080p fused", rb, 2, card)
    frames_vs_plain("bistro 1080p fused", rb, card)
    del rb, bscene
    torch.cuda.empty_cache()
    return regen_res, retire_res, counts


# ---- Phase 40: the alpha pass's root prefilter -------------------------------
PREFILTER_REPLACES = "vk_raytrace_tpu/ops/traverse_fused.py:575"  # root_prefilter
PREFILTER_REPLACES_KIND = ("XLA body (root_prefilter, with the need line of _alpha_rounds at "
                           "vk_raytrace_tpu/ops/traverse_alpha.py:175-183), not a pallas_call")
# The loop iterations whose alpha passes phase 40 captures: a fresh pool, a
# full one, the first at a quarter and at a sixteenth of the pool.
PREFILTER_ITERATIONS = (0, 2, 10, 11)
# Operations of one root child's test (csrc/traverse.cu root_child_hit):
# the valid compare, 6 subtract, 6 multiply, 6 NaN tests, 10 min/max, 3
# compares.
PREFILTER_CHILD_OPS = 32
PREFILTER_SYNTH_RAYS = 1 << 16


def prefilter_work(planar, o, d, t_limit, active):
    """(bytes, ops, ops without the quad boxes) the alpha pass's need mask
    moves and does on these rays: each ray's output byte and its flag (where
    ``active`` is given), t_limit where active, the ray (24 B) where t_limit
    > 0 too, the root row's 6·W bounds once. Ops: each such ray tests the
    boxes of the root children's quads in order up to the quad of its first
    hit child, and the children of each quad whose box it enters in order up
    to that child (csrc/traverse.cu root_prefilter_kernel); without the quad
    boxes, the children in order up to the first hit."""
    from vk_raytrace_torch.ops import traverse_fused as tf

    n, w = o.shape[0], planar.width
    act = torch.ones(n, dtype=torch.bool, device=o.device) if active is None else active
    tested = act & (t_limit > 0.0)
    valid, bmin, bmax = tf._root_boxes(planar.rows, w)
    inv = tf.inv_dir(d)[:, None, :]

    def hits(lo, hi, ok):
        tn, tfar = tf._slab(lo[None], hi[None], o[:, None, :], inv)
        return ok[None] & (tn <= tfar) & (tfar >= 0.0) & (tn < t_limit[:, None])

    inf = torch.tensor(float("inf"), device=o.device)
    q_valid = valid.reshape(-1, 4)
    q_lo = torch.where(q_valid[..., None], bmin.reshape(-1, 4, 3), inf).amin(1)
    q_hi = torch.where(q_valid[..., None], bmax.reshape(-1, 4, 3), -inf).amax(1)
    child = hits(bmin, bmax, valid)
    quad = hits(q_lo, q_hi, q_valid.any(1))
    first = torch.where(child.any(1), child.int().argmax(1), w)  # the first hit child
    q = torch.arange(w // 4, device=o.device)[None]
    before = q < (first // 4)[:, None]  # quads tested and passed over
    last = (first < w)[:, None] & (q == (first // 4)[:, None])
    n_quad = (before | last).sum(1) + 4 * (quad & before).sum(1) + (first % 4 + 1) * (first < w)
    n_bytes = (n * (2 if active is not None else 1) + 4 * int(act.sum())
               + 24 * int(tested.sum()) + 24 * w)
    n_child = torch.where(first < w, first + 1, w)
    return (n_bytes, PREFILTER_CHILD_OPS * int(n_quad[tested].sum()),
            PREFILTER_CHILD_OPS * int(n_child[tested].sum()))


def capture_alpha_inputs(r, frame):
    """Render ``frame`` through ``r`` and keep copies of the alpha pass's
    inputs, closest (culling) and shadow, at the loop iterations
    :data:`PREFILTER_ITERATIONS` (each kind's k-th call is iteration k).
    Returns a list of (label, (planar, origin, direction, t_limit,
    active), (pack, seed, cull))."""
    from vk_raytrace_torch.ops import traverse_alpha as ta

    got, calls, orig = [], {True: -1, False: -1}, ta._alpha_rounds

    def hook(planar, pack, origin, direction, t_limit, seed, active, cull):
        calls[cull] += 1
        if calls[cull] in PREFILTER_ITERATIONS:
            seed0 = (torch.zeros(origin.shape[0], dtype=torch.int64, device=origin.device)
                     if seed is None else seed.clone())
            got.append((f"iteration {calls[cull]}, {'closest' if cull else 'shadow'} pass, "
                        f"{origin.shape[0]} lanes",
                        (planar, origin.clone(), direction.clone(), t_limit.clone(),
                         None if active is None else active.clone()), (pack, seed0, cull)))
        return orig(planar, pack, origin, direction, t_limit, seed, active, cull)

    ta._alpha_rounds = hook
    try:
        r.render_frame(frame)
        torch.cuda.synchronize()
    finally:
        ta._alpha_rounds = orig
    return got


def prefilter_check(what, args):
    """vkrt_root_prefilter (one launch) against ``_alpha_need_plain`` on
    the same rays: the same bools. Returns (rays that need the rounds,
    max_abs_err)."""
    from vk_raytrace_torch.ops import traverse_fused as tf

    planar, o, d, t_limit, act = args
    key = tf.launch_key("root_prefilter", planar.width)
    before = tf.LAUNCHES[key]
    kern = tf.alpha_need(planar, o, d, t_limit, act)
    plain = tf._alpha_need_plain(planar, o, d, t_limit, act)
    torch.cuda.synchronize()
    assert tf.LAUNCHES[key] == before + 1, f"root prefilter, {what}: not one launch"
    err = float((kern.int() - plain.int()).abs().max()) if kern.numel() else 0.0
    assert kern.dtype == torch.bool and torch.equal(kern, plain), (
        f"root prefilter, {what}: {int((kern != plain).sum())} rays differ from the plain version")
    return int(kern.sum()), err


def prefilter_case(what, args, card, reps=10):
    """:func:`prefilter_check`, then both timed (the kernel on a fresh copy
    of the rays a call, so that most reads come from HBM; queued behind a
    sleep, as the host's call takes longer than the kernel). Returns (ms,
    plain_ms, (bound_ms, bound_by), bytes, rays that need the rounds,
    max_abs_err)."""
    from vk_raytrace_torch import travbench as tb
    from vk_raytrace_torch.ops import traverse_fused as tf

    need, err = prefilter_check(what, args)
    planar, o, d, t_limit, act = args
    copies = [tuple(x if x is None else x.clone() for x in (o, d, t_limit, act))
              for _ in range(reps + 1)]
    ms = events_ms([lambda c=c: tf._alpha_need_cuda(planar, *c) for c in copies], queue=True)
    plain_ms = events_ms([lambda: tf._alpha_need_plain(planar, o, d, t_limit, act)
                          for _ in range(3)])
    n_bytes, n_ops, child_ops = prefilter_work(planar, o, d, t_limit, act)
    bnd = tb.bound(n_bytes, n_ops)
    print(f"root prefilter W{planar.width}, {what}: {need} of {o.shape[0]} rays need the rounds, "
          f"equal to the plain version -> OK; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms; bound "
          f"{bnd[0]:.4f} ms by {bnd[1]} ({n_bytes / 1e6:.2f} MB, {n_ops / 1e6:.1f} M ops with "
          f"the quad boxes, {child_ops / 1e6:.1f} M without, "
          f"{tb.bound(n_bytes, child_ops)[0]:.4f} ms; {ms / bnd[0]:.1f}x the bound) ({card})",
          flush=True)
    return ms, plain_ms, bnd, n_bytes, need, err


ROUNDS_OUT = ("t", "tri", "u", "v", "seed", "steps")


def fold_case(what, args, extra, card, reps=10):
    """The alpha pass in its two forms on the same rays: (a) the form before
    the fold, ``vkrt_root_prefilter`` and then ``vkrt_alpha_rounds`` on its
    need mask; (b) ``vkrt_alpha_rounds`` alone on the pass's ``active``, its
    ray intake running the need line. Equal bit for bit in t, tri, u, v,
    seed and steps; (b)'s intake counts (rays fetched, rays that needed the
    rounds, equal to the plain need mask's) and, at width 16, its warps'
    busy / slot node lane-steps. With ``reps`` each form is timed on fresh
    copies, queued behind a device sleep. Returns {"ms_a", "ms_b",
    "fetched", "needed", "lane_steps"} (no times without ``reps``)."""
    from vk_raytrace_torch.ops import traverse_alpha as ta
    from vk_raytrace_torch.ops import traverse_fused as tf

    planar, o, d, t_limit, act = args
    pack, seed, cull = extra
    n, dev = o.shape[0], o.device

    def form_a(o, d, t_limit, act, seed):
        need = tf._alpha_need_cuda(planar, o, d, t_limit, act)
        return ta._alpha_rounds_cuda(planar, pack, o, d, t_limit, seed, need, cull)

    def form_b(o, d, t_limit, act, seed):
        return ta._alpha_rounds_cuda(planar, pack, o, d, t_limit, seed, act, cull)

    key = tf.launch_key("alpha_rounds", planar.width)
    before = tf.LAUNCHES[key]
    a = form_a(o, d, t_limit, act, seed)
    b = form_b(o, d, t_limit, act, seed)
    grid = tf._AB_GRIDS[planar.width]
    fetched, needed = grid.intake(dev)
    lane_steps = grid.lane_steps(dev) if planar.width == 16 else None
    torch.cuda.synchronize()
    assert tf.LAUNCHES[key] == before + 2, f"alpha pass, {what}: not one rounds launch a form"
    same_bits(f"alpha pass, {what}: form (b) against form (a)", dict(zip(ROUNDS_OUT, b)),
              dict(zip(ROUNDS_OUT, a)))
    want = int(tf._alpha_need_plain(planar, o, d, t_limit, act).sum())
    assert (fetched, needed) == (n, want), f"alpha pass, {what}: intake {fetched, needed} against {want}"
    res = {"fetched": fetched, "needed": needed, "lane_steps": lane_steps}
    if reps:
        copies = lambda: [tuple(x if x is None else x.clone() for x in (o, d, t_limit, act, seed))  # noqa: E731
                          for _ in range(reps + 1)]
        res["ms_a"] = events_ms([lambda c=c: form_a(*c) for c in copies()], queue=True)
        res["ms_b"] = events_ms([lambda c=c: form_b(*c) for c in copies()], queue=True)
        steps = "" if lane_steps is None else (
            f"; the warps' node lane-steps busy {lane_steps[0]} of {lane_steps[1]} "
            f"({lane_steps[0] / max(lane_steps[1], 1):.3f})")
        print(f"alpha pass W{planar.width}, {what}: (a) prefilter then rounds and (b) the rounds "
              f"alone equal bit for bit (t, tri, u, v, seed, steps); (b)'s intake fetched "
              f"{fetched} rays, {needed} needed the rounds{steps}; (a) {res['ms_a']:.4f} ms, "
              f"(b) {res['ms_b']:.4f} ms ({card})", flush=True)
    return res


def phase_prefilter(card, scene, cfg, bundles, rng):
    """Phase 40: the alpha pass's root prefilter on the card against its
    plain version, bit for bit, at widths 16 and 32 (``bundles``: width ->
    accel bundle): on the fused atrium's closest and shadow passes of a
    real 1080p frame at iterations 0, 2, 10 and 11, timed beside the bound,
    and on every synthetic set of ``prefilter_rays`` with ``active``
    absent, about half and none; on each of those passes and sets the
    alpha pass's two forms (:func:`fold_case`), equal bit for bit, the
    frame's timed. Returns {width: ({label: the frame's case result}, the
    largest max_abs_err of the synthetic sets, {label: the frame's
    fold_case result})}."""
    from vk_raytrace_torch import cuda_build
    from vk_raytrace_torch import render as R

    dev = torch.device("cuda", 0)
    res = {}
    for width, bnd_ in bundles.items():
        rep = cuda_build.resources(f"traverse{width}", "root_prefilter_kernel")
        print(f"ptxas root prefilter W{width}: {rep['registers']} registers, "
              f"{rep['stack_frame']} B stack frame, {rep['spill_stores'] + rep['spill_loads']} B "
              f"spill, {rep['smem']} B shared ({card})", flush=True)
        r = R.Renderer(scene, cfg, device=dev, packed=bnd_, fused_shade=True)
        r.render_frame(0)
        captured = capture_alpha_inputs(r, 1)
        del r
        kinds = {label.split(", ")[1] for label, *_ in captured}
        assert len(captured) == 2 * len(PREFILTER_ITERATIONS) and kinds == {
            "closest pass", "shadow pass"}, [label for label, *_ in captured]
        frame = {label: prefilter_case(label, args, card) for label, args, _ in captured}
        fold = {label: fold_case(label, args, extra, card) for label, args, extra in captured}
        pack = captured[0][2][0]
        del captured
        planar = bnd_.alpha_planar.to(dev)
        errs = []
        for case in PREFILTER_CASES:
            o, d, t_limit = (x.to(dev) for x in prefilter_rays(case, planar,
                                                                PREFILTER_SYNTH_RAYS, rng))
            seed = torch.tensor(rng.integers(0, 2**32, PREFILTER_SYNTH_RAYS), device=dev)
            for k, active in enumerate(PREFILTER_ACTIVE):
                act = prefilter_active(active, PREFILTER_SYNTH_RAYS, rng)
                act = None if act is None else act.to(dev)
                errs.append(prefilter_check(f"{case}, active {active}",
                                            (planar, o, d, t_limit, act))[1])
                fold_case(f"{case}, active {active}", (planar, o, d, t_limit, act),
                          (pack, seed, k % 2 == 0), card, reps=0)
        res[width] = frame, max(errs), fold
        print(f"root prefilter W{width}: {len(errs)} synthetic sets of {PREFILTER_SYNTH_RAYS} rays "
              f"({', '.join(PREFILTER_CASES)}; active {', '.join(PREFILTER_ACTIVE)}) equal to the "
              f"plain version bit for bit, and the alpha pass's two forms equal on each ({card})",
              flush=True)
        torch.cuda.empty_cache()
    return res


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
    # The script's files (checkpoints, images, the port's scene cache) live in
    # a temporary directory, removed at exit.
    work = tempfile.mkdtemp(prefix="vkrt_smoke_")
    atexit.register(shutil.rmtree, work, True)
    from vk_raytrace_torch.utils import cache as scene_cache

    os.environ[scene_cache.ENV] = os.path.join(work, "scene_cache")
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"card: {card}", flush=True)

    # ---- 2. build -----------------------------------------------------------
    phase("build")
    from vk_raytrace_torch.integrator import pool as wp
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
        # Mode c's other per-round kernel (the any-hit candidate rounds').
        "candidate_nocull": (gbundle.alpha_planar, oa, da, inf, False),
    }
    errors, times, bounds = {}, {}, {}
    for key, (planar, oo, dd, tm, cull) in cases.items():
        errors[key], times[key], bounds[key] = traversal_case(
            key, planar, oo, dd, tm, key.split("_")[0], cull, card)

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
    wp.reset_launches()
    t0 = time.time()
    r = R.Renderer(scene, cfg, device=dev)
    renderer_s = time.time() - t0
    build = {"scene_gen_s": scene_gen_s, "scene_tables_s": tables_s,
             "renderer_s": renderer_s, **r.build_times}
    warm_s, frame_s, frame_rays = run_frames(r)
    launches = {**tf.LAUNCHES, **wp.LAUNCHES}
    img = r.accum.cpu().numpy()
    ldr = r.postprocess().cpu().numpy()
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    s_frame = float(np.mean(frame_s))
    mrays = float(np.sum(frame_rays) / np.sum(frame_s) / 1e6)
    build_txt = ", ".join(f"{k} {v:.2f}" for k, v in build.items())
    print(f"warm-up frame {warm_s:.3f} s; frames {['%.4f' % s for s in frame_s]} s; "
          f"rays/frame {frame_rays}; launches {launches}")
    assert all(launches[m] > 0 for m in ATRIUM_KERNELS), f"a traversal kernel never launched: {launches}"
    assert_folded("atrium 1080p", launches)
    assert all(launches[m] > 0 for m in WAVEFRONT_KERNELS), f"a loop kernel never launched: {launches}"
    assert launches["candidate"] == 0, f"a per-round alpha launch ran: {launches}"
    assert np.isfinite(img).all() and np.isfinite(ldr).all(), "non-finite pixels"
    assert img.mean() > 0.0 and ldr.max() > 0.0, "black image"
    assert min(frame_rays) > 1920 * 1080, "fewer rays than primary rays"
    print(f"atrium 1080p d4 1spp: {s_frame:.4f} s/frame, {mrays:.4f} Mrays/s, "
          f"peak {peak_mb:.1f} MiB allocated, mean radiance {img.mean():.4f}; "
          f"build s: {build_txt} [{card}]", flush=True)
    env_bytes = same_environment(r, scene, cfg)
    print(f"the sun&sky environment built again on the card: its {env_bytes} bytes (image, "
          f"alias table, pdfs, rows) equal the renderer's", flush=True)

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
    wp.reset_launches()
    rf = R.Renderer(scene, cfg, device=dev, packed=bundle, fused_shade=True)
    f_warm_s, f_frame_s, f_frame_rays = run_frames(rf)
    f_launches = {**tf.LAUNCHES, **sf.LAUNCHES, **wp.LAUNCHES}
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
    assert_folded("atrium 1080p fused", f_launches)
    assert all(f_launches[m] > 0 for m in WAVEFRONT_KERNELS), f"a loop kernel never launched: {f_launches}"
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
        "candidate_nocull": ("alp", o_leaf, d_leaf, t_far, False),
    }
    def roots_cases(acc, suffix):
        """Phase 8's world rays at each mode's first instance candidates of
        ``acc``, against the twin (kept for phase 12's width-32 tables)."""
        for key, (subset, oo, dd, tm, cull) in root_cases.items():
            name, mode = f"{key}_roots{suffix}", key.split("_")[0]
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
    wp.reset_launches()
    b_warm_s, b_frame_s, b_frame_rays = run_frames(rb)
    b_launches = {**tf.LAUNCHES, **sf.LAUNCHES, **wp.LAUNCHES}
    b_img = rb.accum.cpu().numpy()
    b_ldr = rb.postprocess().cpu().numpy()
    b_peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    b_s_frame = float(np.mean(b_frame_s))
    b_mrays = float(np.sum(b_frame_rays) / np.sum(b_frame_s) / 1e6)
    b_build = {"scene_gen_s": b_gen_s, "scene_tables_and_accel_s": b_tables_s,
               "renderer_s": b_renderer_s, **rb.build_times}
    print(f"warm-up frame {b_warm_s:.3f} s; frames {['%.4f' % s for s in b_frame_s]} s; "
          f"rays/frame {b_frame_rays}; launches {b_launches}")
    want = ("opaque_machine", "alpha_machine", "shade_stage", *WAVEFRONT_KERNELS)
    assert all(b_launches[m] > 0 for m in want), f"a kernel never launched: {b_launches}"
    assert b_launches["shade_bounce"] == 0, f"the body alone launched: {b_launches}"
    assert not any(b_launches[m] for m in tf.ROOT_MODES), f"a per-round launch ran: {b_launches}"
    assert_folded("bistro 1080p fused", b_launches)
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
    for key, (planar, oo, dd, tm, cull) in cases.items():
        mode = key.split("_")[0]
        planar = g32.alpha_planar if mode == "candidate" else g32.opaque_planar
        name = f"{key}_w32"
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
    bench_report(bench, card)

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
    w16_keys = tf.MODES + tf.ROOT_MODES + ("alpha_machine", "alpha_rounds",
                                           "opaque_machine") + FOLDED_KERNELS + BENCH_KERNELS
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

    # ---- 20. BASELINE #4: the Disney material grid ----------------------------
    phase("BASELINE #4: Disney material grid")
    from vk_raytrace_torch.models import hdr
    from vk_raytrace_torch.models.schema import PBR_DISNEY

    t0 = time.time()
    sky = hdr.build_environment(hdr.procedural_sky_hdr())
    gg, gm, gl, gc = procedural.material_test_grid()
    grid = R.build_scene(gg, gm, gl, gc, env=sky)
    print(f"material grid: {len(gg.indices)} triangles; scene and sky {time.time() - t0:.2f} s",
          flush=True)
    cfg4 = RenderConfig(**BASELINE4_CFG, pbr_mode=PBR_DISNEY)
    r4, *_ = render_phase("disney_materials_d8 512x512 4spp d8", lambda: R.Renderer(
        grid, cfg4, device=dev, fused_shade=True), card, want=("closest", "any"), stage="eager")
    del r4

    # ---- 21. BASELINE #2: the helmet, eager and fused -------------------------
    phase("BASELINE #2: helmet")
    t0 = time.time()
    hg, hm, hl, hc, ha = procedural.helmet_scene()
    helmet = R.build_scene(hg, hm, hl, hc, env=sky, atlas=ha)
    hbundle = build_accel_bundle(hg)
    print(f"helmet: {len(hg.indices)} triangles; scene, tables and accel {time.time() - t0:.2f} s",
          flush=True)
    cfg2 = RenderConfig(**BASELINE2_CFG, pbr_mode=PBR_GLTF)
    for fused in (False, True):
        rh, *_ = render_phase(
            f"helmet_512_16spp {'fused' if fused else 'eager'}",
            lambda: R.Renderer(helmet, cfg2, device=dev, packed=hbundle, fused_shade=fused),
            card, want=("closest", "any") + (("shade_stage",) if fused else ()),
            stage="fused" if fused else "eager")
        del rh
    del helmet, hbundle

    # ---- 22. the unrolled integrator: every debug mode on the atrium ----------
    phase("debug modes on the card")
    from vk_raytrace_torch.models import schema as S

    dbg_scene, dbg_cfg = R.prepare_sun_sky(
        scene, RenderConfig(width=DEBUG_W, height=DEBUG_H, max_depth=DEBUG_DEPTH, max_samples=1,
                            pbr_mode=PBR_GLTF, firefly_clamp=10.0, use_sun_sky=True), "cpu")
    for mode in range(S.DEBUG_BASECOLOR, S.DEBUG_HEATMAP + 1):
        mcfg = dataclasses.replace(dbg_cfg, debug_mode=mode)
        rd, *_ = render_phase(f"debug mode {mode} {DEBUG_W}x{DEBUG_H} d{DEBUG_DEPTH}", lambda: R.Renderer(
            dbg_scene, mcfg, device=dev, packed=bundle), card, n=1, want=ATRIUM_KERNELS,
            black_ok=mode == S.DEBUG_EMISSIVE)  # the atrium has no emissive material
        img = rd.hdr().cpu().numpy()
        del rd
        if mode < S.DEBUG_RADIANCE:
            rc = R.Renderer(dbg_scene, dataclasses.replace(mcfg, max_depth=1), device="cpu",
                            packed=bundle)
            rc.step()
            rc.step()  # the card's warm-up and timed frame
            share = float(np.isclose(img, rc.hdr().numpy(), rtol=PIX_RTOL, atol=PIX_ATOL)
                          .all(-1).mean())
            print(f"debug mode {mode}: card (depth {DEBUG_DEPTH}) against the CPU (depth 1): "
                  f"pixels within rtol {PIX_RTOL}/atol {PIX_ATOL}: {share:.5f}", flush=True)
            assert share >= PIX_SHARE, f"debug mode {mode}: only {share:.4f} of pixels agree"

    # ---- 23. the anchor on the card --------------------------------------------
    phase("anchor on the card")
    from vk_raytrace_torch.integrator import brute
    from vk_raytrace_torch.integrator.camera import with_aspect
    from vk_raytrace_torch.integrator.shade import mat_features

    cg, cm, cl, ccam = procedural.cornell_box()
    ng, nm, nl, ncam = procedural.material_test_grid(n=2)
    anchor_cases = (
        ("cornell 64x64", R.build_scene(cg, cm, cl, ccam),
         RenderConfig(width=64, height=64, max_depth=4, max_samples=2, pbr_mode=PBR_GLTF,
                      hdr_multiplier=0.0, rr=False)),
        ("material grid 48x32", R.build_scene(
            ng, nm, nl, ncam, env=hdr.build_environment(np.full((8, 16, 3), 0.8, np.float32))),
         RenderConfig(width=48, height=32, max_depth=3, max_samples=1, hdr_multiplier=1.0,
                      rr=False)),
    )
    for what, asc, acfg in anchor_cases:
        feats = mat_features(asc.materials)
        abundle = build_accel_bundle(asc.geometry).to(dev)
        asc = dataclasses.replace(asc, camera=with_aspect(asc.camera, acfg.width, acfg.height)).to(dev)
        tf.reset_launches()
        t0 = time.perf_counter()
        img_bvh = brute.anchor_render(asc, abundle, acfg, 2, feats).cpu().numpy()
        bvh_s = time.perf_counter() - t0
        lau = {k: v for k, v in tf.LAUNCHES.items() if v}
        assert lau.get("closest", 0) > 0 and lau.get("any", 0) > 0, f"anchor: {lau}"
        t0 = time.perf_counter()
        img_brute = brute.anchor_render(asc, abundle, acfg, 2, feats,
                                        tracer=brute.BruteTracer(asc.geometry)).cpu().numpy()
        brute_s = time.perf_counter() - t0
        ok, share, rmse = brute.images_match(img_bvh, img_brute)
        print(f"anchor {what}: BVH kernels ({bvh_s:.3f} s, launches {lau}) against BruteTracer "
              f"({brute_s:.3f} s) on the card: matched {share:.5f} (>= {brute.MATCH_SHARE}), "
              f"matched-set RMSE {rmse:.5f} (< {brute.MATCH_RMSE}) [{card}]", flush=True)
        assert ok and np.isfinite(img_bvh).all() and img_bvh.mean() > 0.0, f"anchor {what} failed"

    # ---- 24. the CLI at the reference CLI's defaults -----------------------------
    phase("CLI: the atrium at the reference CLI's defaults, a checkpoint, the bistro")
    from vk_raytrace_torch.utils import png as png_mod

    def out(name):
        return os.path.join(work, name)

    atrium_args = ["--scene", "atrium", "--sun-sky", "--size", "1280", "720", "--depth", "10"]
    cli_run("CLI atrium 1280x720 d10 16 spp (Disney)", atrium_args + [
        "--spp", "16", "-o", out("atrium.png"), "--hdr-out", out("atrium.npy")], card,
        want=ATRIUM_KERNELS, stage="eager")
    ck = out("atrium_ck.npz")
    for k in (1, 2):
        cli_run(f"CLI atrium, checkpointed run {k} of 2 (8 spp)", atrium_args + [
            "--spp", "8", "--checkpoint", ck, "-o", out(f"atrium_ck{k}.png"), "--hdr-out",
            out(f"atrium_ck{k}.npy")], card, want=ATRIUM_KERNELS)
    straight, resumed = np.load(out("atrium.npy")), np.load(out("atrium_ck2.npy"))
    assert int(np.load(ck)["frame"]) == 16
    exact = bool(np.array_equal(resumed, straight))
    share = float(np.isclose(resumed, straight, rtol=PIX_RTOL, atol=PIX_ATOL).all(-1).mean())
    print(f"checkpoint: 8 + 8 spp resumed against 16 straight: "
          f"{'bit for bit' if exact else 'NOT bit for bit'}, max |diff| "
          f"{float(np.abs(resumed - straight).max()):.3g}, pixels within rtol {PIX_RTOL}/atol "
          f"{PIX_ATOL}: {share:.5f}", flush=True)
    assert share >= PIX_SHARE, f"checkpoint: only {share:.4f} of pixels agree"
    png_px = png_mod.decode_rgba(open(out("atrium.png"), "rb").read())
    assert png_px.shape == (720, 1280, 4) and np.isfinite(straight).all()
    assert png_px[..., :3].mean() > 5.0 and straight.mean() > 0.0, "CLI atrium: unlit image"
    print(f"atrium.png: {png_px.shape[1]}x{png_px.shape[0]}, mean 8-bit value "
          f"{png_px[..., :3].mean():.2f}, HDR mean {straight.mean():.4f}", flush=True)
    cli_run("CLI bistro 1280x720 d10 4 spp (glTF, fused, two levels)", [
        "--scene", "bistro", "--pbr", "gltf", "--fused-shade", "--sun-sky", "--size", "1280",
        "720", "--depth", "10", "--spp", "4", "-o", out("bistro.png")], card,
        want=("opaque_machine", "alpha_machine", "shade_stage"), stage="fused")
    assert png_mod.decode_rgba(open(out("bistro.png"), "rb").read())[..., :3].mean() > 5.0

    # ---- 25. glTF: quirks.glb baked and two-level --------------------------------
    phase("glTF: quirks.glb")
    from vk_raytrace_torch.models.gltf import load_gltf

    quirks = os.path.join(REPO, "tests", "assets", "quirks.glb")
    cfg_q = RenderConfig(width=128, height=72, max_depth=4, max_samples=1, pbr_mode=PBR_GLTF,
                         firefly_clamp=10.0, use_sun_sky=True)
    for mode, want in (("bake", ATRIUM_KERNELS), ("auto", ("opaque_machine", "alpha_machine"))):
        gq, mq, lq, cq, aq = load_gltf(quirks, instancing=mode)
        if mode == "bake":
            qscene = R.build_scene(gq, mq, lq, cq, atlas=aq)
        else:
            qscene = R.build_instanced_scene(*gq, mq, lq, cq, atlas=aq)
        qscene, q_run = R.prepare_sun_sky(qscene, cfg_q, "cpu")  # one sky for both
        q_imgs, q_rays = {}, {}
        for where in ("cuda", "cpu"):
            tf.reset_launches()
            r = R.Renderer(qscene, q_run, device=where)
            q_rays[where] = []
            for _ in range(2):
                r.step()
                q_rays[where].append(r.last_rays)
            q_imgs[where] = r.accum.cpu().numpy()
            if where == "cuda":
                q_lau = {k: v for k, v in tf.LAUNCHES.items() if v}
        share = float(np.isclose(q_imgs["cuda"], q_imgs["cpu"], rtol=PIX_RTOL, atol=PIX_ATOL)
                      .all(-1).mean())
        ray_rel = abs(sum(q_rays["cuda"]) - sum(q_rays["cpu"])) / sum(q_rays["cpu"])
        print(f"quirks.glb {mode} 128x72 d4: card against CPU, pixels within rtol {PIX_RTOL}/"
              f"atol {PIX_ATOL}: {share:.5f}; rays {q_rays['cuda']} vs {q_rays['cpu']}; card "
              f"launches {q_lau}", flush=True)
        assert np.isfinite(q_imgs["cuda"]).all() and q_imgs["cuda"].mean() > 0.0
        assert share >= PIX_SHARE, f"quirks {mode}: only {share:.4f} of pixels agree"
        assert ray_rel <= RAY_REL, f"quirks {mode}: ray counts differ by {ray_rel:.2e}"
        assert all(q_lau.get(k, 0) > 0 for k in want), f"quirks {mode}: {q_lau}"
    cli_run("CLI quirks.glb 1280x720 d10 16 spp (Disney, two levels)", [
        "-f", quirks, "--size", "1280", "720", "--depth", "10", "--spp", "16", "-o",
        out("quirks.png")], card, want=("opaque_machine", "alpha_machine"), stage="eager")

    # ---- 26. pick on the card and on the CPU --------------------------------------
    phase("pick: the atrium and the bistro, card against CPU")
    pick_cfg = RenderConfig(width=1280, height=720)
    b_pick_scene = R.build_scene(pool.geometry, b_mats, b_lights, b_cam, atlas=b_atlas)
    prng = np.random.default_rng(26)
    for what, psc, packed, want in (("atrium", scene, bundle, ("closest",)),
                                    ("bistro", b_pick_scene, b_inst, ("opaque_machine",))):
        xs, ys = prng.integers(0, 1280, 256), prng.integers(0, 720, 256)
        rc = R.Renderer(psc, pick_cfg, device=dev, packed=packed)
        tf.reset_launches()
        t0 = time.perf_counter()
        card_p = [rc.pick(int(x), int(y)) for x, y in zip(xs, ys)]
        card_s = time.perf_counter() - t0
        lau = {k: v for k, v in tf.LAUNCHES.items() if v}
        t0 = time.perf_counter()
        cpu_p = R.Renderer(psc, pick_cfg, device="cpu", packed=packed).pick_many(xs, ys)
        cpu_s = time.perf_counter() - t0
        hits, ties = check_picks(what, card_p, cpu_p)
        assert hits > 64 and all(lau.get(k, 0) > 0 for k in want), f"pick {what}: {hits}, {lau}"
        print(f"pick {what}: 256 pixels, {hits} hits, {ties} differ by a tie of t; card "
              f"{card_s / 256 * 1e3:.2f} ms a pick (launches {lau}), CPU batch {cpu_s:.2f} s; "
              f"card = CPU [{card}]", flush=True)
        del rc
    del b_pick_scene

    # ---- 27. the scene cache: cold build, warm load ----------------------------------
    phase("scene cache: the atrium's accel cold and warm")
    from vk_raytrace_torch.ops import bvh8

    t0 = time.time()
    fresh = bvh8._build(geom, 16)
    fresh_s = time.time() - t0
    os.environ[scene_cache.ENV] = out("phase27_cache")
    t0 = time.time()
    cold = bvh8.build_accel_bundle(geom)
    cold_s = time.time() - t0
    t0 = time.time()
    warm = bvh8.build_accel_bundle(geom)
    warm_s = time.time() - t0
    entry = os.path.join(out("phase27_cache"), os.listdir(out("phase27_cache"))[0])
    for got in (cold, warm):
        for a, b in ((got.opaque_planar, fresh.opaque_planar),
                     (got.alpha_planar, fresh.alpha_planar)):
            assert np.array_equal(a.rows, b.rows) and a.stack_depth == b.stack_depth
    # The sky: its bake on the card against a load of the same tables.
    cfg_sky = RenderConfig(width=1280, height=720, use_sun_sky=True)
    bake_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        sky_scene, _ = R.prepare_sun_sky(scene, cfg_sky, dev)
        torch.cuda.synchronize()
        bake_s.append(time.time() - t0)
    env = sky_scene.env
    sky = {"image": env.image, "alias": env.accel.alias, "q": env.accel.q, "pdf": env.accel.pdf,
           "alias_pdf": env.accel.alias_pdf, "rows": env.rows}
    sky_np = {k: v.cpu().numpy() for k, v in sky.items()}
    sky_key = scene_cache.content_key("sky-probe", *sky_np.values())
    scene_cache.save(sky_key, **sky_np)
    torch.cuda.synchronize()
    t0 = time.time()
    loaded = {k: torch.from_numpy(v).to(dev) for k, v in scene_cache.load(sky_key).items()}
    torch.cuda.synchronize()
    sky_load_s = time.time() - t0
    assert all(torch.equal(loaded[k], sky[k]) for k in sky)
    print(f"atrium accel: fresh build {fresh_s:.3f} s, cold (build + save) {cold_s:.3f} s, "
          f"warm (load) {warm_s:.3f} s; rows bit-identical to the fresh build; entry "
          f"{os.path.getsize(entry) / 2**20:.1f} MiB. Sun&sky bake on the card "
          f"{bake_s[0]:.4f} s then {bake_s[1]:.4f} s, a load of its tables from the cache with "
          f"the upload {sky_load_s:.4f} s [{card}]", flush=True)
    os.environ[scene_cache.ENV] = os.path.join(work, "scene_cache")

    # ---- 28. the machines beyond 512 instances: the plaza ------------------------
    phase("the machines beyond 512 instances: the plaza, and the bistro padded")
    plaza = out("plaza.gltf")
    t0 = time.time()
    n_nodes = write_plaza(plaza, **PLAZA)
    write_s = time.time() - t0
    t0 = time.time()
    (p_pool, p_inst), p_mats, p_lights, p_cam, p_atlas = load_gltf(plaza, instancing="auto")
    load_s = time.time() - t0
    t0 = time.time()
    p_scene = R.build_instanced_scene(p_pool, p_inst, p_mats, p_lights, p_cam, atlas=p_atlas)
    p_tables_s = time.time() - t0
    p_acc = p_scene.instances.to(dev)
    n_pinst = len(p_inst.mesh_id)
    p_tris = int(np.asarray(p_pool.tri_count)[np.asarray(p_inst.mesh_id)].sum())
    assert n_pinst == n_nodes == 4609 and n_pinst * MACHINE_INST_BYTES > 232448, n_pinst
    assert p_tris >= 500_000 and p_acc.blas_planar_alp is not None, p_tris
    print(f"plaza: {n_pinst} instances of {len(p_pool.tri_start)} meshes, {p_tris} instanced "
          f"triangles ({len(p_pool.geometry.indices)} unique), instance table "
          f"{n_pinst * MACHINE_INST_BYTES} B; glTF written in {write_s:.2f} s "
          f"({os.path.getsize(plaza) / 2**20:.2f} MiB), loaded in {load_s:.2f} s, tables and "
          f"accel {p_tables_s:.2f} s", flush=True)
    psc = p_scene.to(dev)
    p_pack = make_alpha_pack(psc.materials, psc.atlas, psc.geometry.tri_material)
    del psc
    # 2^18 world rays: camera rays at 1280x720 and the shadow rays of their
    # hits toward the sun.
    pcam_dev = with_aspect(p_cam, 1280, 720).to(dev)
    poc, pdc = camera_rays(pcam_dev, 1280, 720, n // 2, rng, dev)
    first, _ = tlas.closest_hit_instanced(p_acc, None, poc, pdc)
    hit_ids = torch.nonzero(first.tri >= 0).squeeze(1)
    hit_ids = hit_ids[torch.arange(n // 2, device=dev) % hit_ids.numel()]
    sun = torch.tensor([0.35, 0.85, 0.4], device=dev)
    sun = sun / sun.norm()
    pso = poc[hit_ids] + pdc[hit_ids] * (first.t[hit_ids] * (1.0 - 1e-4))[:, None]
    po = torch.cat([poc, pso]).contiguous()
    pd = torch.cat([pdc, sun.expand(n // 2, 3)]).contiguous()
    p_inf = torch.full((n,), tf.INF, device=dev)
    p_short = torch.tensor(rng.uniform(1.0, 60.0, n), dtype=torch.float32, device=dev)
    p_seed = torch.tensor(rng.integers(0, 2**32, n), device=dev)
    p_act = torch.ones(n, dtype=torch.bool, device=dev)
    plaza_res, plaza_launch = {}, {}
    for any_hit in (False, True):
        suffix = "_any" if any_hit else ""
        tm = p_short if any_hit else p_inf
        name = f"opaque_machine{suffix}"
        plaza_res[name], plaza_launch[name] = plaza_machine_case(
            f"plaza {name}", p_acc, "opq", None, po, pd, tm, p_seed, p_act, any_hit, card)
        t_o, tri_o = tlas._two_level_opaque_pass(p_acc, "opq", po, pd, tm, p_act, not any_hit,
                                                 any_hit)[:2]
        name = f"alpha_machine{suffix}"
        plaza_res[name], plaza_launch[name] = plaza_machine_case(
            f"plaza {name}", p_acc, "alp", p_pack, po, pd, t_o, p_seed,
            p_act & (tri_o < 0) if any_hit else p_act, any_hit, card)
    # The global path against the shared one: the bistro's table padded with
    # 400 instances outside the mask (root -1), so that it no longer fits.
    oc, dc = camera_rays(bcam_dev, 1920, 1080, n, rng, dev)
    pad = 400
    bsc = bscene32.to(dev)  # the scene's tables do not depend on the row width
    b_pack16 = make_alpha_pack(bsc.materials, bsc.atlas, bsc.geometry.tri_material)
    del bsc
    for what, subset in (("opaque", "opq"), ("alpha", "alp")):
        shared, padded = b_inst.to(dev), b_inst.to(dev)
        box, w2o, root = tlas._machine_tables(padded, subset)
        padded._machine[subset] = (torch.cat([box, box[:1].expand(pad, 6)]).contiguous(),
                                   torch.cat([w2o, w2o[:1].expand(pad, 12)]).contiguous(),
                                   torch.cat([root, torch.full((pad,), -1, dtype=torch.int32,
                                                               device=dev)]).contiguous())
        assert padded._machine[subset][2].shape[0] > tlas._DENSE_I_MAX >= box.shape[0]
        if what == "opaque":
            def run(a):
                return tlas._two_level_opaque_pass(a, subset, oc, dc, t_far[:n], act, True, False)
        else:
            def run(a):
                return tlas._two_level_alpha_pass(a, b_pack16, o_leaf[:n].contiguous(),
                                                  d_leaf[:n].contiguous(), t_far[:n], seed, act,
                                                  False, True)
        a_out, b_out = run(shared), run(padded)
        torch.cuda.synchronize()
        for k, (x, y) in enumerate(zip(a_out, b_out)):
            assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                               y.view(torch.int32) if y.dtype == torch.float32 else y), (
                f"bistro {what} machine: output {k} of the padded (global) table differs")
        ms_shared, ms_padded = tb.cuda_time(lambda: run(shared), 10), tb.cuda_time(
            lambda: run(padded), 10)
        ms_shared2 = tb.cuda_time(lambda: run(shared), 10)
        print(f"bistro {what} machine, closest, {n} rays: the table of {box.shape[0]} instances "
              f"in shared memory {ms_shared:.3f} / {ms_shared2:.3f} ms, padded to "
              f"{box.shape[0] + pad} (global memory) {ms_padded:.3f} ms, difference "
              f"{ms_padded - (ms_shared + ms_shared2) / 2:+.3f} ms; outputs bit for bit equal "
              f"({card})", flush=True)
        del shared, padded
    del first, hit_ids, pso, po, pd, oc, dc, b_pack16

    # ---- 29. the CLI on the plaza ------------------------------------------------
    phase("CLI: the plaza (4,609 instances), card and CPU")
    plaza_args = ["-f", plaza, "--sun-sky", "--size", "1280", "720", "--depth", "10", "--spp",
                  "4"]
    plaza_cli = {}
    plaza_cli["eager"] = cli_run("CLI plaza 1280x720 d10 4 spp (Disney, two levels, 4,609 "
                                 "instances)", plaza_args + ["-o", out("plaza.png")], card,
                                 want=("opaque_machine", "alpha_machine"), stage="eager")
    plaza_cli["fused"] = cli_run("CLI plaza 1280x720 d10 4 spp (glTF, fused)", plaza_args + [
        "--pbr", "gltf", "--fused-shade", "-o", out("plaza_fused.png")], card,
        want=("opaque_machine", "alpha_machine", "shade_stage"), stage="fused")
    for name in ("plaza.png", "plaza_fused.png"):
        assert png_mod.decode_rgba(open(out(name), "rb").read())[..., :3].mean() > 5.0, name
    cfg_p = RenderConfig(width=128, height=72, max_depth=4, max_samples=1, pbr_mode=PBR_GLTF,
                         firefly_clamp=10.0, use_sun_sky=True)
    pq_scene, p_run = R.prepare_sun_sky(p_scene, cfg_p, "cpu")  # one sky for both
    p_imgs, p_rays, p_secs = {}, {}, {}
    for where in ("cuda", "cpu"):
        tf.reset_launches()
        t0 = time.time()
        r = R.Renderer(pq_scene, p_run, device=where)
        p_rays[where] = []
        for _ in range(2):
            r.step()
            p_rays[where].append(r.last_rays)
        p_imgs[where] = r.accum.cpu().numpy()
        p_secs[where] = time.time() - t0
        if where == "cuda":
            p_lau = {k: v for k, v in tf.LAUNCHES.items() if v}
        del r
    share = float(np.isclose(p_imgs["cuda"], p_imgs["cpu"], rtol=PIX_RTOL, atol=PIX_ATOL)
                  .all(-1).mean())
    ray_rel = abs(sum(p_rays["cuda"]) - sum(p_rays["cpu"])) / sum(p_rays["cpu"])
    print(f"plaza 128x72 d4: card against CPU, pixels within rtol {PIX_RTOL}/atol {PIX_ATOL}: "
          f"{share:.5f}; rays {p_rays['cuda']} vs {p_rays['cpu']}; card launches {p_lau}; "
          f"wall card {p_secs['cuda']:.1f} s, CPU {p_secs['cpu']:.1f} s", flush=True)
    assert np.isfinite(p_imgs["cuda"]).all() and p_imgs["cuda"].mean() > 0.0
    assert share >= PIX_SHARE, f"plaza: only {share:.4f} of pixels agree"
    assert ray_rel <= RAY_REL, f"plaza: ray counts differ by {ray_rel:.2e}"
    assert all(p_lau.get(k, 0) > 0 for k in ("opaque_machine", "alpha_machine")), p_lau
    del pq_scene, p_scene

    # ---- 30. the instance-level split: the plaza's foliage alone -----------------
    phase("the instance-level split: the all-alpha plaza, card and CPU")
    from vk_raytrace_torch import cli
    foliage = out("foliage.gltf")
    n_fol = write_plaza(foliage, **PLAZA, ground=False, trunks=False)
    (f_pool, f_inst), f_mats, f_lights, f_cam, f_atlas = load_gltf(foliage, instancing="auto")
    f_scene = R.build_instanced_scene(f_pool, f_inst, f_mats, f_lights, f_cam, atlas=f_atlas)
    f_acc = f_scene.instances.to(dev)
    assert len(f_inst.mesh_id) == n_fol == 2304 and f_acc.blas_planar_opq is None
    assert bool(f_acc.inst_alpha.all())
    fol_args = ["-f", foliage, "--sun-sky", "--size", "128", "72", "--depth", "4", "--spp", "2",
                "--pbr", "gltf"]
    _, fol_lau = cli_run("CLI all-alpha plaza 128x72 d4 2 spp (glTF, 2,304 instances, card)",
                         fol_args + ["-o", out("foliage.png"), "--hdr-out",
                                     out("foliage_card.npy")], card, want=("alpha_machine",))
    assert fol_lau.get("opaque_machine", 0) == 0, fol_lau
    t0 = time.time()
    assert cli.main(fol_args + ["--device", "cpu", "-o", out("foliage_cpu.png"), "--hdr-out",
                                out("foliage_cpu.npy")]) == 0
    fol_cpu_s = time.time() - t0
    fa, fb = np.load(out("foliage_card.npy")), np.load(out("foliage_cpu.npy"))
    share = float(np.isclose(fa, fb, rtol=PIX_RTOL, atol=PIX_ATOL).all(-1).mean())
    print(f"all-alpha plaza CLI 128x72 d4: card against CPU ({fol_cpu_s:.1f} s), pixels within "
          f"rtol {PIX_RTOL}/atol {PIX_ATOL}: {share:.5f}", flush=True)
    assert np.isfinite(fa).all() and fa.mean() > 0.0 and share >= PIX_SHARE, share
    fsc = f_scene.to(dev)
    f_pack = make_alpha_pack(fsc.materials, fsc.atlas, fsc.geometry.tri_material)
    del fsc
    foc, fdc = camera_rays(with_aspect(f_cam, 1280, 720).to(dev), 1280, 720, n, rng, dev)
    for any_hit in (False, True):
        tm = p_short if any_hit else p_inf
        what = "any_hit" if any_hit else "closest_hit"
        # The machine over the full tables against its round loop.
        plaza_machine_case(f"all-alpha plaza alpha_machine{'_any' if any_hit else ''} (full "
                           f"tables)", f_acc, "full_alp", f_pack, foc, fdc, tm, p_seed, p_act,
                           any_hit, card)
        # The entry point: that one launch alone, the same bits.
        tf.reset_launches()
        t0 = time.perf_counter()
        if any_hit:
            occ, k_seed = tlas.any_hit_instanced(f_acc, f_pack, foc, fdc, tm, seed=p_seed)
        else:
            hit, k_seed = tlas.closest_hit_instanced(f_acc, f_pack, foc, fdc, seed=p_seed)
        torch.cuda.synchronize()
        k_s = time.perf_counter() - t0
        lau = {k: v for k, v in tf.LAUNCHES.items() if v}
        assert lau == {"alpha_machine": 1}, lau
        t_a, tri_a, u_a, v_a, i_a, seed_a, st_a = tlas._two_level_alpha_pass(
            f_acc, f_pack, foc, fdc, tm, p_seed, p_act, any_hit, not any_hit, subset="full_alp")
        if any_hit:
            kern, want = (occ, k_seed), (tri_a >= 0, seed_a)
        else:
            kern = (hit.t, hit.tri, hit.u, hit.v, hit.inst, hit.steps, k_seed)
            want = (torch.where(tri_a >= 0, t_a, tf.INF), tri_a, u_a, v_a, i_a, st_a, seed_a)
        for k, (x, y) in enumerate(zip(kern, want)):
            assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                               y.view(torch.int32) if y.dtype == torch.float32 else y), (
                f"all-alpha plaza {what}_instanced: output {k} differs from the machine's")
        print(f"all-alpha plaza {what}_instanced, {n} rays: the alpha machine alone over the "
              f"full tables, one launch, {k_s * 1e3:.2f} ms with the host's share; equal to the "
              f"pass bit for bit; hit or occluded {float((tri_a >= 0).float().mean()):.4f} "
              f"({card})", flush=True)
    del f_acc, f_pack, f_scene, p_acc, p_pack

    # ---- 31-34. the last modules: sharding, the viewer, the graft entry, JPEG ----
    path_launches = last_modules(card, work)

    # ---- 35-38. the wide back end -------------------------------------------
    phase("35. the wide kernel against its plain version on the atrium's camera and shadow rays")
    wide_res, wide_fused_ms = phase_wide_kernel(card, geom, scene, cam, gbundle, rng)
    phase("36. the atrium at 1080p, renderer=wide against renderer=fused")
    wide_launches, wide_atrium = phase_wide_frames(card, scene)
    phase("37. the bistro at 1080p wide against fused, the wide machine against its round loops; "
          "the CLI and the viewer on wide")
    wide_paths = {}
    wide_paths["bistro"], machine_wide_res, wide_bistro = phase_wide_bistro(
        card, pool, inst, b_mats, b_lights, b_cam, b_atlas, rng)
    _, wide_paths["cli"] = cli_run(
        "CLI --renderer wide: the atrium at the reference CLI's defaults",
        ["--scene", "atrium", "--sun-sky", "--renderer", "wide", "-o",
         os.path.join(work, "atrium_wide.png")], card, want=("traverse_wide",))
    assert not any(wide_paths["cli"].get(k) for k in ATRIUM_KERNELS), wide_paths["cli"]
    wide_paths["viewer"] = phase_wide_viewer(card)
    phase("38. the plaza (4,609 instances): the wide machine's global table against its round "
          "loops")
    plaza_wide_res, plaza_fused_ms = phase_wide_plaza(card, plaza, rng)

    # ---- 39. the pooled wavefront's loop and its two kernels ----------------
    phase("39. the wavefront loop: vkrt_regenerate and vkrt_retire against their plain "
          "versions on a 1080p frame's pools; frames through the kernels and the plain "
          "versions; host reads and launches a frame")
    regen_res, retire_res, loop_res = phase_wavefront(
        card, scene, cfg, bundle, (pool, inst, b_mats, b_lights, b_cam, b_atlas))

    # ---- 40. the alpha pass's root prefilter ---------------------------------
    phase("40. vkrt_root_prefilter against its plain version at widths 16 and 32: a 1080p "
          "frame's alpha passes and the synthetic ray sets")
    prefilter_res = phase_prefilter(card, scene, cfg, {16: bundle, 32: bundle32}, rng)

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
        if replaces == REPLACES and m in tf.MODES:
            # The launches of phases 31-34's paths (rank 0 for the gloo ranks).
            entry["paths_launches"] = {p: v.get(m, 0) for p, v in path_launches.items()}
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
        entry = {"name": key, "route": "cuda", "source": SOURCE,
                 "replaces": replaces, "launches": lau[key], "max_abs_err": err,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": None}
        if key == "alpha_rounds":  # the launches of phases 31-34's paths
            entry["paths_launches"] = {p: v.get(key, 0) for p, v in path_launches.items()}
        if key in plaza_res:
            # Beyond 512 instances (phase 28, closest hit; the table in
            # global memory) and the launches of phase 29's CLI runs.
            _, (p_ms, p_plain_ms), (p_b_ms, p_b_by) = plaza_res[key]
            entry["plaza"] = {"ms": p_ms, "plain_ms": p_plain_ms, "bound_ms": p_b_ms,
                              "bound_by": p_b_by,
                              "launches": {k: v[1].get(key, 0) for k, v in plaza_cli.items()}}
        kernels.append(entry)
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
    err, (ms, plain_ms), (b_ms, b_by), _ = wide_res["closest"]
    kernels.append({
        "name": "traverse_wide", "route": "cuda", "source": WIDE_SOURCE,
        "replaces": WIDE_REPLACES, "replaces_kind": WIDE_REPLACES_KIND,
        "launches": wide_launches["traverse_wide"],
        "max_abs_err": max(v[0] for v in wide_res.values()), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "cases": {k: {"ms": v[1][0], "plain_ms": v[1][1], "bound_ms": v[2][0],
                      "bound_by": v[2][1], "fused_ms": wide_fused_ms.get(k)}
                  for k, v in wide_res.items()},
        "per_frame": {"atrium": wide_atrium},
        "paths_launches": {p: v.get("traverse_wide", 0) for p, v in wide_paths.items()},
    })
    err, (ms, plain_ms), (b_ms, b_by) = machine_wide_res["closest"]
    kernels.append({
        "name": "wide_machine", "route": "cuda", "source": WIDE_SOURCE,
        "replaces": WIDE_MACHINE_REPLACES, "replaces_kind": WIDE_MACHINE_REPLACES_KIND,
        "launches": wide_paths["bistro"]["wide_machine"],
        "max_abs_err": max(v[0] for v in machine_wide_res.values()), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "cases": {k: {"ms": v[1][0], "plain_ms": v[1][1], "bound_ms": v[2][0],
                      "bound_by": v[2][1]} for k, v in machine_wide_res.items()},
        "plaza": {k: {"ms": v[1][0], "plain_ms": v[1][1], "bound_ms": v[2][0],
                      "bound_by": v[2][1]} for k, v in plaza_wide_res.items()},
        "plaza_fused_ms": plaza_fused_ms,
        "per_frame": {"bistro": wide_bistro},
        "paths_launches": {p: v.get("wide_machine", 0) for p, v in wide_paths.items()},
    })
    for name, res, replaces, lau in (("regenerate", regen_res, REGEN_REPLACES, launches),
                                     ("retire", retire_res, RETIRE_REPLACES, launches)):
        # Times and bound: the full pool's first regenerating case (iteration
        # 2); every case in "cases".
        ms, plain_ms, (b_ms, b_by), *_ = next(
            (v for k, v in res.items() if k.startswith("iteration 2,")), next(iter(res.values())))
        kernels.append({
            "name": name, "route": "cuda", "source": WAVEFRONT_SOURCE, "replaces": replaces,
            "replaces_kind": WAVEFRONT_REPLACES_KIND, "launches": lau[name],
            "max_abs_err": max(v[-1] for v in res.values()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "cases": {k: {"ms": v[0], "plain_ms": v[1], "bound_ms": v[2][0], "bound_by": v[2][1]}
                      for k, v in res.items()},
            "per_frame": {k: v["launches"].get(name, 0) for k, v in loop_res.items()},
            "host_reads": {k: v["host_reads"] for k, v in loop_res.items()},
        })
    for key, lau, (res, synth_err, fold) in (("root_prefilter", launches, prefilter_res[16]),
                                             ("root_prefilter_w32", w_launches,
                                              prefilter_res[32])):
        # Times and bound: iteration 2's closest pass (the full pool); the
        # frame's passes in "cases"; the error over every case.
        ms, plain_ms, (b_ms, b_by), *_ = next(
            v for k, v in res.items() if k.startswith("iteration 2, closest"))
        entry = {
            "name": key, "route": "cuda", "source": SOURCE, "replaces": PREFILTER_REPLACES,
            "replaces_kind": PREFILTER_REPLACES_KIND, "launches": lau[key],
            "max_abs_err": max([synth_err] + [v[-1] for v in res.values()]), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "cases": {k: {"ms": v[0], "plain_ms": v[1], "bound_ms": v[2][0], "bound_by": v[2][1],
                          "need": v[4]} for k, v in res.items()},
            # Folded into the alpha rounds' ray intake: the pass's two forms
            # (prefilter then rounds, the rounds alone), each timed.
            "folded_into": key.replace("root_prefilter", "alpha_rounds"),
            "fold": fold,
        }
        if key == "root_prefilter":  # the launches of phases 31-34's paths
            entry["paths_launches"] = {p: v.get(key, 0) for p, v in path_launches.items()}
        kernels.append(entry)
    print(f"phases 1-40 passed in {time.time() - T_START:.1f} s [{card}]", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
