#!/usr/bin/env python3
"""Time the traversal kernels of several checkouts on one GPU.

    python3 chip_ab.py [--atrium | --capped | --rounds | --standalone] PARENT CHANGE CHANGE PARENT ...
    python3 chip_ab.py --ptx PARENT CHANGE

Each argument is the root of a checkout (for example a ``git archive`` of
the parent commit unpacked into a git-ignored directory). Each runs in its
own process, in the order given, so alternate them. A process builds that
checkout's kernels (``chip_smoke.build_kernels``), takes ``chip_smoke.py``'s
phase-3 ray sets (2^18 rays on the full atrium, seed 1234) and prints, at
row widths 16 and 32, per mode a/b/c, for the capped entry (closest hit
stopped after 8 nodes, on the mode-a rays) and for the single-level alpha
rounds through ``traverse_alpha._rounds`` (phase 18's cases: the mode-c
rays toward the banners, closest windowed by their opaque hit and any
hit over the mode-b windows, 95% of rays active, with the alpha pack; the
rounds on the need mask) and for the whole alpha pass through
``traverse_alpha._alpha_rounds`` on the same rays (its need line and
rounds: the prefilter's launch and the rounds' where a checkout has both,
the rounds alone where their intake runs the line), the least and the
median of three means of 50 launches (CUDA events), in ms; then
``vkrt_retire`` on the pools of a 1080p fused atrium frame (phase 39's:
iteration 0's fresh pool of 2^18 lanes, iteration 2's full one): the
mean of 10 launches on fresh copies (read from HBM, queued behind a
device sleep), the least and the median of three such means, unchecked (``chip_smoke.py`` phase 39 holds
the kernel to its plain version; a variant here may break it on purpose);
then the same for the two
round machines (10 launches a mean) on the full bistro at widths 16 and
32, closest hit with culling and any hit without (the opaque machine over
the opaque subsets on 2^18 camera rays, phase 19's; the alpha machine over
the alpha subsets on 2^18 rays toward the foliage, phase 17's), and on the
plaza at width 16 (phase 28's 2^18 world rays; the instance table in
global memory); then the wide back end through the calls every checkout
has: ``traverse_wide`` on the atrium's 8-wide trees (closest and any hit
over the opaque tree on the mode a/b rays, closest over the alpha tree
with the pack toward the banners, and any over it with a tenth of those
rays active) and the bistro's two-level wide calls
(``closest_hit_instanced(..., backend="wide")`` with the pack on the
camera rays and on the rays toward the foliage: an opaque and an alpha
pass each, per-round launches and host syncs where a checkout has no
machine; 3 calls a mean). Last, a line per checkout with ptxas's report
(registers, stack frame, spill) of each round machine (the single-level
alpha rounds too) and a/b instantiation of its traversal libraries. The
card's name and power limit come first. ``--atrium`` times the atrium's kernels alone (modes a/b/c, the
capped entry, the alpha rounds) and skips the bistro, the plaza and the
wide back end. ``--capped`` times the traversal micro-bench's kernels
alone (``vk_raytrace_torch.travbench``'s rays: 524,288 camera rays of the
full atrium): mode a to termination, the capped entry at 8 and 24 nodes
and its no-gather variant at 8 and 24, at widths 16 and 32, the least and
the median of three means of 20 launches, with the capped kernels'
resident blocks an SM and ptxas's report of the capped entry's
instantiations. ``--rounds`` times the per-round traversal entry
(``vkrt_traverse``) alone and the plain round loops that drive it: mode c
from the root on phase 3's rays toward the atrium's banners (2^18 rays,
culling on and off), and modes a/b/c with per-lane roots on phases 8 and
12's rays (2^18 bistro camera rays at each mode's first instance
candidate, the opaque subsets for a/b; rays toward the foliage over the
alpha subsets for c), at widths 16 and 32, the least and the median of
three means of 20 launches; then the round loops of phases 17-19 on the
card (``tlas._alpha_rounds`` toward the foliage, ``traverse_alpha.
_rounds_core`` toward the banners, ``tlas._two_level_pass`` over the
opaque subsets on camera rays; closest and any hit, both widths), the
least and the median of three means of 2 calls (CUDA events: the wall
with the loops' host syncs) and the device-busy ms of one traced call;
with ptxas's report of each per-round instantiation. ``--standalone``
times the two kernels that no path launches, the body alone
(``vkrt_shade``) and the standalone root prefilter
(``vkrt_root_prefilter``), on phases 6, 10 and 40's inputs (the least and
the median of three means of 20 launches; :func:`time_standalone`), with
ptxas's report of their instantiations, and holds every checkout's
outputs equal to the first's bit for bit. ``--ptx PARENT CHANGE``
compiles ``csrc/traverse.cu`` of both checkouts to PTX at widths 16 and
32, and ``csrc/shade.cu`` once, with the build's arithmetic flags and
says, for each a/b, capped, per-round, round machine, single-level rounds
and shading stage kernel, whether its PTX is the same with line
directives, labels, register numbers and mangled names masked. Variants
of a kernel (a copy of a checkout with an edited source) compare as
checkouts.
"""

import os
import subprocess
import sys
import time

REPS, ROUNDS = 50, 3


def time_tree(tree, atrium_only=False):
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from vk_raytrace_torch import travbench as tb
    from vk_raytrace_torch.integrator.camera import with_aspect
    from vk_raytrace_torch.models import procedural
    from vk_raytrace_torch.ops import traverse_fused as tf
    from vk_raytrace_torch.ops.bvh8 import build_accel_bundle

    dev = torch.device("cuda")
    t_start = time.time()
    cs.build_kernels()
    spent = {"build": time.time() - t_start}
    geom, a_mats, a_lights, cam, a_atlas = procedural.atrium_scene()
    n = 1 << 18
    o, d, inf, t_short, oa, da, a_pack, r_seed, r_act = atrium_sets(
        cs, (geom, a_mats, a_lights, cam, a_atlas), n, dev)
    from vk_raytrace_torch import render as R
    from vk_raytrace_torch.ops import traverse_alpha as ta
    from vk_raytrace_torch.ops.traverse_wide import make_alpha_pack

    def rounds(planar, t_lim, cull):
        need = r_act & (t_lim > 0.0) & tf.root_prefilter(planar, oa, da, t_lim)
        return lambda: ta._rounds(planar, a_pack, oa, da, t_lim, r_seed, need, cull)

    out = []
    for width in (16, 32):
        g = build_accel_bundle(geom, width=width).to(dev)
        t_open = tf.closest_hit_fused(g.opaque_planar, oa, da).t
        cases = {
            "closest": lambda: tf.traverse(g.opaque_planar, o, d, inf, mode="closest", cull=True),
            "any": lambda: tf.traverse(g.opaque_planar, o, d, t_short, mode="any", cull=False),
            "candidate": lambda: tf.traverse(g.alpha_planar, oa, da, inf, mode="candidate",
                                             cull=True),
            "capped8": lambda: tf.traverse_capped(g.opaque_planar, o, d, inf, 8),
            "alpha_rounds": rounds(g.alpha_planar, t_open, True),
            "alpha_rounds_any": rounds(g.alpha_planar, t_short, False),
            "alpha_pass": lambda: ta._alpha_rounds(g.alpha_planar, a_pack, oa, da, t_open,
                                                   r_seed, r_act, True),
            "alpha_pass_any": lambda: ta._alpha_rounds(g.alpha_planar, a_pack, oa, da, t_short,
                                                       r_seed, r_act, False),
        }
        for name, fn in cases.items():
            ms = [tb.cuda_time(fn, REPS) for _ in range(ROUNDS)]
            out.append(f"w{width} {name} {min(ms):.4f}/{float(np.median(ms)):.4f}")
        del g
    spent["traversal"] = time.time() - t_start - sum(spent.values())
    out += retire_times(cs, R, geom, a_mats, a_lights, cam, a_atlas, dev)
    spent["retire"] = time.time() - t_start - sum(spent.values())
    if atrium_only:
        print(os.path.basename(tree), " ".join(out), flush=True)
        print(os.path.basename(tree), "seconds:", {k: round(v, 1) for k, v in spent.items()},
              flush=True)
        print(os.path.basename(tree), "ptxas:", "; ".join(machine_ptxas(tree)), flush=True)
        return
    from vk_raytrace_torch.ops import tlas

    pool, inst, mats, lights, b_cam, atlas = procedural.bistro_scene()
    bs_host = R.build_instanced_scene(pool, inst, mats, lights, b_cam, atlas=atlas)
    bs = bs_host.to(dev)
    acc = bs.instances
    pack = make_alpha_pack(bs.materials, bs.atlas, bs.geometry.tri_material)
    ob, db = cs.camera_rays(with_aspect(b_cam, 1920, 1080).to(dev), 1920, 1080, n, rng, dev)
    leaf = np.nonzero(np.asarray(acc.inst_alpha.cpu()))[0]
    eye = np.asarray(b_cam.view_inverse)[:3, 3]
    ol, dl = cs.rays_toward_instances(rng, pool, inst, rng.choice(leaf, n),
                                      eye + rng.uniform(-2.0, 2.0, (n, 3)), dev)
    act = torch.ones(n, dtype=torch.bool, device=dev)
    seed = torch.tensor(rng.integers(0, 2**32, n), device=dev)
    t_long = torch.tensor(rng.uniform(1.0, 60.0, n), dtype=torch.float32, device=dev)
    accs = {16: acc, 32: R.build_instanced_scene(pool, inst, mats, lights, b_cam, atlas=atlas,
                                                 width=32).instances.to(dev)}
    machines = {}
    for width, a in accs.items():
        for any_hit in (False, True):
            kind = "any" if any_hit else "closest"
            machines[f"bistro w{width} opaque_machine {kind}"] = (
                lambda a=a, h=any_hit: tlas._two_level_opaque_pass(
                    a, "opq", ob, db, t_short if h else inf, act, not h, h))
            machines[f"bistro w{width} alpha_machine {kind}"] = (
                lambda a=a, h=any_hit: tlas._two_level_alpha_pass(
                    a, pack, ol, dl, t_long if h else inf, seed, act, h, not h))
    machines.update(plaza_machines(cs, tlas, dev, rng, n, inf, t_long, seed, act))
    for name, fn in machines.items():
        ms = [tb.cuda_time(fn, 10) for _ in range(ROUNDS)]
        out.append(f"{name} {min(ms):.4f}/{float(np.median(ms)):.4f}")
    from vk_raytrace_torch.ops import bvh8
    from vk_raytrace_torch.ops import traverse_wide as tw

    opq, alp = (w.to(dev) for w in bvh8.build_wide(geom))
    sparse = torch.tensor(rng.random(n) < 0.1, device=dev)
    wide = {
        "closest": lambda: tw.traverse_wide(opq, None, o, d, inf),
        "any": lambda: tw.traverse_wide(opq, None, o, d, t_short, any_hit=True),
        "alpha_banners": lambda: tw.traverse_wide(alp, a_pack, oa, da, inf, seed),
        "alpha_any_sparse": lambda: tw.traverse_wide(alp, a_pack, oa, da, t_short, seed, sparse,
                                                     any_hit=True),
    }
    for name, fn in wide.items():
        ms = [tb.cuda_time(fn, REPS) for _ in range(ROUNDS)]
        out.append(f"wide {name} {min(ms):.4f}/{float(np.median(ms)):.4f}")
    acc_w = tlas.with_wide(bs_host.instances, bs_host.geometry).to(dev)
    two_level = {
        "camera": lambda: tlas.closest_hit_instanced(acc_w, pack, ob, db, seed=seed,
                                                     backend="wide"),
        "foliage": lambda: tlas.closest_hit_instanced(acc_w, pack, ol, dl, seed=seed,
                                                      backend="wide"),
    }
    for name, fn in two_level.items():
        ms = [tb.cuda_time(fn, 3) for _ in range(ROUNDS)]
        out.append(f"bistro wide {name} {min(ms):.4f}/{float(np.median(ms)):.4f}")
    print(os.path.basename(tree), " ".join(out), flush=True)
    print(os.path.basename(tree), "ptxas:", "; ".join(machine_ptxas(tree)), flush=True)


def atrium_sets(cs, scene, n, dev):
    """``chip_smoke.py``'s phase-3 ray sets on the atrium ``scene`` (seed
    1234): camera and random rays (o, d), windows INF and 0.5 to 20, rays
    toward the banners (oa, da); and the alpha pack with the rounds' seeds
    and 95% active mask (seed 18, so the rounds' draws leave the other rays
    as they were)."""
    import numpy as np
    import torch

    from vk_raytrace_torch import render as R
    from vk_raytrace_torch.integrator.camera import with_aspect
    from vk_raytrace_torch.ops import traverse_fused as tf
    from vk_raytrace_torch.ops.traverse_wide import make_alpha_pack

    geom, _, _, cam, _ = scene
    rng = np.random.default_rng(1234)
    oc, dc = cs.camera_rays(with_aspect(cam, 1920, 1080).to(dev), 1920, 1080, n // 2, rng, dev)
    orr, drr = cs.random_rays(rng, np.asarray(geom.positions), n // 2, dev)
    o, d = torch.cat([oc, orr]).contiguous(), torch.cat([dc, drr]).contiguous()
    inf = torch.full((n,), tf.INF, device=dev)
    t_short = torch.tensor(rng.uniform(0.5, 20.0, n), dtype=torch.float32, device=dev)
    oa, da = cs.rays_at(rng, geom, np.where(np.asarray(geom.tri_flags) & 2)[0], n, dev)
    sc = R.build_scene(*scene[:4], atlas=scene[4]).to(dev)
    pack = make_alpha_pack(sc.materials, sc.atlas, sc.geometry.tri_material)
    r_rng = np.random.default_rng(18)
    seed = torch.tensor(r_rng.integers(0, 2**32, n), device=dev)
    act = torch.tensor(r_rng.random(n) < 0.95, device=dev)
    return o, d, inf, t_short, oa, da, pack, seed, act


def retire_times(cs, R, geom, mats, lights, cam, atlas, dev):
    """``vkrt_retire`` on phase 39's pools of a 1080p fused atrium frame
    (iteration 0: a fresh 2^18-lane pool; iteration 2: a full one): three
    means of 10 launches, each on a fresh copy of the pool. Returns its
    output words."""
    import numpy as np
    import torch

    from vk_raytrace_torch.integrator import pool as wp
    from vk_raytrace_torch.models.schema import PBR_GLTF, RenderConfig

    cfg = RenderConfig(width=1920, height=1080, max_depth=4, max_samples=1, pbr_mode=PBR_GLTF,
                       firefly_clamp=10.0, use_sun_sky=True)
    r = R.Renderer(R.build_scene(geom, mats, lights, cam, atlas=atlas), cfg, device=dev,
                   fused_shade=True)
    r.render_frame(0)
    _, retire = cs.capture_states(r, 1)
    del r
    out = []
    for label, (st0, b, ctrl0, sl) in retire:
        it = label.split(",")[0]
        if it not in ("iteration 0", "iteration 2"):
            continue
        n = st0["active"].shape[0]

        def fresh():
            return ({k: v.clone() for k, v in st0.items()}, b, ctrl0.clone(),
                    torch.zeros(sl.total_units + n, 3, device=dev),
                    torch.zeros(sl.n_pix + 1, dtype=torch.int32, device=dev), sl)

        ms = []
        for _ in range(3):
            pools = [fresh() for _ in range(11)]  # alive while their launches run
            ms.append(cs.events_ms([lambda x=wp.retire_args(*p): wp.launch("retire", x)
                                    for p in pools], queue=True))
        out.append(f"retire {it.replace(' ', '')} {min(ms):.4f}/{float(np.median(ms)):.4f}")
    del retire
    torch.cuda.empty_cache()
    return out


def plaza_machines(cs, tlas, dev, rng, n, inf, t_long, seed, act):
    """``chip_smoke.py``'s phase 28: the plaza (4,609 instances, the
    machines' instance table in global memory) and its 2^18 world rays
    (camera rays at 1280x720 and their hits' shadow rays toward the sun);
    the opaque and the alpha machine, closest and any hit, as calls."""
    import tempfile

    import torch

    from vk_raytrace_torch import render as R
    from vk_raytrace_torch.integrator.camera import with_aspect
    from vk_raytrace_torch.models.gltf import load_gltf
    from vk_raytrace_torch.ops.traverse_wide import make_alpha_pack

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "plaza.gltf")
        cs.write_plaza(path, **cs.PLAZA)
        (pool, inst), mats, lights, cam, atlas = load_gltf(path, instancing="auto")
    sc = R.build_instanced_scene(pool, inst, mats, lights, cam, atlas=atlas).to(dev)
    acc = sc.instances
    pack = make_alpha_pack(sc.materials, sc.atlas, sc.geometry.tri_material)
    oc, dc = cs.camera_rays(with_aspect(cam, 1280, 720).to(dev), 1280, 720, n // 2, rng, dev)
    first, _ = tlas.closest_hit_instanced(acc, None, oc, dc)
    hit = torch.nonzero(first.tri >= 0).squeeze(1)
    hit = hit[torch.arange(n // 2, device=dev) % hit.numel()]
    sun = torch.tensor([0.35, 0.85, 0.4], device=dev)
    sun = sun / sun.norm()
    o = torch.cat([oc, oc[hit] + dc[hit] * (first.t[hit] * (1.0 - 1e-4))[:, None]]).contiguous()
    d = torch.cat([dc, sun.expand(n // 2, 3)]).contiguous()
    out = {}
    for h in (False, True):
        kind = "any" if h else "closest"
        out[f"plaza opaque_machine {kind}"] = lambda h=h: tlas._two_level_opaque_pass(
            acc, "opq", o, d, t_long if h else inf, act, not h, h)
        out[f"plaza alpha_machine {kind}"] = lambda h=h: tlas._two_level_alpha_pass(
            acc, pack, o, d, t_long if h else inf, seed, act, h, not h)
    return out


def time_capped(tree):
    """``--capped``: travbench's traversal variants in checkout ``tree``."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from vk_raytrace_torch import travbench as tb
    from vk_raytrace_torch.models import procedural
    from vk_raytrace_torch.ops import traverse_fused as tf
    from vk_raytrace_torch.ops.bvh8 import build_accel_bundle

    dev = torch.device("cuda")
    cs.build_kernels()
    geom, _, _, cam, _ = procedural.atrium_scene()
    o, d = tb.camera_rays(cam, tb.RAYS, dev)
    inf = torch.full((tb.RAYS,), tf.INF, device=dev)
    out = []
    for width in (16, 32):
        planar = build_accel_bundle(geom, width=width).opaque_planar.to(dev)
        own = tf.own_rows(planar, tb.RAYS)
        cases = {"full": lambda: tf.traverse(planar, o, d, inf, mode="closest", cull=True)}
        for cap in (8, 24):
            cases[f"capped{cap}"] = lambda c=cap: tf.traverse_capped(planar, o, d, inf, c)
            cases[f"nogather{cap}"] = lambda c=cap: tf.traverse_capped(own, o, d, inf, c,
                                                                       nogather=True)
        for name, fn in cases.items():
            ms = [tb.cuda_time(fn, 20) for _ in range(ROUNDS)]
            out.append(f"w{width} {name} {min(ms):.4f}/{float(np.median(ms)):.4f}")
        out.append(f"w{width} blocks/SM " + ",".join(  # resident, of each capped kernel
            f"{'nogather' if ng else 'capped'}{cap}:{tf.capped_occupancy(width, cap, ng)}"
            for cap in (8, 24) for ng in (False, True)))
        del planar, own
    print(os.path.basename(tree), " ".join(out), flush=True)
    print(os.path.basename(tree), "ptxas:", "; ".join(machine_ptxas(tree, capped=True)),
          flush=True)


def time_rounds(tree):
    """``--rounds``: the per-round entry and the round loops in checkout
    ``tree``."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import numpy as np
    import torch

    import chip_profile
    import chip_smoke as cs
    from vk_raytrace_torch import render as R
    from vk_raytrace_torch import travbench as tb
    from vk_raytrace_torch.integrator.camera import with_aspect
    from vk_raytrace_torch.models import procedural
    from vk_raytrace_torch.ops import tlas
    from vk_raytrace_torch.ops import traverse_alpha as ta
    from vk_raytrace_torch.ops import traverse_fused as tf
    from vk_raytrace_torch.ops.bvh8 import build_accel_bundle
    from vk_raytrace_torch.ops.traverse_wide import make_alpha_pack

    dev = torch.device("cuda")
    cs.build_kernels()
    scene = procedural.atrium_scene()
    geom = scene[0]
    n = 1 << 18
    _, _, inf, t_short, oa, da, a_pack, seed, act = atrium_sets(cs, scene, n, dev)
    kernels, loops = {}, {}
    for width in (16, 32):
        g = build_accel_bundle(geom, width=width).to(dev)
        t_open = tf.closest_hit_fused(g.opaque_planar, oa, da).t
        for cull in (True, False):
            kernels[f"w{width} candidate{'' if cull else '_nocull'}"] = (
                lambda g=g, c=cull: tf.traverse(g.alpha_planar, oa, da, inf, mode="candidate",
                                                cull=c))
        for any_hit, t_lim in ((False, t_open), (True, t_short)):
            need = act & (t_lim > 0.0) & tf.root_prefilter(g.alpha_planar, oa, da, t_lim)
            loops[f"w{width} rounds_loop{'_any' if any_hit else ''}"] = (
                lambda g=g, t=t_lim, nd=need, c=not any_hit: ta._rounds_core(
                    g.alpha_planar, a_pack, oa, da, t, seed, nd, c))
    pool, inst, mats, lights, b_cam, atlas = procedural.bistro_scene()
    b_rng = np.random.default_rng(8)
    ob, db = cs.camera_rays(with_aspect(b_cam, 1920, 1080).to(dev), 1920, 1080, n, b_rng, dev)
    leaf = None
    t_near = torch.tensor(b_rng.uniform(0.5, 20.0, n), dtype=torch.float32, device=dev)
    t_long = torch.tensor(b_rng.uniform(1.0, 60.0, n), dtype=torch.float32, device=dev)
    for width in (16, 32):
        sc = R.build_instanced_scene(pool, inst, mats, lights, b_cam, atlas=atlas,
                                     width=width).to(dev)
        acc = sc.instances
        if leaf is None:
            pack = make_alpha_pack(sc.materials, sc.atlas, sc.geometry.tri_material)
            leaf = np.nonzero(np.asarray(acc.inst_alpha.cpu()))[0]
            eye = np.asarray(b_cam.view_inverse)[:3, 3]
            ol, dl = cs.rays_toward_instances(b_rng, pool, inst, b_rng.choice(leaf, n),
                                              eye + b_rng.uniform(-2.0, 2.0, (n, 3)), dev)
        for mode, subset, o, d, tm, cull in (("closest", "opq", ob, db, inf, True),
                                             ("any", "opq", ob, db, t_near, False),
                                             ("candidate", "alp", ol, dl, inf, True)):
            planar = getattr(acc, f"blas_planar_{subset}")
            oo, dd, tt, root0, _ = cs.first_candidates(acc, subset, o, d, tm, n)
            kernels[f"w{width} {mode}_roots"] = (
                lambda p=planar, a=(oo, dd, tt), m=mode, c=cull, r0=root0: tf.traverse(
                    p, *a, mode=m, cull=c, root0=r0))
        for any_hit in (False, True):
            kind = "_any" if any_hit else ""
            loops[f"w{width} alpha_loop{kind}"] = (
                lambda a=acc, h=any_hit: tlas._alpha_rounds(
                    a, pack, ol, dl, t_long if h else inf, seed, act, h, not h))
            planar, roots, view, mask = tlas._subset(acc, "opq")
            loops[f"w{width} opaque_loop{kind}"] = (
                lambda p=(planar, roots, view), m=mask, h=any_hit: tlas._two_level_pass(
                    *p, ob, db, t_near if h else inf, act, m, not h, h))
    out = []
    for name, fn in kernels.items():
        ms = [tb.cuda_time(fn, 20) for _ in range(ROUNDS)]
        out.append(f"{name} {min(ms):.4f}/{float(np.median(ms)):.4f}")
    for name, fn in loops.items():
        ms = [tb.cuda_time(fn, 2) for _ in range(ROUNDS)]
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        busy = chip_profile.busy_us(chip_profile.device_events(prof)[0]) / 1e3
        out.append(f"{name} {min(ms):.2f}/{float(np.median(ms)):.2f} wall, {busy:.3f} busy")
    print(os.path.basename(tree), " ".join(out), flush=True)
    print(os.path.basename(tree), "ptxas:", "; ".join(machine_ptxas(tree, rounds=True)),
          flush=True)


def time_standalone(tree, out_dir):
    """``--standalone``: the two kernels no path launches, in checkout
    ``tree``: the body alone (``vkrt_shade``) on phase 6's and phase 10's
    inputs (2^18 atrium and bistro camera hits through ``shade_inputs``,
    single-level and instanced), the least and the median of three means of
    20 launches; the standalone root prefilter (``vkrt_root_prefilter``) on
    phase 40's inputs (a 1080p fused atrium frame's closest and shadow
    passes at iterations 0 and 2, widths 16 and 32), the least and the
    median of three means of 20 launches on fresh copies queued behind a
    device sleep. Every output (the timed sets, phases 6 and 10's
    every-branch sets and phase 40's synthetic ray sets) goes to
    ``out_dir`` for :func:`same_outputs`."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    import chip_smoke as cs
    from vk_raytrace_torch import render as R
    from vk_raytrace_torch import travbench as tb
    from vk_raytrace_torch.integrator import shade_fused as sf
    from vk_raytrace_torch.integrator.camera import with_aspect
    from vk_raytrace_torch.integrator.path import pixel_spread
    from vk_raytrace_torch.models import procedural
    from vk_raytrace_torch.models.schema import PBR_GLTF, RenderConfig
    from vk_raytrace_torch.ops import tlas
    from vk_raytrace_torch.ops import traverse_fused as tf
    from vk_raytrace_torch.ops.bvh8 import build_accel_bundle

    dev = torch.device("cuda")
    with ThreadPoolExecutor(3) as pool:
        for f in [pool.submit(sf.build), *(pool.submit(tf.build, w) for w in tf.WIDTHS)]:
            f.result()
    n = 1 << 18
    outs, times = {}, []

    def shade_sets(label, r, hit, oc, dc, rng, instances=None):
        cfg = r._run_cfg
        seed = torch.tensor(rng.integers(0, 2**32, n), device=dev)
        zeros3 = torch.zeros(n, 3, device=dev)
        x = sf.shade_inputs(r.scene, r.features, cfg.full_mis, 0.5, cfg.hdr_multiplier, hit, oc,
                            dc, seed, None, zeros3, torch.ones(n, 3, device=dev), zeros3,
                            torch.zeros(n, device=dev), instances=instances,
                            sun_disk=cfg.sun_disk,
                            mip=(pixel_spread(r.scene, 1080), torch.clamp(hit.t, max=1e30)))
        real = (x.srow, x.taps, x.aux, x.flags)
        sets = {"camera": real, **{f"every_branch_mis{int(m)}": cs.every_branch(x, rng, m)
                                   for m in (True, False)}}
        for what, args in sets.items():
            outs[f"{label} {what}"] = [y.cpu() for y in sf.shade(*args)]
        ms = [tb.cuda_time(lambda: sf.shade(*real), 20) for _ in range(ROUNDS)]
        times.append(f"{label} {min(ms):.4f}/{float(np.median(ms)):.4f}")

    scene = procedural.atrium_scene()
    geom, mats, lights, cam, atlas = scene
    bundles = {w: build_accel_bundle(geom, width=w) for w in tf.WIDTHS}
    a_scene = R.build_scene(geom, mats, lights, cam, atlas=atlas)
    cfg = RenderConfig(width=1920, height=1080, max_depth=4, max_samples=1, pbr_mode=PBR_GLTF,
                       firefly_clamp=10.0, use_sun_sky=True)
    rng = np.random.default_rng(1234)
    r = R.Renderer(a_scene, cfg, device=dev, packed=bundles[16], fused_shade=True)
    oc, dc = cs.camera_rays(with_aspect(cam, 1920, 1080).to(dev), 1920, 1080, n, rng, dev)
    shade_sets("shade_atrium", r, tf.closest_hit_fused(r.packed.opaque_planar, oc, dc), oc, dc,
               rng)
    del r
    pool, inst, b_mats, b_lights, b_cam, b_atlas = procedural.bistro_scene()
    bscene = R.build_instanced_scene(pool, inst, b_mats, b_lights, b_cam, atlas=b_atlas)
    rb = R.Renderer(bscene, RenderConfig(width=1920, height=1080, pbr_mode=PBR_GLTF,
                                         **cs.BISTRO_CFG), device=dev, fused_shade=True)
    oc, dc = cs.camera_rays(rb.scene.camera, 1920, 1080, n, rng, dev)
    seed = torch.tensor(rng.integers(0, 2**32, n), device=dev)
    hit, _ = tlas.closest_hit_instanced(rb.packed, rb.alpha_pack, oc, dc, seed=seed)
    shade_sets("shade_bistro", rb, hit, oc, dc, rng, instances=rb.packed.inst)
    del rb, bscene, hit
    torch.cuda.empty_cache()
    for width, bundle in bundles.items():
        r = R.Renderer(a_scene, cfg, device=dev, packed=bundle, fused_shade=True)
        r.render_frame(0)
        captured = cs.capture_alpha_inputs(r, 1)
        del r
        for label, (planar, o, d, t_limit, act), _ in captured:
            it, kind = label.split(", ")[:2]
            what = f"prefilter_w{width} {it.replace(' ', '')}_{kind.split()[0]}"
            outs[what] = tf.alpha_need(planar, o, d, t_limit, act).cpu()
            if it not in ("iteration 0", "iteration 2"):
                continue
            ms = []
            for _ in range(ROUNDS):
                copies = [tuple(x if x is None else x.clone() for x in (o, d, t_limit, act))
                          for _ in range(21)]
                ms.append(cs.events_ms([lambda c=c: tf._alpha_need_cuda(planar, *c)
                                        for c in copies], queue=True))
            times.append(f"{what} {min(ms):.4f}/{float(np.median(ms)):.4f}")
        planar = captured[0][1][0]
        s_rng = np.random.default_rng(40 + width)
        for case in cs.PREFILTER_CASES:
            o, d, t_limit = (x.to(dev) for x in cs.prefilter_rays(
                case, planar, cs.PREFILTER_SYNTH_RAYS + 3, s_rng))
            for active in cs.PREFILTER_ACTIVE:
                act = cs.prefilter_active(active, cs.PREFILTER_SYNTH_RAYS + 3, s_rng)
                act = None if act is None else act.to(dev)
                outs[f"prefilter_w{width} {case}_{active}"] = tf.alpha_need(
                    planar, o, d, t_limit, act).cpu()
        del captured
        torch.cuda.empty_cache()
    torch.save(outs, os.path.join(out_dir, f"{len(os.listdir(out_dir))}.pt"))
    print(os.path.basename(tree), " ".join(times), flush=True)
    print(os.path.basename(tree), "ptxas:", "; ".join(standalone_ptxas(tree)), flush=True)


def standalone_ptxas(tree):
    """ptxas's registers, stack frame and spill of the body alone's and the
    root prefilter's instantiations in ``tree``'s built libraries."""
    import glob
    import re

    out = []
    logs = [os.path.join(tree, "vk_raytrace_torch", "_build", "libshade.so.ptxas"),
            *sorted(glob.glob(os.path.join(tree, "vk_raytrace_torch", "_build",
                                           "libtraverse*.so.ptxas")))]
    for log in logs:
        for chunk in open(log).read().split("Compiling entry function '")[1:]:
            name = chunk.split("'", 1)[0]
            if not re.search(r"\d(shade_kernel|root_prefilter_kernel)I", name):
                continue
            regs = re.search(r"Used (\d+) registers", chunk)
            frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                              r"(\d+) bytes spill loads", chunk)
            out.append(f"{os.path.basename(log).split('.')[0][3:]}:{name[-40:]} "
                       f"{regs.group(1) if regs else '?'} regs, "
                       f"{frame.group(1) if frame else '?'} B frame, "
                       f"{int(frame.group(2)) + int(frame.group(3)) if frame else '?'} B spill")
    return out


def same_outputs(out_dir, trees):
    """Every checkout's saved outputs equal the first's bit for bit (the
    float fields as their int32 words)."""
    import torch

    runs = [torch.load(os.path.join(out_dir, f"{k}.pt")) for k in range(len(trees))]
    for k, run in enumerate(runs[1:], 1):
        assert run.keys() == runs[0].keys(), f"{trees[k]}: other output sets"
        for name, x in run.items():
            xs, ys = (x, runs[0][name]) if isinstance(x, list) else ([x], [runs[0][name]])
            for a, b in zip(xs, ys):
                a, b = ((t.view(torch.int32) if t.dtype == torch.float32 else t) for t in (a, b))
                assert a.shape == b.shape and torch.equal(a, b), (
                    f"{trees[k]}: {name} differs from {trees[0]}'s")
    print(f"outputs: {len(runs[0])} sets, every checkout's equal to {trees[0]}'s bit for bit",
          flush=True)


# The kernels --ptx holds equal: every instantiation whose name holds one of
# these, in traverse.cu at both widths and in shade.cu.
PTX_KERNELS = ("persistent_traverse_kernel", "capped_traverse_kernel", "machine_kernel",
               "alpha_rounds_kernel", "round_traverse_kernel", "shade_stage_kernel")


def ptx_entries(tree, width, out_dir, src="traverse.cu"):
    """``csrc/<src>`` of ``tree`` compiled to PTX (traverse.cu at
    ``width``): {kernel name: its body with line directives, labels,
    register numbers, mangled names and local-memory depot numbers
    masked}."""
    import re

    from vk_raytrace_torch import cuda_build

    out = os.path.join(out_dir, f"{os.path.basename(tree)}_{src}_w{width}.ptx")
    flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([cuda_build.nvcc(), *flags, f"-DVKRT_WIDTH={width}", "-ptx", "-o", out,
                    os.path.join(tree, "vk_raytrace_torch", "csrc", src)], check=True)
    text = open(out).read()
    entries = {}
    for chunk in text.split(".entry ")[1:]:
        # From the kernel's own name on (the anonymous namespace's mangled
        # prefix differs between two sources).
        m = re.search(r"\d+([A-Za-z_]+_kernel)(I\w*)", chunk.split("(", 1)[0])
        name = m.group(1) + m.group(2)
        body = re.sub(r"^\s*\.loc.*$", "", chunk, flags=re.M)
        body = re.sub(r"_Z\w+", "SYM", body)
        body = re.sub(r"\$L\w+", "LBL", body)
        body = re.sub(r"%(r|rd|f|fd|p|rs|h)\d+", r"%\1", body)
        body = re.sub(r"__local_depot\d+", "DEPOT", body)  # numbered in file order
        entries[name] = body
    return entries


def compare_ptx(parent, change):
    """``--ptx``: one line per kernel of PTX_KERNELS at each width (the
    shading source once)."""
    import tempfile

    sys.path.insert(0, os.path.abspath(change))
    with tempfile.TemporaryDirectory() as tmp:
        for width, src in ((16, "traverse.cu"), (32, "traverse.cu"), (16, "shade.cu")):
            a, b = (ptx_entries(os.path.abspath(t), width, tmp, src) for t in (parent, change))
            tag = f"w{width}" if src == "traverse.cu" else "shade"
            for name in sorted(a):
                if not any(k in name for k in PTX_KERNELS):
                    continue
                what = "missing" if name not in b else ("equal" if a[name] == b[name] else
                                                        "DIFFERS")
                if what == "DIFFERS":  # the first lines that differ
                    import difflib

                    diff = [x for x in difflib.unified_diff(a[name].splitlines(),
                                                            b[name].splitlines(), n=0)
                            if x[:1] in "+-" and x[:3] not in ("+++", "---")]
                    what += f" ({len(diff)} lines: {diff[:4]})"
                print(f"ptx {tag} {name[:90]}: {what}", flush=True)


def machine_ptxas(tree, capped=False, rounds=False):
    """ptxas's registers, stack frame and spill of each round machine and
    a/b instantiation in ``tree``'s built traversal libraries; with
    ``capped``, of the a/b and capped kernels; with ``rounds``, of the
    per-round kernels."""
    import glob
    import re

    out = []
    for log in sorted(glob.glob(os.path.join(tree, "vk_raytrace_torch", "_build",
                                             "libtraverse*.so.ptxas"))):
        text = open(log).read()
        for chunk in text.split("Compiling entry function '")[1:]:
            name = chunk.split("'", 1)[0]
            keys = (("persistent_traverse_kernel", "capped_traverse_kernel") if capped else
                    ("machine_kernel", "persistent_traverse_kernel", "alpha_rounds_kernel"))
            if rounds:  # the per-round kernels (the first design's traverse_kernel too)
                keys = ("traverse_kernel",)
                if "persistent" in name or "capped" in name:
                    continue
            if not any(k in name for k in keys):
                continue
            regs = re.search(r"Used (\d+) registers", chunk)
            frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                              r"(\d+) bytes spill loads", chunk)
            out.append(f"{os.path.basename(log).split('.')[0][3:]}:{name[:80]} "
                       f"{regs.group(1) if regs else '?'} regs, "
                       f"{frame.group(1) if frame else '?'} B frame, "
                       f"{int(frame.group(2)) + int(frame.group(3)) if frame else '?'} B spill")
    return out


def main(argv):
    if argv[:1] == ["--one"]:
        if "--capped" in argv:
            time_capped(argv[-1])
        elif "--rounds" in argv:
            time_rounds(argv[-1])
        elif "--standalone" in argv:
            time_standalone(argv[-1], argv[-2])
        else:
            time_tree(argv[-1], atrium_only="--atrium" in argv)
        return
    if argv[:1] == ["--ptx"] and len(argv) == 3:
        compare_ptx(*argv[1:])
        return
    flag = argv[:1] if argv[:1] in (["--atrium"], ["--capped"], ["--rounds"],
                                    ["--standalone"]) else []
    trees = argv[len(flag):]
    if not trees:
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    import tempfile

    with tempfile.TemporaryDirectory() as out_dir:
        for tree in trees:
            extra = [out_dir] if flag == ["--standalone"] else []
            subprocess.run([sys.executable, os.path.abspath(__file__), "--one", *flag, *extra,
                            tree], check=True)
        if flag == ["--standalone"]:
            same_outputs(out_dir, trees)


if __name__ == "__main__":
    main(sys.argv[1:])
