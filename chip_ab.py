#!/usr/bin/env python3
"""Time the traversal kernels of several checkouts on one GPU.

    python3 chip_ab.py [--atrium] PARENT CHANGE CHANGE PARENT ...

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
instantiations. Variants of a kernel (a copy of a checkout
with an edited source) compare as checkouts.
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
    rng = np.random.default_rng(1234)
    n = 1 << 18
    oc, dc = cs.camera_rays(with_aspect(cam, 1920, 1080).to(dev), 1920, 1080, n // 2, rng, dev)
    orr, drr = cs.random_rays(rng, np.asarray(geom.positions), n // 2, dev)
    o, d = torch.cat([oc, orr]).contiguous(), torch.cat([dc, drr]).contiguous()
    inf = torch.full((n,), tf.INF, device=dev)
    t_short = torch.tensor(rng.uniform(0.5, 20.0, n), dtype=torch.float32, device=dev)
    oa, da = cs.rays_at(rng, geom, np.where(np.asarray(geom.tri_flags) & 2)[0], n, dev)
    from vk_raytrace_torch import render as R
    from vk_raytrace_torch.ops import traverse_alpha as ta
    from vk_raytrace_torch.ops.traverse_wide import make_alpha_pack

    a_sc = R.build_scene(geom, a_mats, a_lights, cam, atlas=a_atlas).to(dev)
    a_pack = make_alpha_pack(a_sc.materials, a_sc.atlas, a_sc.geometry.tri_material)
    r_rng = np.random.default_rng(18)  # the rounds' own draws leave the other rays as they were
    r_seed = torch.tensor(r_rng.integers(0, 2**32, n), device=dev)
    r_act = torch.tensor(r_rng.random(n) < 0.95, device=dev)

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


def machine_ptxas(tree, capped=False):
    """ptxas's registers, stack frame and spill of each round machine and
    a/b instantiation in ``tree``'s built traversal libraries; with
    ``capped``, of the a/b and capped kernels."""
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
        else:
            time_tree(argv[-1], atrium_only="--atrium" in argv)
        return
    flag = argv[:1] if argv[:1] in (["--atrium"], ["--capped"]) else []
    trees = argv[len(flag):]
    if not trees:
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for tree in trees:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", *flag, tree],
                       check=True)


if __name__ == "__main__":
    main(sys.argv[1:])
