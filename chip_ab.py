#!/usr/bin/env python3
"""Time the traversal kernels of several checkouts on one GPU.

    python3 chip_ab.py PARENT CHANGE CHANGE PARENT ...

Each argument is the root of a checkout (for example a ``git archive`` of
the parent commit unpacked into a git-ignored directory). Each runs in its
own process, in the order given, so alternate them. A process builds that
checkout's kernels (``chip_smoke.build_kernels``), takes ``chip_smoke.py``'s
phase-3 ray sets (2^18 rays on the full atrium, seed 1234) and prints, at
row widths 16 and 32, per mode a/b/c and for the capped entry (closest hit
stopped after 8 nodes, on the mode-a rays), the least and the median of
three means of 50 launches (CUDA events), in ms; then the same for the two
round machines on the full bistro at width 16, closest hit (the opaque
machine over the opaque subsets on 2^18 camera rays, the alpha machine
over the alpha subsets on 2^18 rays toward the foliage, seed 1234; 10
launches a mean); then the wide back end through the calls every checkout
has: ``traverse_wide`` on the atrium's 8-wide trees (closest and any hit
over the opaque tree on the mode a/b rays, closest over the alpha tree
with the pack toward the banners, and any over it with a tenth of those
rays active) and the bistro's two-level wide calls
(``closest_hit_instanced(..., backend="wide")`` with the pack on the
camera rays and on the rays toward the foliage: an opaque and an alpha
pass each, per-round launches and host syncs where a checkout has no
machine; 3 calls a mean). The card's name and power limit come first.
"""

import os
import subprocess
import sys

REPS, ROUNDS = 50, 3


def time_tree(tree):
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
    cs.build_kernels()
    geom, a_mats, a_lights, cam, a_atlas = procedural.atrium_scene()
    rng = np.random.default_rng(1234)
    n = 1 << 18
    oc, dc = cs.camera_rays(with_aspect(cam, 1920, 1080).to(dev), 1920, 1080, n // 2, rng, dev)
    orr, drr = cs.random_rays(rng, np.asarray(geom.positions), n // 2, dev)
    o, d = torch.cat([oc, orr]).contiguous(), torch.cat([dc, drr]).contiguous()
    inf = torch.full((n,), tf.INF, device=dev)
    t_short = torch.tensor(rng.uniform(0.5, 20.0, n), dtype=torch.float32, device=dev)
    oa, da = cs.rays_at(rng, geom, np.where(np.asarray(geom.tri_flags) & 2)[0], n, dev)
    out = []
    for width in (16, 32):
        g = build_accel_bundle(geom, width=width).to(dev)
        cases = {
            "closest": lambda: tf.traverse(g.opaque_planar, o, d, inf, mode="closest", cull=True),
            "any": lambda: tf.traverse(g.opaque_planar, o, d, t_short, mode="any", cull=False),
            "candidate": lambda: tf.traverse(g.alpha_planar, oa, da, inf, mode="candidate",
                                             cull=True),
            "capped8": lambda: tf.traverse_capped(g.opaque_planar, o, d, inf, 8),
        }
        for name, fn in cases.items():
            ms = [tb.cuda_time(fn, REPS) for _ in range(ROUNDS)]
            out.append(f"w{width} {name} {min(ms):.4f}/{float(np.median(ms)):.4f}")
        del g
    from vk_raytrace_torch import render as R
    from vk_raytrace_torch.ops import tlas
    from vk_raytrace_torch.ops.traverse_wide import make_alpha_pack

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
    machines = {
        "opaque_machine": lambda: tlas._two_level_opaque_pass(acc, "opq", ob, db, inf, act, True,
                                                              False),
        "alpha_machine": lambda: tlas._two_level_alpha_pass(acc, pack, ol, dl, inf, seed, act,
                                                            False, True),
    }
    for name, fn in machines.items():
        ms = [tb.cuda_time(fn, 10) for _ in range(ROUNDS)]
        out.append(f"bistro {name} {min(ms):.4f}/{float(np.median(ms)):.4f}")
    from vk_raytrace_torch.ops import bvh8
    from vk_raytrace_torch.ops import traverse_wide as tw

    opq, alp = (w.to(dev) for w in bvh8.build_wide(geom))
    sparse = torch.tensor(rng.random(n) < 0.1, device=dev)
    a_sc = R.build_scene(geom, a_mats, a_lights, cam, atlas=a_atlas).to(dev)
    a_pack = make_alpha_pack(a_sc.materials, a_sc.atlas, a_sc.geometry.tri_material)
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


def main(argv):
    if argv[:1] == ["--one"]:
        time_tree(argv[1])
        return
    if not argv:
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for tree in argv:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree], check=True)


if __name__ == "__main__":
    main(sys.argv[1:])
