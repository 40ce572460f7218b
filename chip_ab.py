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
three means of 50 launches (CUDA events), in ms. The card's name and power
limit come first.
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
    geom, _, _, cam, _ = procedural.atrium_scene()
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
