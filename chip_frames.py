#!/usr/bin/env python3
"""Render the same frames from several checkouts of the repo and compare
their images and ray counts bit for bit.

    python3 chip_frames.py [--device cuda|cpu] OUT CHECKOUT [CHECKOUT ...]

For each checkout (a directory holding ``vk_raytrace_torch/``, e.g. one
unpacked with ``git archive``) a child process renders the cases below
with that checkout's package and writes each image (``.npy``) and its rays
under ``OUT/<i>/``; then every checkout's images are held against the first
one's: equal bytes, equal rays. One line a case and checkout, then ``all
equal`` or the cases that differ (exit 1).

Cases, on the card (``--device cuda``): the full atrium at 1920x1080, depth
4, 1 spp, sun&sky, glTF, firefly clamp 10 (``chip_smoke.py`` phase 5),
frames 0 and 1 through ``Renderer.render_frame``: the eager stage, the fused
stage, the fused stage with ``renderer="wide"``, the fused stage at row
width 32 (phase 15); the full bistro (phase 11: two levels, full MIS off,
HDR multiplier 1), fused at widths 16 and 32 (phase 16), frames 0 and 1; and a
sample shard's stream (``parallel/sharding.rank_frame``: the atrium fused,
frame 1, sample 1 of 2, so the stream 3 keys the paths and frame 1 the
jitter). On the CPU (``--device cpu``) the reduced atrium and bistro (the
port's CPU tests' sizes) at 64x48 call ``render_units_pooled`` directly with
pools smaller than the frame, so that lanes regenerate: 1 spp in 1024
lanes, 4 spp in 8192 lanes (the new loop's tiered tail), each eager, fused,
wide and fused at width 32, the bistro fused at both widths, and the
stream 3. The CPU cases hold a frame
against another checkout's, which the CPU tests cannot: they hold the loop
against the reference and the plain versions. On the CPU the eager stage's
bits can depend on the width of the batch a lane was shaded in (torch's CPU
``pow`` and ``atan2`` compute a call's last n mod 8 elements with scalar
libm, the rest with vector code), so two schedules may differ there by an
ulp or so in a few pixels.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

SMALL_ATRIUM = dict(bays_x=2, bays_z=2, column_segments=16, column_rows=12)
SMALL_BISTRO = dict(detail=0.05)


def child(device, out):
    import torch

    from vk_raytrace_torch import render as R
    from vk_raytrace_torch.integrator.wavefront import render_units_pooled
    from vk_raytrace_torch.models import procedural
    from vk_raytrace_torch.models.schema import PBR_GLTF
    from vk_raytrace_torch.models.schema import RenderConfig
    from vk_raytrace_torch.ops.bvh8 import build_accel_bundle
    from vk_raytrace_torch.parallel import sharding

    os.makedirs(out, exist_ok=True)
    dev = torch.device(device, 0) if device == "cuda" else torch.device("cpu")
    small = device == "cpu"
    size = dict(width=64, height=48) if small else dict(width=1920, height=1080)
    base = dict(**size, max_depth=4, max_samples=1, pbr_mode=PBR_GLTF, firefly_clamp=10.0,
                use_sun_sky=True)
    g, m, l, c, a = procedural.atrium_scene(**(SMALL_ATRIUM if small else {}))
    atrium = R.build_scene(g, m, l, c, atlas=a)
    pool, inst, bm, bl, bc, ba = procedural.bistro_scene(**(SMALL_BISTRO if small else {}))
    bistro = R.build_instanced_scene(pool, inst, bm, bl, bc, atlas=ba)
    bistro_cfg = dict(hdr_multiplier=1.0, full_mis=False)

    def save(name, img, rays, t):
        img = img.detach().cpu().numpy()
        np.save(os.path.join(out, name + ".npy"), img)
        with open(os.path.join(out, name + ".json"), "w") as f:
            json.dump({"rays": int(rays), "s": t, "mean": float(img.mean())}, f)

    def renderer(scene, extra=(), **kw):
        return R.Renderer(scene, RenderConfig(**base, **dict(extra)), device=dev, **kw)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    renderers = {
        "atrium_eager": lambda: renderer(atrium),
        "atrium_fused": lambda: renderer(atrium, fused_shade=True),
        "atrium_wide": lambda: renderer(atrium, fused_shade=True, renderer="wide"),
        "atrium_fused_w32": lambda: renderer(atrium, fused_shade=True,
                                             packed=build_accel_bundle(g, width=32)),
        "bistro_fused": lambda: renderer(bistro, bistro_cfg, fused_shade=True),
        "bistro_fused_w32": lambda: renderer(
            R.build_instanced_scene(pool, inst, bm, bl, bc, atlas=ba, width=32), bistro_cfg,
            fused_shade=True),
    }
    for name, make in renderers.items():
        r = make()
        if small:
            # Pools below the frame's units: regeneration, and at 8192 lanes the tiers.
            n_pix = base["width"] * base["height"]
            for spp, lanes in ((1, 1024), (4, 8192)):
                cfg = dataclasses.replace(r._run_cfg, max_samples=spp)
                t0 = time.perf_counter()
                img, rays = render_units_pooled(
                    r.scene, r.packed, cfg, 1, 0, n_pix, lanes, alpha_pack=r.alpha_pack,
                    features=r.features, fused_shade=r.fused_shade, shade_tables=r._shade_tables,
                    backend=r.renderer)
                save(f"{name}_spp{spp}_pool{lanes}", img, rays, time.perf_counter() - t0)
        else:
            for frame in (0, 1):
                t0 = time.perf_counter()
                img = r.render_frame(frame)
                sync()
                save(f"{name}_frame{frame}", img, r.last_rays, time.perf_counter() - t0)
        if name == "atrium_fused":
            lanes = 1024 if small else None
            t0 = time.perf_counter()
            img, rays = sharding.rank_frame(
                r.scene, r.packed, r._run_cfg, 1, 0, 1, 1, 2, alpha_pack=r.alpha_pack,
                features=r.features, fused_shade=True, shade_tables=r._shade_tables, pool=lanes)
            sync()
            save("atrium_fused_stream3", img, rays, time.perf_counter() - t0)
        del r


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--child", metavar="OUT", help=argparse.SUPPRESS)
    ap.add_argument("out", nargs="?")
    ap.add_argument("checkouts", nargs="*")
    args = ap.parse_args()
    if args.child:
        # The checkout's package, not this script's directory's.
        sys.path[0] = os.getcwd()
        child(args.device, args.child)
        return
    if not args.checkouts:
        ap.error("give OUT and at least one checkout")
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available: this script needs an NVIDIA GPU")
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    else:
        card = "CPU"
    dirs = []
    for i, co in enumerate(args.checkouts):
        co = os.path.abspath(co)
        out = os.path.join(os.path.abspath(args.out), str(i))
        cmd = [sys.executable, os.path.abspath(__file__), "--device", args.device,
               "--child", out]
        env = {**os.environ, "PYTHONPATH": co}
        t0 = time.time()
        res = subprocess.run(cmd, cwd=co, env=env, capture_output=True, text=True)
        print(f"checkout {i} ({co}): exit {res.returncode} in {time.time() - t0:.1f} s",
              flush=True)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-8000:])
            raise SystemExit(f"checkout {i} failed")
        dirs.append(out)
    differ = []
    for name in sorted(f[:-4] for f in os.listdir(dirs[0]) if f.endswith(".npy")):
        ref = np.load(os.path.join(dirs[0], name + ".npy"))
        with open(os.path.join(dirs[0], name + ".json")) as f:
            ref_meta = json.load(f)
        for i, d in enumerate(dirs[1:], 1):
            img = np.load(os.path.join(d, name + ".npy"))
            with open(os.path.join(d, name + ".json")) as f:
                meta = json.load(f)
            same = img.shape == ref.shape and img.tobytes() == ref.tobytes()
            n_px = int((img != ref).any(-1).sum()) if img.shape == ref.shape else -1
            ulps = (int(np.abs(img.view(np.int32).astype(np.int64)
                               - ref.view(np.int32).astype(np.int64)).max())
                    if img.shape == ref.shape else -1)
            ok = same and meta["rays"] == ref_meta["rays"]
            print(f"{name}: checkout {i} vs 0: bytes {'equal' if same else 'DIFFER'} "
                  f"({n_px} pixels, at most {ulps} ulp), rays {meta['rays']} vs "
                  f"{ref_meta['rays']}, s {meta['s']:.4f} vs {ref_meta['s']:.4f}, mean "
                  f"{meta['mean']:.6f} [{card}]", flush=True)
            if not ok:
                differ.append(f"{name} ({i})")
    print("all equal" if not differ else f"differ: {', '.join(differ)}", flush=True)
    if differ:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
