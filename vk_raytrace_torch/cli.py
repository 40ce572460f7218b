"""Headless CLI of the port (counterpart of ``vk_raytrace_tpu/cli.py``).

The reference's flags and defaults (``-f/--scene`` a glTF file or a
built-in scene, ``-e/--hdr`` an environment, the render state and the
tonemapper as flags), with these differences:

* ``--device`` (default ``cuda``): where the scene renders. ``cpu`` runs the
  kernels' plain versions (the tests' setting); without a card the default
  fails and never renders on the CPU instead.
* ``--fused-shade`` and ``--row-width 16|32`` spell out the reference's
  ``VKRT_FUSED_SHADE`` and ``VKRT_WIDE`` environment toggles; the port reads
  no environment toggle.
* ``--renderer`` accepts only ``fused``: the reference's ``wide`` back end
  is its XLA body, which the port does not have.
* ``--multichip`` renders on the one visible card; with more than one it
  raises (ROADMAP A13, sharding, is not ported).

Examples::

    python -m vk_raytrace_torch.cli --scene atrium --sun-sky -o out.png
    python -m vk_raytrace_torch.cli -f scene.glb -e env.hdr --depth 4 --spp 64 -o out.png
    python -m vk_raytrace_torch.cli --device cpu --scene cornell --size 64 48 --spp 2 -o c.png

``--checkpoint ck.npz`` resumes from ``ck.npz`` when it exists and writes
the accumulation back after the run: its keys, ``accum`` (H, W, 3) float32
and ``frame``, are the reference CLI's, so a checkpoint of either package
resumes in the other. As in the reference, each run adds ``--spp`` samples
to what the checkpoint holds.

``--stats`` prints the scene's inventory as JSON on stderr. Its
``bvh_nodes`` counts the rows of the planar tables the renderer traverses
(opaque and alpha trees, or the two-level pool's tables): the port builds
no binary BVH, whose nodes the reference counts there. ``--profile``
prints the frame times, the card's memory and, last, one JSON line
``{"profile": {...}}`` with each frame's seconds and rays, the build
seconds and the peak device memory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

DEBUG_NAMES = {
    "none": 0, "basecolor": 1, "normal": 2, "metallic": 3, "emissive": 4,
    "alpha": 5, "roughness": 6, "texcoord": 7, "tangent": 8, "radiance": 9,
    "weight": 10, "raydir": 11, "heatmap": 12,
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vk_raytrace_torch",
        description="glTF path tracer on PyTorch and hand-written CUDA kernels",
    )
    p.add_argument("-f", "--scene", default="cornell",
                   help="glTF/GLB file, or builtin: cornell | city | materials "
                        "| atrium (Sponza-class ~220k tris) | helmet "
                        "(DamagedHelmet-class textured PBR) "
                        "| bistro (Bistro-class >1M instanced tris)")
    p.add_argument("-e", "--hdr", default=None, help="HDR environment (.hdr)")
    p.add_argument("-o", "--output", default="out.png", help="output PNG")
    p.add_argument("--hdr-out", default=None, help="also write raw HDR (.npy)")
    p.add_argument("--size", nargs=2, type=int, default=[1280, 720],
                   metavar=("W", "H"), help="render size (ref default 1280x720)")
    p.add_argument("--depth", type=int, default=10, help="max path depth (ref: 10)")
    p.add_argument("--spp", type=int, default=16, help="samples per pixel of this run")
    p.add_argument("--samples-per-frame", type=int, default=1,
                   help="maxSamples per progressive frame (ref: 1)")
    p.add_argument("--pbr", choices=["disney", "gltf"], default="disney",
                   help="BSDF model (ref pbrMode: 0-Disney, 1-glTF)")
    p.add_argument("--hdr-multiplier", type=float, default=1.0)
    p.add_argument("--firefly-clamp", type=float, default=None,
                   help="luminance clamp (default: from env integral, like the ref)")
    p.add_argument("--sun-sky", action="store_true", help="use procedural sun & sky")
    p.add_argument("--no-rr", action="store_true", help="disable Russian roulette")
    p.add_argument("--no-any-hit", action="store_true",
                   help="disable stochastic alpha during traversal (ref: anyhit toggle)")
    p.add_argument("--debug-mode", choices=sorted(DEBUG_NAMES), default="none")
    p.add_argument("--render-scale", type=int, default=1,
                   help="descale factor while previewing (ref descaling)")
    p.add_argument("--seed-frame", type=int, default=0, help="starting frame index")
    p.add_argument("--checkpoint", default=None,
                   help="accumulation checkpoint (.npz) to resume/save")
    p.add_argument("--multichip", action="store_true",
                   help="shard the image over all visible cards (one card only: "
                        "sharding, ROADMAP A13, is not ported)")
    p.add_argument("--profile", action="store_true", help="print per-frame timings")
    p.add_argument("--stats", action="store_true", help="print scene statistics")
    p.add_argument("--instancing", choices=["auto", "bake", "always"], default="auto",
                   help="glTF node instancing: 'auto' shares meshes drawn by several "
                        "nodes through the two-level structure, 'bake' flattens to world "
                        "space, 'always' forces two levels")
    p.add_argument("--renderer", choices=["fused"], default=None,
                   help="traversal back end: 'fused', the hand-written kernels (the "
                        "reference's 'wide' XLA body is not ported)")
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (default; fails without a card) or 'cpu'")
    p.add_argument("--fused-shade", action="store_true",
                   help="shade each bounce in one kernel launch where the scene allows it "
                        "(the reference's VKRT_FUSED_SHADE=1)")
    p.add_argument("--row-width", type=int, choices=[16, 32], default=16,
                   help="children per BVH row (the reference's VKRT_WIDE)")
    # Tonemapper block (render_output.hpp:37-49 defaults)
    p.add_argument("--tm-brightness", type=float, default=1.0)
    p.add_argument("--tm-contrast", type=float, default=1.0)
    p.add_argument("--tm-saturation", type=float, default=1.0)
    p.add_argument("--tm-vignette", type=float, default=0.0)
    p.add_argument("--tm-exposure", type=float, default=1.0, help="avgLum divisor")
    p.add_argument("--tm-auto-exposure", action="store_true")
    p.add_argument("--tm-no-dither", action="store_true")
    return p


def load_scene_from_args(args, device):
    """The scene the arguments name, as a SceneData (a two-level one for the
    instanced bistro and instanced glTFs), and its environment (None
    without ``-e`` on a scene that brings none). An environment is built on
    ``device``."""
    import numpy as np
    import torch

    from . import render as R
    from .models import hdr as hdr_mod
    from .models import procedural
    from .models.schema import default_sun_sky

    atlas = None
    if args.scene == "cornell":
        geom, mats, lights, cam = procedural.cornell_box()
    elif args.scene == "city":
        geom, mats, lights, cam = procedural.city_scene()
    elif args.scene == "materials":
        geom, mats, lights, cam = procedural.material_test_grid()
    elif args.scene == "atrium":
        geom, mats, lights, cam, atlas = procedural.atrium_scene()
    elif args.scene == "helmet":
        geom, mats, lights, cam, atlas = procedural.helmet_scene()
    elif args.scene == "bistro":
        # >1M instantiated triangles through the two-level structure
        # (--instancing bake bakes them: the 1M-triangle single-level stress).
        if args.instancing != "bake":
            pool, inst, mats, lights, cam, atlas = procedural.bistro_scene()
            geom = (pool, inst)
        else:
            geom, mats, lights, cam, atlas = procedural.bistro_scene(instanced=False)
    else:
        from .models.gltf import load_gltf

        t0 = time.time()
        geom, mats, lights, cam, atlas = load_gltf(args.scene, instancing=args.instancing)
        if isinstance(geom, tuple):
            pool, inst = geom
            print(f"loaded {args.scene}: {pool.geometry.indices.shape[0]} tris "
                  f"in {len(pool.tri_start)} meshes x {len(inst.mesh_id)} "
                  f"instances ({time.time() - t0:.2f}s)", file=sys.stderr)
        else:
            print(f"loaded {args.scene}: {geom.indices.shape[0]} tris "
                  f"({time.time() - t0:.2f}s)", file=sys.stderr)

    env = None
    if args.hdr:
        t0 = time.time()
        img = hdr_mod.load_hdr(args.hdr)
        env = hdr_mod.build_environment(torch.from_numpy(img).to(device))
        print(f"loaded {args.hdr}: {img.shape[1]}x{img.shape[0]} "
              f"integral={float(env.integral):.3f} ({time.time() - t0:.2f}s)", file=sys.stderr)
    elif args.scene in ("materials", "helmet"):
        env = hdr_mod.build_environment(
            torch.from_numpy(np.ascontiguousarray(hdr_mod.procedural_sky_hdr())).to(device))

    sun_sky = default_sun_sky(in_use=args.sun_sky)
    if isinstance(geom, tuple):
        pool, inst = geom
        scene = R.build_instanced_scene(pool, inst, mats, lights, cam, env=env, sun_sky=sun_sky,
                                        atlas=atlas, width=args.row_width)
    else:
        scene = R.build_scene(geom, mats, lights, cam, env=env, sun_sky=sun_sky, atlas=atlas)
    return scene, env


def _device(args):
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("vk_raytrace_torch: CUDA is not available; this CLI renders on "
                             "an NVIDIA GPU, or on the CPU with --device cpu")
        if args.multichip and torch.cuda.device_count() > 1:
            raise NotImplementedError(
                f"--multichip over {torch.cuda.device_count()} cards: sharding the image "
                "over several cards is not ported yet (ROADMAP A13)")
    return dev


def _planar_rows(packed) -> int:
    tables = [getattr(packed, k, None) for k in (
        "opaque_planar", "alpha_planar", "blas_planar", "blas_planar_opq", "blas_planar_alp")]
    return sum(int(t.rows.shape[0]) for t in tables if t is not None)


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from . import render as R
    from .models.schema import PBR_DISNEY, PBR_GLTF, RenderConfig, default_tonemapper
    from .ops.bvh8 import build_accel_bundle
    from .utils.profiler import Profiler, device_memory_stats

    dev = _device(args)
    t_start = time.time()
    scene, env = load_scene_from_args(args, dev)
    build_s = {"scene_s": time.time() - t_start}

    # Firefly clamp driven by env integral like the reference
    # (sample_example.cpp:110: hdrResolution-based heuristic).
    clamp = args.firefly_clamp
    if clamp is None:
        clamp = 4.0 + float(scene.env.integral) if env is not None else 10.0

    w = args.size[0] // args.render_scale
    h = args.size[1] // args.render_scale
    cfg = RenderConfig(
        width=w,
        height=h,
        max_depth=args.depth,
        max_samples=args.samples_per_frame,
        firefly_clamp=clamp,
        hdr_multiplier=args.hdr_multiplier if (env is not None or args.sun_sky) else 0.0,
        debug_mode=DEBUG_NAMES[args.debug_mode],
        pbr_mode=PBR_DISNEY if args.pbr == "disney" else PBR_GLTF,
        use_sun_sky=args.sun_sky,
        use_any_hit=not args.no_any_hit,
        rr=not args.no_rr,
    )
    f32, i32 = np.float32, np.int32
    tm = dataclasses.replace(
        default_tonemapper(),
        brightness=f32(args.tm_brightness),
        contrast=f32(args.tm_contrast),
        saturation=f32(args.tm_saturation),
        vignette=f32(args.tm_vignette),
        avg_lum=f32(args.tm_exposure),
        auto_exposure=i32(1 if args.tm_auto_exposure else 0),
        dither=i32(0 if args.tm_no_dither else 1),
    )

    t0 = time.time()
    packed = None
    if scene.instances is None and args.row_width != 16:
        packed = build_accel_bundle(scene.geometry, width=args.row_width)
    r = R.Renderer(scene, cfg, device=dev, packed=packed, fused_shade=args.fused_shade,
                   tonemapper=tm)
    _sync(dev)
    build_s["renderer_s"] = time.time() - t0
    build_s.update(r.build_times)

    if args.stats:
        g = r.scene.geometry
        print(json.dumps({
            "triangles": int(g.indices.shape[0]),
            "vertices": int(g.positions.shape[0]),
            "materials": int(r.scene.materials.ior.shape[0]),
            "lights": int(r.scene.n_lights),
            "textures": int(r.scene.atlas.x.shape[0]),
            "bvh_nodes": _planar_rows(r.packed),
            "devices": [str(dev)],
        }), file=sys.stderr)

    frames = max(1, args.spp // cfg.max_samples)
    if args.checkpoint:
        try:
            with np.load(args.checkpoint) as ck:
                r.load_state({"accum": ck["accum"], "frame": int(ck["frame"])})
            print(f"resumed at frame {r.frame}", file=sys.stderr)
        except FileNotFoundError:
            pass
    prof = Profiler()
    rays = []
    t0 = time.time()
    for _ in range(frames):
        if args.profile:
            with prof.scope("frame"):
                r.step()
                _sync(dev)
            rays.append(r.last_rays)
            if r.frame % 16 == 0:
                print(f"frame {r.frame}: {(time.time() - t0) / len(rays) * 1000:.1f} ms/frame",
                      file=sys.stderr)
        else:
            r.step()
    img = r.postprocess().cpu().numpy()
    hdr_img = r.hdr().cpu().numpy()
    if args.checkpoint:
        np.savez(args.checkpoint, accum=hdr_img, frame=r.frame)

    R.write_png(args.output, img)
    if args.hdr_out:
        np.save(args.hdr_out, hdr_img)
    if args.profile:
        print(prof.report(), file=sys.stderr)
        for m in device_memory_stats():
            print(f"{m['device']}: {m['bytes_in_use'] / 2**20:.1f} MiB in use, peak "
                  f"{m['peak_bytes_in_use'] / 2**20:.1f} MiB of {m['bytes_limit'] / 2**20:.0f}",
                  file=sys.stderr)
        peak = torch.cuda.max_memory_allocated(dev) / 2**20 if dev.type == "cuda" else None
        print(json.dumps({"profile": {
            "device": str(dev), "stage": r.stage, "frames": frames, "frame": r.frame,
            "frame_s": prof.samples("frame"), "rays": rays, "build_s": build_s,
            "peak_mib": peak}}), file=sys.stderr)
    print(f"wrote {args.output} ({w}x{h}, {frames * cfg.max_samples} spp, "
          f"{time.time() - t_start:.1f}s total)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
