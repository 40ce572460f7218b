#!/usr/bin/env python3
"""Where a frame of the port's main path spends its time on one GPU.

    python3 chip_profile.py [--scene atrium|bistro|grid|helmet] [--frames N] [--top K]
                            [--fused-shade]

Builds the full atrium (single level) or the full bistro (two levels,
``build_instanced_scene``, the configuration of ``chip_smoke.py`` phase 11:
full_mis off, HDR multiplier 1) and renders it at 1920x1080, depth 4, 1
spp, sun&sky, firefly clamp 10; or BASELINE configuration #4 (``grid``:
the material grid under the procedural sky, 512x512, 4 spp, depth 8, the
Disney BSDF) or #2 (``helmet``: 512x512, 16 spp, depth 5, glTF), both
firefly clamp 10 and full_mis off, as ``chip_smoke.py`` phases 20-21. With
``--fused-shade`` the renderer asks for the fused shading stage (the
Disney grid keeps the eager one). It times N unprofiled frames after two
warm-up frames, then traces one more frame with ``torch.profiler``. It
prints, for the traced frame:

* wall: host clock around ``Renderer.step()`` + synchronize, profiled;
* device busy: the union of the intervals of every device activity
  (kernels, copies, sets) in the trace, in ms and as a share of wall;
* launches: the number of device kernels, and how many distinct ones;
* host syncs: the CUDA runtime's stream and device synchronize calls
  that the host made during the frame (``nonzero``, ``item()`` and the
  like wait so);
* traversal: device ms and launches of the per-round traversal kernel, in
  all and by mode (closest, any, candidate; with per-lane roots in the
  bistro, from the tree's root in the atrium), and of each round machine
  kernel: the single-level alpha rounds (the atrium's alpha pass), the
  two-level opaque machine and alpha machine (the bistro's passes), one
  launch per call each;
* shading: device ms and launches of the kernels that ran inside the
  device spans of the wavefront's ``shade_stage`` ranges (the whole stage,
  eager or fused), and the fused shading kernels' own ms and launches
  (``vkrt_shade_stage``, or the body alone);
* the top K device kernels by total time;
* peak device memory allocated over the timed and the traced frames.
"""

import argparse
import re
import subprocess
import sys
import time

import torch

TRAVERSE = "traverse_kernel"
TRAVERSE_MODE = re.compile(r"traverse_kernel<(\d)")  # the template's MODE argument
MODES = ("closest", "any", "candidate")  # csrc/traverse.cu enum Mode
# The round machine kernels (csrc/traverse.cu), each one launch per call.
MACHINES = (("alpha rounds", "alpha_rounds_kernel"), ("opaque machine", "opaque_machine_kernel"),
            ("alpha machine", "alpha_machine_kernel"))
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
SHADE = ("shade_stage_kernel", "shade_kernel")  # csrc/shade.cu: the whole stage, the body alone
STAGE = "shade_stage"  # the wavefront's profiler range around its shading stage


def device_events(prof):
    """The trace's device activities as (name, start_us, end_us), and the
    device-side spans of the ``shade_stage`` ranges apart (a range's span
    is an annotation, not an activity)."""
    dev = torch.autograd.DeviceType.CUDA
    acts, stages = [], []
    for e in prof.events():
        if e.device_type != dev:
            continue
        ev = (e.name, e.time_range.start, e.time_range.end)
        if e.name == STAGE:
            stages.append(ev)
        elif not getattr(e, "is_user_annotation", False):
            acts.append(ev)
    return acts, stages


def busy_us(events) -> float:
    """Length of the union of the events' intervals."""
    total, end = 0.0, float("-inf")
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("atrium", "bistro", "grid", "helmet"), default="atrium")
    ap.add_argument("--frames", type=int, default=3, help="unprofiled timed frames")
    ap.add_argument("--top", type=int, default=20, help="kernels listed by device time")
    ap.add_argument("--fused-shade", action="store_true", help="render with the fused shading stage")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this script needs an NVIDIA GPU")
    from vk_raytrace_torch import render as R
    from vk_raytrace_torch.models import hdr, procedural
    from vk_raytrace_torch.models.schema import PBR_DISNEY, PBR_GLTF, RenderConfig

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    main_path = dict(width=1920, height=1080, max_depth=4, max_samples=1, pbr_mode=PBR_GLTF,
                     firefly_clamp=10.0, use_sun_sky=True)
    baseline = dict(width=512, height=512, hdr_multiplier=1.0, firefly_clamp=10.0, full_mis=False)
    if args.scene == "bistro":
        pool, inst, mats, lights, cam, atlas = procedural.bistro_scene()
        scene = R.build_instanced_scene(pool, inst, mats, lights, cam, atlas=atlas)
        cfg = RenderConfig(**main_path, hdr_multiplier=1.0, full_mis=False)
    elif args.scene == "atrium":
        geom, mats, lights, cam, atlas = procedural.atrium_scene()
        scene = R.build_scene(geom, mats, lights, cam, atlas=atlas)
        cfg = RenderConfig(**main_path)
    else:
        sky = hdr.build_environment(hdr.procedural_sky_hdr())
        if args.scene == "grid":
            geom, mats, lights, cam = procedural.material_test_grid()
            scene = R.build_scene(geom, mats, lights, cam, env=sky)
            cfg = RenderConfig(**baseline, max_samples=4, max_depth=8, pbr_mode=PBR_DISNEY)
        else:
            geom, mats, lights, cam, atlas = procedural.helmet_scene()
            scene = R.build_scene(geom, mats, lights, cam, env=sky, atlas=atlas)
            cfg = RenderConfig(**baseline, max_samples=16, max_depth=5, pbr_mode=PBR_GLTF)
    r = R.Renderer(scene, cfg, device=dev, fused_shade=args.fused_shade)
    for _ in range(2):
        r.step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    frames = []
    for _ in range(args.frames):
        t0 = time.perf_counter()
        r.step()
        torch.cuda.synchronize()
        frames.append(time.perf_counter() - t0)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        r.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events, stages = device_events(prof)
    if not events:
        raise SystemExit("the trace holds no device activity")
    busy = busy_us(events) / 1e3
    kernels = [ev for ev in events if not ev[0].startswith(("Memcpy", "Memset"))]
    trav = [ev for ev in kernels if TRAVERSE in ev[0]]
    shade_k = [ev for ev in kernels if any(k in ev[0] for k in SHADE)]
    in_stage = [
        ev for ev in kernels if any(s <= ev[1] < e for _, s, e in stages)
    ]
    stage_ms = sum(e - s for _, s, e in in_stage) / 1e3
    per_name = {}
    for name, s, e in kernels:
        tot, cnt = per_name.get(name, (0.0, 0))
        per_name[name] = (tot + (e - s) / 1e3, cnt + 1)

    print(f"card: {card}; scene {args.scene}; shading stage {r.stage}")
    print(f"unprofiled frames (s): {frames}; rays/frame {r.last_rays}")
    print(f"profiled frame: wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / (wall * 1e3):.1f}%)")
    print(f"launches: {len(kernels)} kernels, {len(per_name)} distinct; "
          f"device activities {len(events)}")
    syncs = sum(1 for e in prof.events() if e.device_type != torch.autograd.DeviceType.CUDA
                and e.name in SYNCS)
    print(f"host syncs: {syncs}")
    print(f"traversal: {sum(e - s for _, s, e in trav) / 1e3:.3f} ms in {len(trav)} launches")
    roots = "with per-lane roots" if args.scene == "bistro" else "from the root"
    for i, mode in enumerate(MODES):
        evs = [ev for ev in trav if (m := TRAVERSE_MODE.search(ev[0])) and int(m.group(1)) == i]
        print(f"  {mode} ({roots}): {sum(e - s for _, s, e in evs) / 1e3:.3f} ms in "
              f"{len(evs)} launches")
    for label, name in MACHINES:
        evs = [ev for ev in kernels if name in ev[0]]
        print(f"{label}: {sum(e - s for _, s, e in evs) / 1e3:.3f} ms in {len(evs)} launches")
    print(f"shading stage: {stage_ms:.3f} device ms in {len(in_stage)} launches "
          f"({len(stages)} stage spans); fused kernel "
          f"{sum(e - s for _, s, e in shade_k) / 1e3:.3f} ms in {len(shade_k)} launches")
    print(f"peak allocated after warm-up: {torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
    print(f"top {args.top} kernels by device ms:")
    for name, (ms, cnt) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[: args.top]:
        print(f"  {ms:9.3f} ms {cnt:7d}x  {name[:110]}")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
