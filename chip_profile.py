#!/usr/bin/env python3
"""Where a frame of the port's main path spends its time on one GPU.

    python3 chip_profile.py [--scene atrium|bistro|grid|helmet|plaza] [--frames N]
                            [--top K] [--fused-shade] [--nccl]

Builds the full atrium (single level) or the full bistro (two levels,
``build_instanced_scene``, the configuration of ``chip_smoke.py`` phase 11:
full_mis off, HDR multiplier 1) and renders it at 1920x1080, depth 4, 1
spp, sun&sky, firefly clamp 10; or BASELINE configuration #4 (``grid``:
the material grid under the procedural sky, 512x512, 4 spp, depth 8, the
Disney BSDF) or #2 (``helmet``: 512x512, 16 spp, depth 5, glTF), both
firefly clamp 10 and full_mis off, as ``chip_smoke.py`` phases 20-21; or
the plaza (``plaza``: ``chip_smoke.write_plaza``'s glTF, 4,609 instances,
loaded in two levels) at the configuration of ``chip_smoke.py`` phase 29,
the reference CLI's defaults with sun&sky: 1280x720, depth 10, 1 spp a
frame, Disney (glTF with ``--fused-shade``), firefly clamp 10. With
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

With ``--nccl`` it measures the same renderer's ``Renderer.step`` in the
states a process passes through in ``chip_smoke.py`` phase 31 (NCCL at
world size 1), in one process, twice over: no process group; an NCCL
group joined, before any collective; after the collectives of phase 31's
sharded path (``sharding.replicate`` and one ``sharded_render_step``
frame), which create NCCL's communicator; and after
``destroy_process_group``. For each state: the unprofiled frames, the
process's CPU seconds per wall second over them and the threads that
spent it (``/proc/self/task``, by name), then one traced frame's wall,
device busy, launches, host syncs, the host's mean time in a kernel
launch call and the device's idle gaps inside the frame.
"""

import argparse
import os
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


def idle_gaps_us(events):
    """The gaps between the union intervals of the events, in order."""
    gaps, end = [], None
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if end is not None and s > end:
            gaps.append(s - end)
        end = e if end is None else max(end, e)
    return gaps


def thread_cpu_s():
    """{(tid, name): user + system CPU seconds} of this process's threads."""
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/comm") as f:
                name = f.read().strip()
            with open(f"/proc/self/task/{tid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:  # the thread ended meanwhile
            continue
        out[(tid, name)] = (int(fields[11]) + int(fields[12])) / tick  # utime, stime
    return out


def timed_frames(r, n):
    """``n`` unprofiled frames: their seconds, the process's CPU seconds per
    wall second over them and the CPU seconds of each thread name."""
    cpu0, th0, w0 = time.process_time(), thread_cpu_s(), time.perf_counter()
    frames = []
    for _ in range(n):
        t0 = time.perf_counter()
        r.step()
        torch.cuda.synchronize()
        frames.append(time.perf_counter() - t0)
    wall = time.perf_counter() - w0
    cpu = time.process_time() - cpu0
    th1, by_name = thread_cpu_s(), {}
    for key, v in th1.items():
        d = v - th0.get(key, 0.0)
        if d > 0:
            by_name[key[1]] = by_name.get(key[1], 0.0) + d
    return frames, cpu / wall, by_name, len(th1)


def traced_frame(r):
    """One frame under ``torch.profiler``: (wall s, profile)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        r.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, prof


def host_syncs(prof) -> int:
    return sum(1 for e in prof.events() if e.device_type != torch.autograd.DeviceType.CUDA
               and e.name in SYNCS)


def nccl_states(r, n, card, cycles=2):
    """``--nccl``: ``Renderer.step`` with no process group, with an NCCL
    group of world size 1 before and after its communicator exists, and
    after the group is destroyed (see the module's docstring)."""
    import torch.distributed as dist

    from vk_raytrace_torch.parallel import sharding

    def measure(state):
        frames, cpu_per_s, threads, n_threads = timed_frames(r, n)
        wall, prof = traced_frame(r)
        events, _ = device_events(prof)
        kernels = [ev for ev in events if not ev[0].startswith(("Memcpy", "Memset"))]
        busy = busy_us(events) / 1e3
        gaps = idle_gaps_us(events)
        launch = [e.time_range.end - e.time_range.start for e in prof.events()
                  if e.device_type != torch.autograd.DeviceType.CUDA
                  and e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")]
        top = ", ".join(f"{k} {v:.3f}" for k, v in sorted(threads.items(), key=lambda kv: -kv[1])[:6])
        print(f"[{state}] unprofiled s/frame {['%.4f' % x for x in frames]} (mean "
              f"{sum(frames) / len(frames):.4f}); process CPU s per wall s {cpu_per_s:.3f}; "
              f"{n_threads} threads; CPU s by thread name over the frames: {top}", flush=True)
        print(f"[{state}] traced frame: wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
              f"({100 * busy / (wall * 1e3):.1f}%), {len(kernels)} kernels, host syncs "
              f"{host_syncs(prof)}, kernel launch calls {len(launch)} at mean "
              f"{sum(launch) / max(len(launch), 1):.2f} us (host); device idle gaps in the "
              f"frame: {len(gaps)}, sum {sum(gaps) / 1e3:.1f} ms, > 1 ms {sum(g > 1e3 for g in gaps)}, "
              f"largest {max(gaps, default=0) / 1e3:.2f} ms [{card}]", flush=True)

    measure("no process group")
    for c in range(cycles):
        port = sharding.free_port()
        assert sharding.init_process_group("cuda", 0, 1, f"tcp://127.0.0.1:{port}") == "nccl"
        try:
            mesh = sharding.make_mesh("cuda")
            measure(f"cycle {c + 1}: NCCL group, no collective yet")
            sharding.replicate(mesh, (r.scene, r.packed, r.alpha_pack, r._shade_tables))
            step = sharding.sharded_render_step(
                mesh, r.scene, r.packed, r._run_cfg, alpha_pack=r.alpha_pack,
                features=r.features, fused_shade=r.fused_shade, shade_tables=r._shade_tables)
            step(sharding.shard_accum(mesh, torch.zeros_like(r.accum)), 0)
            torch.cuda.synchronize()
            measure(f"cycle {c + 1}: NCCL group after its collectives")
        finally:
            dist.destroy_process_group()
        measure(f"cycle {c + 1}: group destroyed")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("atrium", "bistro", "grid", "helmet", "plaza"),
                    default="atrium")
    ap.add_argument("--frames", type=int, default=3, help="unprofiled timed frames")
    ap.add_argument("--top", type=int, default=20, help="kernels listed by device time")
    ap.add_argument("--fused-shade", action="store_true", help="render with the fused shading stage")
    ap.add_argument("--nccl", action="store_true",
                    help="Renderer.step before, while and after an NCCL group of world size 1 lives")
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
    elif args.scene == "plaza":
        import tempfile

        import chip_smoke
        from vk_raytrace_torch.models.gltf import load_gltf

        with tempfile.TemporaryDirectory() as work:
            path = os.path.join(work, "plaza.gltf")
            chip_smoke.write_plaza(path, **chip_smoke.PLAZA)
            (pool, inst), mats, lights, cam, atlas = load_gltf(path, instancing="auto")
        scene = R.build_instanced_scene(pool, inst, mats, lights, cam, atlas=atlas)
        cfg = RenderConfig(width=1280, height=720, max_depth=10, max_samples=1,
                           pbr_mode=PBR_GLTF if args.fused_shade else PBR_DISNEY,
                           firefly_clamp=10.0, hdr_multiplier=1.0, use_sun_sky=True)
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
    if args.nccl:
        print(f"card: {card}; scene {args.scene}; shading stage {r.stage}; {os.cpu_count()} CPUs, "
              f"torch threads {torch.get_num_threads()}", flush=True)
        nccl_states(r, args.frames, card)
        return
    frames, _, _, _ = timed_frames(r, args.frames)
    wall, prof = traced_frame(r)
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
    print(f"host syncs: {host_syncs(prof)}")
    print(f"traversal: {sum(e - s for _, s, e in trav) / 1e3:.3f} ms in {len(trav)} launches")
    roots = "with per-lane roots" if args.scene in ("bistro", "plaza") else "from the root"
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
