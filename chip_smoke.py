#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases, each printing its own lines (any failure raises and exits non-zero):

1. environment: the card's name and power limit; CUDA must be available;
2. build: the traversal kernel (``vk_raytrace_torch/csrc/traverse.cu``,
   nvcc) and the shared native host runtime (g++), from this checkout;
3. kernel against its plain torch twin on the card, for traversal modes a
   (closest hit), b (any hit) and c (alpha candidates), on the full atrium's
   trees at 2^18 rays (the main path's pool width), and both timed there;
4. the render slice on the card against the same slice on the CPU twin:
   a small atrium at 128x72, depth 4, 1 spp, 2 frames, identical tables and
   random streams;
5. the main path: the full atrium (~217k triangles) at 1920x1080, depth 4,
   1 spp, sun&sky, one warm-up and three timed frames; every traversal mode
   must have launched its kernel.

The line before the last is the per-kernel JSON summary; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCE = "vk_raytrace_torch/csrc/traverse.cu"
REPLACES = "vk_raytrace_tpu/ops/traverse_fused.py:255"  # _make_step_kernel
SMALL_ATRIUM = dict(bays_x=2, bays_z=2, column_segments=16, column_rows=12)
# Kernel vs twin: the same float32 operations in the same order, rounded
# per operation on both sides (nvcc -fmad=false); t/u/v within a few ulp.
RTOL, ATOL = 1e-5, 1e-5
# Slice vs CPU twin: the CUDA and CPU math libraries round transcendentals
# differently, which flips a rare Russian-roulette or alpha branch.
PIX_RTOL, PIX_ATOL, PIX_SHARE, RAY_REL = 1e-3, 1e-4, 0.99, 1e-3


def phase(name):
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_time(fn, reps):
    """Mean milliseconds per call, timed with CUDA events after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def camera_rays(cam, w, h, n, rng, dev):
    from vk_raytrace_torch.integrator.camera import generate_rays_for_pixels
    from vk_raytrace_torch.ops import rng as vrng

    pix = torch.tensor(rng.integers(0, w * h, n), dtype=torch.int64, device=dev)
    seed = vrng.tea(pix, 0)
    o, d, _ = generate_rays_for_pixels(cam, w, h, pix, 1, seed)
    return o.contiguous(), d.contiguous()


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


def main():
    # ---- 1. environment ----------------------------------------------------
    phase("environment")
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this script needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    from vk_raytrace_torch.ops import traverse_fused as tf

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"card: {card}", flush=True)

    # ---- 2. build -----------------------------------------------------------
    phase("build")
    from vk_raytrace_torch import runtime

    t0 = time.time()
    runtime.build()
    native_s = time.time() - t0
    t0 = time.time()
    lib_path = tf.build(verbose=True)
    kernel_s = time.time() - t0
    print(f"native runtime: {native_s:.2f} s; traverse kernel: {kernel_s:.2f} s -> "
          f"{os.path.relpath(lib_path, REPO)}", flush=True)

    # ---- 3. kernel vs twin on the full atrium ------------------------------
    phase("kernel vs twin")
    from vk_raytrace_torch import render as R
    from vk_raytrace_torch.models import procedural
    from vk_raytrace_torch.models.schema import PBR_GLTF, RenderConfig
    from vk_raytrace_torch.ops.bvh8 import build_accel_bundle

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
    errors, times = {}, {}
    for mode, (planar, oo, dd, tm, cull) in cases.items():
        kern = tf.traverse(planar, oo, dd, tm, mode=mode, cull=cull)
        twin = tf._traverse_plain(planar, oo, dd, tm, None, mode, cull)
        torch.cuda.synchronize()
        errors[mode] = compare(mode, kern, twin)
        hit_share = float((kern[1] >= 0).float().mean())
        steps = float(kern[4].float().mean())
        ms = cuda_time(lambda: tf.traverse(planar, oo, dd, tm, mode=mode, cull=cull), 20)
        plain_ms = cuda_time(lambda: tf._traverse_plain(planar, oo, dd, tm, None, mode, cull), 2)
        times[mode] = (ms, plain_ms)
        print(f"mode {mode}: {n} rays, hit share {hit_share:.4f}, mean nodes/ray "
              f"{steps:.2f}, max |err| {errors[mode]:.3g} -> OK; kernel {ms:.3f} ms, "
              f"twin {plain_ms:.3f} ms ({card})", flush=True)

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

    # ---- 5. main path ------------------------------------------------------
    phase("main path")
    t0 = time.time()
    scene = R.build_scene(geom, mats, lights, cam, atlas=atlas)
    tables_s = time.time() - t0
    cfg = RenderConfig(width=1920, height=1080, max_depth=4, max_samples=1, pbr_mode=PBR_GLTF,
                       firefly_clamp=10.0, use_sun_sky=True)
    torch.cuda.reset_peak_memory_stats(dev)
    tf.reset_launches()
    t0 = time.time()
    r = R.Renderer(scene, cfg, device=dev)
    renderer_s = time.time() - t0
    build = {"scene_gen_s": scene_gen_s, "scene_tables_s": tables_s,
             "renderer_s": renderer_s, **r.build_times}
    t0 = time.time()
    r.step()
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    frame_s, frame_rays = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        r.step()
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
        frame_rays.append(r.last_rays)
    launches = dict(tf.LAUNCHES)
    img = r.accum.cpu().numpy()
    ldr = r.postprocess().cpu().numpy()
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    s_frame = float(np.mean(frame_s))
    mrays = float(np.sum(frame_rays) / np.sum(frame_s) / 1e6)
    build_txt = ", ".join(f"{k} {v:.2f}" for k, v in build.items())
    print(f"warm-up frame {warm_s:.3f} s; frames {['%.4f' % s for s in frame_s]} s; "
          f"rays/frame {frame_rays}; launches {launches}")
    assert all(launches[m] > 0 for m in tf.MODES), f"a traversal mode never launched: {launches}"
    assert np.isfinite(img).all() and np.isfinite(ldr).all(), "non-finite pixels"
    assert img.mean() > 0.0 and ldr.max() > 0.0, "black image"
    assert min(frame_rays) > 1920 * 1080, "fewer rays than primary rays"
    print(f"atrium 1080p d4 1spp: {s_frame:.4f} s/frame, {mrays:.4f} Mrays/s, "
          f"peak {peak_mb:.1f} MiB allocated, mean radiance {img.mean():.4f}; "
          f"build s: {build_txt} [{card}]", flush=True)

    kernels = [
        {"name": f"traverse_{m}", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
         "launches": launches[m], "max_abs_err": errors[m], "ms": times[m][0],
         "plain_ms": times[m][1]}
        for m in tf.MODES
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
