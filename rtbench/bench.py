"""One run of one benchmark cell of ``vk_raytrace_torch`` (see ``run.py``).

A cell ``<config>.<traffic>`` of ``BENCHMARK.json`` names its files, found by
name: ``configs/<config>.json`` (the scene's generator and the render
settings), ``traffic/<traffic>.json`` (image size, path depth, samples a
frame), ``checks/<cell>.json`` (the check's pixels and limits), and a reader
a metric (``endtoend/<name>.py``, ``metrics/<name>.py``). A new scene, mix
or metric is new files and entries; this file does not change.

A run has three stages:

1. Set-up: the port's libraries from its own build directory, the
   configuration's scene from the frozen generators (``rtbench/scenes``),
   built through the port's normal path (``render.build_scene`` or
   ``build_instanced_scene``, then ``render.Renderer(...,
   fused_shade=True)``), the progressive sequence started at frame
   ``F0 = 1 + seed mod 2**10`` from an empty accumulation
   (``Renderer.load_state``, the program's resume), then the warm-up frames.
   A run that builds a library or an acceleration structure into the
   program's caches says so (``setup_built`` in its result).
2. The window: ``Renderer.step()`` frame after frame, each ended by
   ``torch.cuda.synchronize()``, for ``--seconds``; with ``--trace 1`` the
   window's last ``trace_seconds`` run under ``torch.profiler``.
3. The check: once the window has closed, the peak memory read and the
   program freed, the plain reference (``rtbench/reference``) renders the
   paths of pixels drawn from the seed in every frame the accumulation
   holds, accumulates them as the program's running mean does, and that is
   compared with the program's accumulation there.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

T_IMPORTED = time.perf_counter()  # numpy and torch loaded
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Top-level module names that may not be loaded in a run: JAX and the JAX
# package (compared whole: the port's name begins with the latter's).
FORBIDDEN = ("jax", "jaxlib", "flax", "vk_raytrace_tpu")
FRAME_MOD = 1 << 10
BATCH_PATHS = 1 << 16


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list   # metric names the cell reports with --trace 0
    per_layer: list    # with --trace 1
    root: str = ROOT   # the checkout the cell's files came from


@dataclasses.dataclass
class Run:
    """What the window gave: the end-to-end readers' input."""

    setup_s: float
    frame_s: list
    frame_rays: list
    window_s: float
    peak_bytes: int
    frame_samples: int   # paths a frame: width x height x spp


def _json(path):
    with open(path) as f:
        return json.load(f)


def _covers(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    here = os.path.join(root, "rtbench")
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(os.path.join(here, "configs", f"{w['config']}.json")),
        traffic=_json(os.path.join(here, "traffic", f"{w['traffic']}.json")),
        check=_json(os.path.join(here, "checks", f"{name}.json")),
        end_to_end=[m["name"] for m in bench["end_to_end"] if _covers(m, name)],
        per_layer=[m["name"] for m in bench["per_layer"] if _covers(m, name)], root=root,
    )


def load_reader(kind: str, name: str, root: str = ROOT):
    """The reader module ``rtbench/<kind>/<name>.py``."""
    path = os.path.join(root, "rtbench", kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"rtbench_{kind}_{name}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def claimed_kernels(root: str = ROOT) -> set:
    """Every kernel name some per-layer metric reads."""
    out = set()
    for f in sorted(os.listdir(os.path.join(root, "rtbench", "metrics"))):
        if f.endswith(".py"):
            out |= set(load_reader("metrics", f[:-3], root).KERNELS)
    return out


# ---------------------------------------------------------------------------
# Set-up: the scene through the port's normal path
# ---------------------------------------------------------------------------


def _port_table(cls, obj):
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


def render_config(cell: Cell):
    """The port's ``RenderConfig`` of the cell."""
    from vk_raytrace_torch.models import schema as S

    r, t = cell.config["render"], cell.traffic
    if r["pbr_mode"] != "gltf":
        raise ValueError(f"no pbr_mode {r['pbr_mode']!r} in this benchmark yet")
    return S.RenderConfig(
        width=t["width"], height=t["height"], max_depth=t["max_depth"], max_samples=t["spp"],
        pbr_mode=S.PBR_GLTF, firefly_clamp=r["firefly_clamp"], full_mis=r["full_mis"],
        hdr_multiplier=r["hdr_multiplier"], use_sun_sky=r["use_sun_sky"], max_frames=1 << 30,
    )


def port_scene(scene, cell: Cell):
    """The frozen generator's tables as the port's ``SceneData``."""
    from vk_raytrace_torch import render as R
    from vk_raytrace_torch.models import instances as I
    from vk_raytrace_torch.models import schema as S

    geom = _port_table(S.Geometry, scene.geometry)
    args = dict(materials=_port_table(S.Materials, scene.materials),
                lights=_port_table(S.Lights, scene.lights),
                camera=_port_table(S.Camera, scene.camera),
                atlas=_port_table(S.TextureAtlas, scene.atlas))
    if not scene.instanced:
        return R.build_scene(geom, **args)
    p = scene.pool
    pool = I.MeshPool(geom, p.tri_start, p.tri_count, p.aabb_min, p.aabb_max)
    return R.build_instanced_scene(pool, _port_table(I.InstanceTable, scene.instances), **args,
                                   width=cell.config["render"]["row_width"])


def start_frame(seed: int) -> int:
    """The frame at which the run starts its progressive sequence: frame 0
    (pixel centres) is never one, and it stays early enough that each new
    frame's weight in the running mean (``1 / (frame + 1)``) is one a
    progressive user's frames have."""
    return 1 + int(seed) % FRAME_MOD


def build_renderer(scene, cell: Cell, seed: int, device):
    """The port's renderer of the cell, resumed at the seed's start frame."""
    from vk_raytrace_torch import render as R

    cfg = render_config(cell)
    r = R.Renderer(port_scene(scene, cell), cfg, device=device,
                   fused_shade=cell.config["render"]["shading"] == "fused")
    if r.stage != cell.config["render"]["shading"]:
        raise RuntimeError(f"the renderer runs the {r.stage} stage, the configuration asks for "
                           f"{cell.config['render']['shading']}")
    r.load_state({"accum": torch.zeros(cfg.height, cfg.width, 3), "frame": start_frame(seed)})
    return r


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def step_timed(r, device):
    """One frame: ``(seconds, rays)``."""
    t0 = time.perf_counter()
    r.step()
    _sync(device)
    return time.perf_counter() - t0, r.last_rays


# ---------------------------------------------------------------------------
# The window
# ---------------------------------------------------------------------------


def run_window(r, seconds: float, device, trace_seconds: Optional[float] = None,
               snapshots: Optional[dict] = None):
    """Frames back to back for ``seconds`` (the last one ends past it).
    Returns ``(frame_s, frame_rays, window_s, traced)``; ``traced`` is
    ``(profile, frames, seconds, rays, counters)`` of the frames that
    started in the last ``trace_seconds``, which ran under the profiler, or
    None; ``counters`` maps each of ``snapshots`` (name -> a function of the
    renderer) to its readings as the trace started and as it ended."""
    snapshots = snapshots or {}
    frame_s, frame_rays = [], []
    prof, traced = None, None
    t0 = time.perf_counter()
    t_end = t0 + seconds
    trace_from = None if trace_seconds is None else t_end - trace_seconds
    n0 = tt0 = before = None
    while True:
        if trace_from is not None and prof is None and time.perf_counter() >= trace_from:
            before = {k: f(r) for k, f in snapshots.items()}
            prof = _profiler()
            prof.__enter__()
            n0, tt0 = len(frame_s), time.perf_counter()
        dt, rays = step_timed(r, device)
        frame_s.append(dt)
        frame_rays.append(rays)
        if time.perf_counter() >= t_end:
            break
    window_s = time.perf_counter() - t0
    if prof is not None:
        t_stop = time.perf_counter()
        prof.__exit__(None, None, None)
        counters = {k: (before[k], f(r)) for k, f in snapshots.items()}
        traced = (prof, len(frame_s) - n0, t_stop - tt0, int(sum(frame_rays[n0:])), counters)
    return frame_s, frame_rays, window_s, traced


def _profiler():
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def loaded_forbidden() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


# ---------------------------------------------------------------------------
# The check
# ---------------------------------------------------------------------------


def check_pixels(seed: int, n_pix: int, count: int) -> np.ndarray:
    """The pixels the check compares, drawn from the seed."""
    return np.sort(np.random.default_rng([int(seed), 0xC4EC]).choice(n_pix, count, replace=False))


def reference_accum(scene, cell: Cell, pixels: np.ndarray, frames: range, device,
                    state_dtype=torch.float32):
    """The plain reference's accumulation (P, 3) float32 at ``pixels`` after
    ``frames``, resumed empty at ``frames.start``, and its seconds. Each
    frame's radiance is the mean of its ``spp`` paths; the frames go into
    the running mean one by one in float32, the update of ``Renderer.step``
    (``accum + (new - accum) * (1 / (frame + 1))``)."""
    from rtbench.reference import Reference

    t0 = time.perf_counter()
    t = cell.traffic
    ref = Reference(scene, cell.config["render"], t["width"], t["height"], t["max_depth"],
                    t["spp"], device, state_dtype=state_dtype)
    pix = torch.as_tensor(pixels, dtype=torch.int64, device=device)
    fr = torch.arange(frames.start, frames.stop, dtype=torch.int64, device=device)
    pp = pix.repeat(len(frames))
    ff = fr.repeat_interleave(len(pixels))
    total = torch.zeros(pp.shape[0], 3, dtype=torch.float32, device=device)
    for s in range(t["spp"]):
        for b in range(0, pp.shape[0], BATCH_PATHS):
            out, _ = ref.paths(pp[b:b + BATCH_PATHS], ff[b:b + BATCH_PATHS], sample=s)
            total[b:b + out.shape[0]] += out.float()
    per_frame = (total / t["spp"]).reshape(len(frames), len(pixels), 3).cpu()
    accum = torch.zeros(len(pixels), 3, dtype=torch.float32)
    for i, f in enumerate(frames):
        accum = accum + (per_frame[i] - accum) * (1.0 / (f + 1.0))
    _sync(device)
    return accum.numpy(), time.perf_counter() - t0


def image_gap(program: np.ndarray, reference: np.ndarray) -> float:
    """A compared number: the program's accumulation at the check's pixels
    against the reference's, as the sum of absolute differences over the
    sum of the reference's magnitudes (every channel)."""
    p, r = program.astype(np.float64), reference.astype(np.float64)
    return float(np.abs(p - r).sum() / max(np.abs(r).sum(), 1e-30))


def pixel_gap_median(program: np.ndarray, reference: np.ndarray) -> float:
    """The median over the check's pixels of each pixel's gap (the sum over
    its channels of the absolute difference over that of the reference's
    magnitudes): what a typical pixel is off by. A path that turns another
    way at one pixel leaves it where it was; a running mean weighed wrong
    moves every pixel, by about ``1 / frame``."""
    p, r = program.astype(np.float64), reference.astype(np.float64)
    diff, mag = np.abs(p - r).sum(axis=1), np.abs(r).sum(axis=1)
    return float(np.median(np.where(diff == 0.0, 0.0, diff / np.maximum(mag, 1e-30))))


# The numbers a check file may hold, by name: the program's accumulation at
# the check's pixels against the reference's.
COMPARED = {"image_gap": image_gap, "pixel_gap_median": pixel_gap_median}


def _build_state(dirs) -> dict:
    """Every file under ``dirs`` with its modification time."""
    out = {}
    for d in dirs:
        for dirpath, _, files in os.walk(d):
            for f in files:
                p = os.path.join(dirpath, f)
                try:
                    out[p] = os.path.getmtime(p)
                except OSError:
                    pass
    return out


def cache_dirs() -> list:
    """The program's build and scene caches: what a run that compiles or
    builds an acceleration structure writes."""
    dirs = [os.path.join(ROOT, "vk_raytrace_torch", "_build")]
    scene_cache = os.environ.get("VKRT_TORCH_SCENE_CACHE", "")
    if scene_cache and scene_cache != "off":
        dirs.append(scene_cache)
    return dirs


# ---------------------------------------------------------------------------
# A whole run
# ---------------------------------------------------------------------------


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             log=print) -> dict:
    """Set-up, window and check of one run on ``device``; the result line's
    object."""
    from rtbench import scenes
    from rtbench import trace as tr

    cuda = torch.device(device).type == "cuda"
    built_before = _build_state(cache_dirs())
    marks = [("start", t_start), ("imports", max(t_start, T_IMPORTED))]
    if cuda:
        torch.empty(0, device=device)  # the context, before its counters are read
        torch.cuda.reset_peak_memory_stats(device)
    marks.append(("device", time.perf_counter()))
    scene = scenes.generate(cell.config["scene"])
    marks.append(("scene", time.perf_counter()))
    r = build_renderer(scene, cell, seed, device)
    marks.append(("renderer", time.perf_counter()))
    for _ in range(int(cell.traffic["warmup_frames"])):
        step_timed(r, device)
    if trace and cuda:  # the profiler's first start, kept out of the window
        with _profiler():
            step_timed(r, device)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    built = sorted(os.path.basename(p) for p, m in _build_state(cache_dirs()).items()
                   if built_before.get(p) != m)
    log("set-up s: " + ", ".join(f"{a} {b - t:.3f}" for (_, t), (a, b) in zip(marks, marks[1:]))
        + f" ({', '.join(f'{k} {v:.3f}' for k, v in r.build_times.items())}); built: "
        + (", ".join(built) or "nothing"), file=sys.stderr)

    readers = {n: load_reader("metrics", n, cell.root) for n in cell.per_layer} if trace else {}
    frame_s, frame_rays, window_s, traced = run_window(
        r, seconds, device, cell.traffic["trace_seconds"] if trace and cuda else None,
        {n: m.snapshot for n, m in readers.items() if hasattr(m, "snapshot")})

    ms = np.percentile(np.asarray(frame_s) * 1e3, [5, 25, 50, 75, 95])
    log(f"window: {len(frame_s)} frames in {window_s:.3f} s; frame ms p5/p25/p50/p75/p95 "
        + "/".join(f"{x:.3f}" for x in ms), file=sys.stderr)
    found = loaded_forbidden()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package were loaded: {', '.join(found)}")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    t = cell.traffic
    first = start_frame(seed)
    frames = r.frame - first
    pixels = check_pixels(seed, t["width"] * t["height"], int(cell.check["pixels"]))
    accum_at = r.accum.reshape(-1, 3)[torch.as_tensor(pixels, device=r.accum.device)].cpu().numpy()
    frame_samples = t["width"] * t["height"] * t["spp"]
    summary = tr.reduce(*traced) if traced else None
    del r, traced
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    limits = cell.check["limits"]
    if frames > 0:
        ref, check_s = reference_accum(scene, cell, pixels, range(first, first + frames), device)
        values = {k: COMPARED[k](accum_at, ref) for k in limits}
    else:  # the accumulation holds no frame: all of the reference is missing
        values, check_s = dict.fromkeys(limits, 1.0), 0.0
    compared = {k: {"value": values[k], "limit": float(limits[k])} for k in limits}
    log(f"check: {len(pixels)} pixels x {frames} frames (from frame {first}) against the "
        f"plain reference in {check_s:.3f} s", file=sys.stderr)

    run = Run(setup_s, frame_s, frame_rays, window_s, peak, frame_samples)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    metrics = {}
    if trace:
        if summary is not None:
            for name, m in readers.items():
                v = m.read(summary)
                if v is not None:
                    metrics[name] = {"value": float(v), "unit": m.UNIT}
            device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
            claimed = claimed_kernels(cell.root)
            rest = {k: v for k, v in summary.kernel_s.items() if k not in claimed}
            log("unclaimed kernels, device ms a traced frame: " + ", ".join(
                f"{k} {1e3 * v / summary.frames:.4f}"
                for k, v in sorted(rest.items(), key=lambda kv: -kv[1])), file=sys.stderr)
    else:
        for name in cell.end_to_end:
            m = load_reader("endtoend", name, cell.root)
            metrics[name] = {"value": float(m.read(run)), "unit": m.UNIT}
    for k, c in compared.items():
        log(f"compared {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    out = {"correct": all(c["value"] <= c["limit"] for c in compared.values()),
           "attempted": len(frame_s), "failed": 0, "metrics": metrics, "device": device_info}
    if summary is not None:
        out["breakdown"] = summary.breakdown()
    out["setup_built"] = built
    out["compared"] = compared
    return out


def main(argv, t_start: float) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cell = load_cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{a.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    out = run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda:0", t_start)
    found = loaded_forbidden()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0
