#!/usr/bin/env python3
"""Is the card's image the same from run to run?

    python3 chip_repro.py [--renders N]

Two checks on one GPU, each across fresh processes (the parent starts every
child in turn and compares what they wrote):

1. the environment: the full atrium's sun&sky baked and importance-sampled
   on the card as ``render.prepare_sun_sky`` builds it for the main path
   (the baked image, and ``models/hdr.build_environment``'s alias table
   ``q`` and ``alias``, the pdfs and the packed rows), built twice in each
   of two processes, every array compared byte for byte and its SHA-256
   printed;
2. an image: the all-alpha plaza through the CLI on the card
   (``chip_smoke.py`` phase 30's arguments: 128x72, depth 4, 2 spp,
   sun&sky, glTF) rendered ``N`` times (default 3), one process each, the
   HDR outputs compared byte for byte with the first.

Prints the card's name and power limit first and one JSON line last
(``{"repro": {...}}``); exits 1 if any two builds or renders differ.
"""

import hashlib
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

import chip_smoke
from chip_smoke import ENV_ARRAYS

HERE = os.path.dirname(os.path.abspath(__file__))
CLI_ARGS = ["--sun-sky", "--size", "128", "72", "--depth", "4", "--spp", "2", "--pbr", "gltf"]


def env_arrays(dev):
    """The atrium's sun&sky environment built on ``dev`` as the main path's
    renderer builds it: its arrays as numpy, by name."""
    from vk_raytrace_torch import render as R
    from vk_raytrace_torch.models import procedural
    from vk_raytrace_torch.models.schema import RenderConfig

    geom, mats, lights, cam, atlas = procedural.atrium_scene()
    scene = R.build_scene(geom, mats, lights, cam, atlas=atlas)
    env = R.prepare_sun_sky(scene, RenderConfig(use_sun_sky=True), dev)[0].env
    return {k: v.cpu().numpy() for k, v in chip_smoke.environment_arrays(env).items()}


def one_env(path):
    """Child: two builds on the card, saved as ``a_<key>`` and ``b_<key>``."""
    builds = [env_arrays(torch.device("cuda", 0)) for _ in range(2)]
    np.savez(path, **{f"{tag}_{k}": b[k] for tag, b in zip("ab", builds) for k in ENV_ARRAYS})


def one_render(scene_path, out_path):
    """Child: the CLI on the card over ``scene_path``, the HDR to ``out_path``."""
    from vk_raytrace_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        rc = cli.main(["-f", scene_path, *CLI_ARGS, "-o", os.path.join(tmp, "out.png"),
                       "--hdr-out", out_path])
    if rc != 0:
        raise SystemExit(f"the CLI returned {rc}")


def child(*args):
    subprocess.run([sys.executable, os.path.abspath(__file__), *args], check=True, cwd=HERE)


def digest(x):
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()[:16]


def main(argv):
    if argv[:1] == ["--one-env"]:
        return one_env(argv[1])
    if argv[:1] == ["--one-render"]:
        return one_render(argv[1], argv[2])
    n_renders = int(argv[argv.index("--renders") + 1]) if "--renders" in argv else 3
    if not torch.cuda.is_available():
        raise SystemExit("chip_repro.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    chip_smoke.build_kernels()
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        builds = []
        for p in range(2):
            path = os.path.join(tmp, f"env{p}.npz")
            child("--one-env", path)
            z = np.load(path)
            builds += [{k: z[f"{tag}_{k}"] for k in ENV_ARRAYS} for tag in "ab"]
        for k in ENV_ARRAYS:
            same = [np.array_equal(b[k].view(np.uint8), builds[0][k].view(np.uint8))
                    for b in builds[1:]]
            print(f"env {k} {builds[0][k].dtype}{list(builds[0][k].shape)}: sha256 "
                  + " ".join(digest(b[k]) for b in builds)
                  + f" (process 1 build 1, 1 2, 2 1, 2 2): "
                  + ("equal" if all(same) else "DIFFER"), flush=True)
            result[f"env_{k}_equal"] = all(same)
        scene = os.path.join(tmp, "foliage.gltf")
        chip_smoke.write_plaza(scene, **chip_smoke.PLAZA, ground=False, trunks=False)
        images = []
        for i in range(n_renders):
            path = os.path.join(tmp, f"render{i}.npy")
            child("--one-render", scene, path)
            images.append(np.load(path))
        for i, img in enumerate(images[1:], 1):
            differ = int((img.view(np.uint32) != images[0].view(np.uint32)).any(-1).sum())
            print(f"render {i + 1} against render 1: {differ} of {img.shape[0] * img.shape[1]} "
                  f"pixels differ; sha256 {digest(img)} / {digest(images[0])}", flush=True)
            result[f"render_{i + 1}_pixels_differ"] = differ
    ok = all(v is True or v == 0 for v in result.values())
    print(json.dumps({"repro": {**result, "ok": ok}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]) or 0)
