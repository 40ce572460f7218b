#!/usr/bin/env python3
"""The check's control: the reference put in the program's place, computed
in the precision below the configuration's.

    python3 rtbench/control.py --workload <cell> --seeds 11,12,13 --frames N [--device cuda]

For each seed, the plain reference renders the check's pixels (drawn from
the seed, as a run draws them) over ``N`` frames from the seed's start
frame twice: with its path state in float32, the configuration's precision,
and in bfloat16 (``Reference(..., state_dtype=torch.bfloat16)``). The
control's readings are the cell's compared numbers (``image_gap``,
``pixel_gap_median``) of the bfloat16 accumulation against the float32 one;
the limits must lie well below them.
Prints one JSON line a seed. Give ``N`` as many frames as a run's window
holds (``attempted`` plus the warm-up frames of a run's result).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def control_gap(cell, seed: int, frames: int, device, scene=None) -> dict:
    """One seed's control reading: ``{"seed", "frames", <each compared
    number of the cell's check>, "seconds"}``."""
    import torch

    from rtbench import bench, scenes

    if scene is None:
        scene = scenes.generate(cell.config["scene"])
    t = cell.traffic
    pixels = bench.check_pixels(seed, t["width"] * t["height"], int(cell.check["pixels"]))
    first = bench.start_frame(seed)
    span = range(first, first + frames)
    ref, s32 = bench.reference_accum(scene, cell, pixels, span, device)
    low, s16 = bench.reference_accum(scene, cell, pixels, span, device, state_dtype=torch.bfloat16)
    return {"seed": seed, "frames": frames,
            **{k: bench.COMPARED[k](low, ref) for k in cell.check["limits"]},
            "seconds": [s32, s16]}


def main(argv) -> int:
    import argparse
    import json

    from rtbench import bench, scenes

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--frames", type=int, required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    cell = bench.load_cell(a.workload)
    scene = scenes.generate(cell.config["scene"])
    for seed in (int(s) for s in a.seeds.split(",")):
        out = control_gap(cell, seed, a.frames, a.device, scene)
        print(json.dumps({"workload": a.workload, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
