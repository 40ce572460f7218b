#!/usr/bin/env python3
"""Run one cell of the benchmark of ``vk_raytrace_torch`` once.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cell's CUDA devices.
Prints one JSON line last on standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
``setup_built``: what set-up built into the program's caches, and last
``compared``: each compared number beside its limit), and the compared
numbers as the last lines of standard error. Exits with a code other than
0, and prints no result, without enough CUDA devices or when a module of
JAX or of the JAX package was loaded. See ``rtbench/bench.py``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The program's caches at fixed paths inside the checkout: the accel bundles
# of its scene cache and the CUDA driver's cache (the libraries themselves
# build into vk_raytrace_torch/_build).
CACHE = os.path.join(ROOT, "rtbench", ".cache")
os.environ["VKRT_TORCH_SCENE_CACHE"] = os.path.join(CACHE, "scene")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from rtbench import bench

    sys.exit(bench.main(sys.argv[1:], T_START))
