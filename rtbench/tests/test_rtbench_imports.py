"""What the benchmark imports: nothing of JAX or the JAX package anywhere
under ``rtbench/``, and nothing of the port in the reference and the frozen
scenes. Each import's top-level name (before the first dot) is compared
whole: ``vk_raytrace_torch`` begins with the letters of ``vk_raytrace_tpu``."""

import ast
import os
import subprocess
import sys

import pytest

from rtbench import bench

RT = os.path.join(bench.ROOT, "rtbench")
JAX = {"jax", "jaxlib", "flax", "vk_raytrace_tpu"}


def _imports(path):
    """Top-level names of the modules a source file imports (absolute)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            out |= {a.name.split(".")[0] for a in n.names}
        elif isinstance(n, ast.ImportFrom) and n.level == 0:
            out.add(n.module.split(".")[0])
    return out


def _sources(*parts):
    top = os.path.join(RT, *parts)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_under_rtbench_imports_jax():
    for path in _sources():
        assert not _imports(path) & JAX, path


@pytest.mark.parametrize("part", ["reference", "scenes"])
def test_reference_imports_nothing_of_the_program(part):
    for path in _sources(part):
        names = _imports(path)
        assert not names & (JAX | {"vk_raytrace_torch"}), path
        allowed = {"__future__", "dataclasses", "importlib", "math", "typing", "types", "numpy",
                   "torch"}
        assert names <= allowed, (path, names)


def test_top_level_names_compare_whole():
    assert "vk_raytrace_torch".split(".")[0] not in JAX
    assert "vk_raytrace_tpu.ops".split(".")[0] in JAX


def test_a_run_refuses_without_cuda_and_prints_no_result():
    code = ("import runpy, sys, torch; torch.cuda.is_available = lambda: False; "
            "sys.argv = ['run.py', '--workload', 'atrium.accumulate-1080p-d4', '--seed', '1', "
            "'--seconds', '1', '--trace', '0']; "
            f"runpy.run_path({os.path.join(RT, 'run.py')!r}, run_name='__main__')")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_a_run_refuses_when_jax_was_loaded(monkeypatch):
    monkeypatch.setitem(sys.modules, "vk_raytrace_tpu.render", object())
    monkeypatch.setitem(sys.modules, "vk_raytrace_tpu_extra", object())
    found = bench.loaded_forbidden()
    assert "vk_raytrace_tpu.render" in found and "vk_raytrace_tpu_extra" not in found
    assert not any(m.split(".")[0] == "vk_raytrace_torch" for m in found)
