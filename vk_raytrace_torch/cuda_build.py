"""Build the port's CUDA kernels: ``nvcc`` into a shared library with a plain
C interface, loaded through ctypes by each kernel's wrapper.

Every kernel source lives in ``csrc/`` and is built with the same flags:
``sm_90a`` (Hopper), and float arithmetic rounded per operation (no FMA
contraction, IEEE division and square root, denormals kept), so that a
kernel and its plain torch version round alike. A library is rebuilt when
it is missing or older than its source or a header of ``csrc/``
(:func:`compile_if_stale`, which the native host runtime's g++ build
shares); builds go into ``_build/``.
"""

from __future__ import annotations

import glob
import os
import re
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-shared", "-Xcompiler", "-fPIC",
]


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def compile_if_stale(out: str, src_path: str, cmd: list, deps=()) -> str:
    """Run ``cmd + ["-o", tmp, src_path]`` and move ``tmp`` to ``out`` unless
    ``out`` is newer than its source and each of ``deps`` (the headers it
    includes). Returns the compiler's stderr ("" when nothing was built);
    raises with its output when it fails."""
    newest = max(os.path.getmtime(f) for f in (src_path, *deps))
    if os.path.exists(out) and os.path.getmtime(out) >= newest:
        return ""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = out + f".{os.getpid()}.tmp"
    full = [*cmd, "-o", tmp, src_path]
    res = subprocess.run(full, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"build failed ({' '.join(full)}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return res.stderr


def build(name: str, src: str, verbose: bool = False, defines=()) -> str:
    """Compile ``csrc/<src>`` into ``_build/lib<name>.so`` unless the library
    is newer than the source and the headers of ``csrc/``, with ``-D`` of
    each of ``defines`` (one source can make several libraries). What
    ``-Xptxas -v`` reports (registers, spills, stack frame) is kept beside the
    library (:func:`resources`) and, with ``verbose``, printed. Returns the
    library path."""
    out = lib_path(name)
    flags = [*NVCC_FLAGS, *(f"-D{d}" for d in defines), "-Xptxas", "-v"]
    log = compile_if_stale(out, os.path.join(CSRC, src), [nvcc(), *flags],
                           deps=glob.glob(os.path.join(CSRC, "*.cuh")))
    if log:
        with open(out + ".ptxas", "w") as f:
            f.write(log)
    if verbose and log:
        print(log.strip())
    return out


def resources(name: str, entry: str) -> dict:
    """What ptxas reported for the first kernel of library ``name`` whose
    mangled name contains ``entry``: registers, stack frame, spill stores
    and loads, static shared memory (bytes). Raises where the build kept no
    report or it names no such kernel."""
    with open(lib_path(name) + ".ptxas") as f:
        log = f.read()
    for chunk in log.split("Compiling entry function '")[1:]:
        if entry not in chunk.split("'", 1)[0]:
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", chunk)
        regs = re.search(r"Used (\d+) registers", chunk)
        smem = re.search(r"(\d+) bytes smem", chunk)
        return {"registers": int(regs.group(1)), "stack_frame": int(frame.group(1)),
                "spill_stores": int(frame.group(2)), "spill_loads": int(frame.group(3)),
                "smem": int(smem.group(1)) if smem else 0}
    raise KeyError(f"no kernel {entry!r} in the ptxas report of lib{name}.so")
