"""The port runs without JAX: in a fresh interpreter, import the package,
build the Cornell box with its own (numpy + native runtime) pipeline,
render one 32x32 frame on the CPU, and check that neither JAX nor the JAX
package was ever imported; the same for the two-level path (instance
tables, ``ops/tlas.py``, the small bistro through the fused stage), for
the width-32 builds (``build_bvh32``) with the traversal micro-bench
(``vk_raytrace_torch.travbench``) and for the Disney BSDF, the debug modes,
the BASELINE #2/#4 scenes and the brute-force anchor; and, statically,
that no import statement of the package or of the chip scripts
(``chip_smoke.py``, ``chip_ab.py``, ``chip_profile.py``, ``chip_repro.py``,
``chip_frames.py``) names JAX or the JAX package, and that the chip
scripts import without them; the pooled loop alone, with its records and
its tiers. The application path and the last modules (also without
Pillow) are in ``tests/test_torch_nojax_app.py``, split by subject (tier-1
runs a file on one worker)."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import sys
import numpy as np
import vk_raytrace_torch
from vk_raytrace_torch import render as R
from vk_raytrace_torch.models import procedural
from vk_raytrace_torch.models.schema import PBR_GLTF, RenderConfig

g, m, l, c = procedural.cornell_box()
r = R.Renderer(R.build_scene(g, m, l, c), RenderConfig(width=32, height=32, max_depth=3,
               pbr_mode=PBR_GLTF), device="cpu")
img = r.render(1)
assert img.shape == (32, 32, 3) and np.isfinite(img).all() and img.mean() > 0.05
assert r.last_rays > 32 * 32
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
assert "vk_raytrace_tpu" not in sys.modules, sorted(
    m for m in sys.modules if m.startswith("vk_raytrace_tpu"))
print("ok")
"""


INSTANCED_SCRIPT = """
import sys
import numpy as np
from vk_raytrace_torch import render as R
from vk_raytrace_torch.models import instances, procedural
from vk_raytrace_torch.models.schema import PBR_GLTF, RenderConfig
from vk_raytrace_torch.ops import tlas

pool, inst, m, l, c, a = procedural.bistro_scene(detail=0.05)
assert isinstance(pool, instances.MeshPool)
scene = R.build_instanced_scene(pool, inst, m, l, c, atlas=a)
assert isinstance(scene.instances, tlas.InstancedAccel)
r = R.Renderer(scene, RenderConfig(width=32, height=18, max_depth=3, pbr_mode=PBR_GLTF,
               use_sun_sky=True, full_mis=False), device="cpu", fused_shade=True)
img = r.render(1)
assert np.isfinite(img).all() and img.mean() > 0.05 and r.last_rays > 32 * 18
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
assert "vk_raytrace_tpu" not in sys.modules, sorted(
    m for m in sys.modules if m.startswith("vk_raytrace_tpu"))
print("ok")
"""


TRAVBENCH_SCRIPT = """
import sys
import numpy as np
from vk_raytrace_torch import runtime, travbench
from vk_raytrace_torch.models import procedural

g, m, l, c = procedural.city_scene(n_blocks=6)
rows, depth = runtime.build_planar_rows(g.positions, g.indices, g.uv, g.tri_flags, width=32)
assert rows.shape[1] == 256 and depth >= 1
travbench.main(["--device", "cpu", "--small", "--rays", "64", "--reps", "1"])
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
assert "vk_raytrace_tpu" not in sys.modules, sorted(
    m for m in sys.modules if m.startswith("vk_raytrace_tpu"))
print("ok")
"""


DISNEY_SCRIPT = """
import sys
import numpy as np
from vk_raytrace_torch import render as R
from vk_raytrace_torch.integrator import brute
from vk_raytrace_torch.models import hdr, procedural
from vk_raytrace_torch.models.schema import DEBUG_HEATMAP, DEBUG_NORMAL, PBR_GLTF, RenderConfig

env = hdr.build_environment(hdr.procedural_sky_hdr())
g, m, l, c = procedural.material_test_grid(n=2)
scene = R.build_scene(g, m, l, c, env=env)
r = R.Renderer(scene, RenderConfig(width=24, height=16, max_depth=3), device="cpu")
img = r.render(1)
assert np.isfinite(img).all() and img.mean() > 0.01 and r.last_rays > 24 * 16
for mode in (DEBUG_NORMAL, DEBUG_HEATMAP):
    r = R.Renderer(scene, RenderConfig(width=24, height=16, max_depth=2, debug_mode=mode),
                   device="cpu")
    r.step()
    assert np.isfinite(r.hdr().numpy()).all() and r.hdr().numpy().max() > 0.0
g, m, l, c, a = procedural.helmet_scene(n_lat=8, n_lon=16)
r = R.Renderer(R.build_scene(g, m, l, c, env=env, atlas=a),
               RenderConfig(width=16, height=16, max_depth=2, pbr_mode=PBR_GLTF), device="cpu",
               fused_shade=True)
assert r.stage == "fused"
r.step()
tracer = brute.BruteTracer(r.scene.geometry)
img = brute.anchor_render(r.scene, r.packed, r._run_cfg, 1, r.features, tracer=tracer)
assert np.isfinite(img.numpy()).all()
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
assert "vk_raytrace_tpu" not in sys.modules, sorted(
    m for m in sys.modules if m.startswith("vk_raytrace_tpu"))
print("ok")
"""


def _run(script):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")


def test_port_never_imports_jax():
    _run(SCRIPT)


WAVEFRONT_SCRIPT = """
import sys
import numpy as np
from vk_raytrace_torch import render as R
from vk_raytrace_torch.integrator import pool, wavefront
from vk_raytrace_torch.models import procedural
from vk_raytrace_torch.models.schema import PBR_GLTF, RenderConfig

g, m, l, c = procedural.cornell_box()
r = R.Renderer(R.build_scene(g, m, l, c), RenderConfig(width=32, height=32, max_depth=3,
               max_samples=16, pbr_mode=PBR_GLTF), device="cpu")
img, rays, steps, occ = wavefront.render_units_pooled(
    r.scene, r.packed, r._run_cfg, 1, 0, 32 * 32, 8192, features=r.features,
    track_steps=True, track_occupancy=True)
n_it = int((occ >= 0).sum())
assert img.shape == (32 * 32, 3) and np.isfinite(img.numpy()).all() and int(rays) > 16 * 32 * 32
assert wavefront.LOOP["host_reads"] >= n_it > 2 and int(occ[0]) == 8192 and int(occ[n_it - 1]) <= 512
assert steps.shape == (32 * 32,) and float((steps > 0).float().mean()) > 0.5
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
assert "vk_raytrace_tpu" not in sys.modules
print("ok")
"""


def test_wavefront_loop_never_imports_jax():
    """The pooled loop with its step and occupancy records and the tiered
    tail (``integrator/wavefront.py``, ``integrator/pool.py``)."""
    _run(WAVEFRONT_SCRIPT)


def test_instanced_path_never_imports_jax():
    _run(INSTANCED_SCRIPT)


def test_width32_and_travbench_never_import_jax():
    _run(TRAVBENCH_SCRIPT)


def test_disney_debug_and_anchor_never_import_jax():
    """The Disney BSDF on the material grid under the procedural sky, two
    debug modes through the strips, the helmet, and the brute-force anchor."""
    _run(DISNEY_SCRIPT)


def _non_doc_strings(tree):
    """String constants of a module other than its docstrings."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    return [
        n.value for n in ast.walk(tree)
        if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs
    ]


def test_port_builds_only_its_own_sources():
    """The port compiles sources under ``vk_raytrace_torch/`` only, and no
    module of it names a path of the JAX package outside docstrings and
    comments."""
    from vk_raytrace_torch import cuda_build, runtime

    pkg = os.path.join(ROOT, "vk_raytrace_torch")
    for src in (runtime._SRC, cuda_build.CSRC):
        assert os.path.commonpath([os.path.abspath(src), pkg]) == pkg, src
    offenders = []
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            path = os.path.join(dirpath, f)
            if f.endswith(".py"):
                with open(path) as fh:
                    strings = _non_doc_strings(ast.parse(fh.read()))
                offenders += [(path, s) for s in strings if "vk_raytrace_tpu" in s]
            elif f.endswith((".cu", ".cuh", ".cpp", ".h")):
                with open(path) as fh:
                    offenders += [(path, ln) for ln in fh
                                  if ln.startswith("#include") and "vk_raytrace_tpu" in ln]
    assert not offenders, offenders


def _jax_imports(path):
    """Import statements of a module, at any depth, that name JAX or the JAX
    package."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "vk_raytrace_tpu")]


CHIP_SCRIPTS = ("chip_smoke.py", "chip_ab.py", "chip_profile.py", "chip_repro.py",
                "chip_frames.py")


@pytest.mark.parametrize("where", ("vk_raytrace_torch",) + CHIP_SCRIPTS)
def test_no_jax_import_statement(where):
    """No module of the port and none of the chip scripts imports JAX or the
    JAX package, not even inside a function (the chip machine runs them
    without JAX)."""
    path = os.path.join(ROOT, where)
    files = [path] if where.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs if f.endswith(".py")]
    offenders = [(f, n) for f in files for n in _jax_imports(f)]
    assert not offenders, offenders


def test_chip_scripts_import_without_jax():
    """Importing the chip scripts in a fresh interpreter loads neither JAX
    nor the JAX package."""
    _run("import sys\n" + "".join(f"import {s[:-3]}\n" for s in CHIP_SCRIPTS) + """
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
assert "vk_raytrace_tpu" not in sys.modules
print("ok")
""")
