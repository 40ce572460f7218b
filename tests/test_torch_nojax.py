"""The port runs without JAX: in a fresh interpreter, import the package,
build the Cornell box with its own (numpy + native runtime) pipeline,
render one 32x32 frame on the CPU, and check that neither JAX nor the JAX
package was ever imported."""

import os
import subprocess
import sys

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


def test_port_never_imports_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")
