"""The application path runs without JAX and without Pillow, which the
card's machine does not have (split by subject from
``tests/test_torch_nojax.py``, whose ``_run`` runs each script in a fresh
interpreter): the CLI on quirks.glb (the glTF loader, the PNG codec, the
scene cache and the profiler), the CLI on two-level scenes beyond 512
instances and of alpha-tested triangles alone, and the last modules (the
viewer over HTTP, ``parallel/sharding.py`` through ``graft_entry``'s
spawned ranks, ``utils/stepcount.py``, the graft entry and the JPEG
decoder through the CLI on ``tests/assets/jpeg_textures.glb``)."""

from test_torch_nojax import _run

APP_SCRIPT = """
import os, sys, tempfile
import numpy as np
from vk_raytrace_torch import cli
from vk_raytrace_torch.models import gltf
from vk_raytrace_torch.utils import cache, png, profiler

with tempfile.TemporaryDirectory() as d:
    os.environ[cache.ENV] = os.path.join(d, "cache")
    out = os.path.join(d, "q.png")
    for _ in range(2):  # the second run loads its accel from the cache
        assert cli.main(["--device", "cpu", "-f", os.path.join("tests", "assets", "quirks.glb"),
                         "--instancing", "bake", "--size", "32", "24", "--depth", "3", "--spp", "1",
                         "--profile", "-o", out]) == 0
    assert len(os.listdir(os.path.join(d, "cache"))) == 1
    img = png.decode_rgba(open(out, "rb").read())
    assert img.shape == (24, 32, 4) and img[..., :3].max() > 0
    g, m, l, c, a = gltf.load_gltf(os.path.join("tests", "assets", "quirks.glb"), instancing="auto")
    assert a is not None and len(g) == 2
for name in ("jax", "vk_raytrace_tpu", "PIL"):
    assert name not in sys.modules, sorted(m for m in sys.modules if m.startswith(name))
print("ok")
"""


PLAZA_SCRIPT = """
import os, sys, tempfile
import numpy as np
import chip_smoke
from vk_raytrace_torch import cli
from vk_raytrace_torch.utils import png

with tempfile.TemporaryDirectory() as d:
    for name, kw in (("plaza", {}), ("foliage", dict(ground=False, trunks=False))):
        path = os.path.join(d, name + ".gltf")
        chip_smoke.write_plaza(path, nx=15, nz=20, trunk_segments=6, trunk_rings=2, cards=4, **kw)
        out = os.path.join(d, name + ".png")
        assert cli.main(["--device", "cpu", "-f", path, "--size", "16", "12", "--depth", "2",
                         "--spp", "1", "--sun-sky", "-o", out]) == 0
        assert png.decode_rgba(open(out, "rb").read()).shape == (12, 16, 4)
for name in ("jax", "vk_raytrace_tpu", "PIL"):
    assert name not in sys.modules, sorted(m for m in sys.modules if m.startswith(name))
print("ok")
"""


LAST_MODULES_SCRIPT = """
import json, os, sys, tempfile, threading, time, urllib.request
import numpy as np
from vk_raytrace_torch import cli, graft_entry, viewer
from vk_raytrace_torch.models import procedural
from vk_raytrace_torch.models.schema import RenderConfig
from vk_raytrace_torch import render as R
from vk_raytrace_torch.utils import cache, png, stepcount

with tempfile.TemporaryDirectory() as d:
    os.environ[cache.ENV] = os.path.join(d, "cache")
    out = os.path.join(d, "j.png")
    assert cli.main(["--device", "cpu", "-f", os.path.join("tests", "assets", "jpeg_textures.glb"),
                     "--size", "32", "18", "--depth", "2", "--spp", "1", "-o", out]) == 0
    assert png.decode_rgba(open(out, "rb").read()).shape == (18, 32, 4)
    svc = viewer.ViewerService(viewer.build_parser().parse_args(
        ["--device", "cpu", "--scene", "cornell", "--size", "16", "16", "--depth", "2"]))
    t = threading.Thread(target=svc.run_render_loop, daemon=True)
    t.start()
    httpd = viewer.serve(svc, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    t0 = time.time()
    while json.loads(urllib.request.urlopen(url + "/state").read())["frame"] < 1:
        assert time.time() - t0 < 120
        time.sleep(0.1)
    assert png.decode_rgba(urllib.request.urlopen(url + "/frame.png").read()).shape == (16, 16, 4)
    httpd.shutdown()
    httpd.server_close()
    svc._stop = True
    t.join(60)
    assert not t.is_alive()
    fn, args = graft_entry.entry("cpu")
    assert float(fn(*args).mean()) > 0.0
    graft_entry.dryrun_multichip(2, timeout_s=240)
    g, m, l, c = procedural.cornell_box()
    scene = R.build_scene(g, m, l, c)
    o, d = stepcount.primary_rays(scene, 32, 32, 4, 4)
    r = R.Renderer(scene, RenderConfig(width=8, height=8), device="cpu")
    rows = r.packed.opaque_planar.rows.numpy()
    assert stepcount.count_rows(rows, 16, o, d).min() >= 1
for name in ("jax", "vk_raytrace_tpu", "PIL"):
    assert name not in sys.modules, sorted(m for m in sys.modules if m.startswith(name))
print("ok")
"""


def test_application_path_never_imports_jax_or_pillow():
    """The CLI on quirks.glb (textures decoded by the port's PNG decoder,
    the accel cached and loaded again, the PNG written by its encoder), the
    glTF loader in two levels, the cache and the profiler: neither JAX, nor
    the JAX package, nor Pillow, which the card's machine does not have."""
    _run(APP_SCRIPT)


def test_large_two_level_path_never_imports_jax_or_pillow():
    """The CLI on plaza glTFs written by ``chip_smoke.write_plaza``: 601
    instances (the chunked candidate scan) and the foliage alone (every
    triangle alpha-tested: the instance-level split)."""
    _run(PLAZA_SCRIPT)


def test_last_modules_never_import_jax_or_pillow():
    """The viewer (its render loop and HTTP server), the graft entry and
    ``dryrun_multichip`` (spawned gloo ranks), ``utils/stepcount.py`` and
    the JPEG textures of ``jpeg_textures.glb`` through the CLI."""
    _run(LAST_MODULES_SCRIPT)
