"""The wide back end end to end on the CPU: ``Renderer(renderer="wide")``,
the CLI's ``--renderer wide`` and the viewer's ``set renderer wide``.

* A frame of the reduced atrium (2x2 bays, 64x36, depth 4, 1 spp, glTF PBR,
  the sun&sky) with and without its alpha banners, against the reference's
  ``Renderer`` on its wide route (``VKRT_FUSED=0``, its default off the
  TPU) on the same bytes (``convert.from_reference``):
  ``tests/test_torch_render.py``'s criterion, at least 99% of pixels
  within rtol 1e-3 / atol 1e-4 and ray counts within 0.1%.
* ``cli.main([... "--device", "cpu", "--renderer", "wide"])`` on the
  Cornell box equals the same scene through ``Renderer(renderer="wide")``
  by hand bit for bit, and the reference CLI's ``--renderer wide`` under
  the same criterion; ``--stats`` counts the 8-wide rows.
* The viewer's ``set renderer wide`` control rebuilds the renderer over the
  same acceleration structure, keeps rendering, and its picks equal
  ``Renderer(renderer="wide").pick`` of a renderer built alike.
"""

import json
import threading
import time

import numpy as np
import pytest

from test_torch_render import _check
from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401
from vk_raytrace_tpu import cli as ref_cli
from vk_raytrace_tpu import render as ref_render
from vk_raytrace_tpu.models import procedural as ref_proc
from vk_raytrace_tpu.models.schema import PBR_GLTF, RenderConfig as RefConfig
from vk_raytrace_tpu.utils import cache as ref_cache
from vk_raytrace_torch import cli
from vk_raytrace_torch import render as R
from vk_raytrace_torch import viewer as V
from vk_raytrace_torch.convert import from_reference
from vk_raytrace_torch.models import procedural
from vk_raytrace_torch.models.schema import RenderConfig, default_sun_sky

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL_ATRIUM = dict(bays_x=2, bays_z=2, column_segments=16, column_rows=12)
CFG = dict(width=64, height=36, max_depth=4, max_samples=1, pbr_mode=PBR_GLTF,
           firefly_clamp=10.0, use_sun_sky=True)


@pytest.fixture(autouse=True)
def _wide_reference(monkeypatch):
    """The reference's wide route; its CLI's ``--renderer`` sets the same
    variable, which the fixture restores."""
    monkeypatch.setenv("VKRT_FUSED", "0")
    monkeypatch.setattr(ref_cache, "enable_compile_cache", lambda: None)


@pytest.mark.parametrize("banners", [False, True])
def test_wide_frame_matches_reference(banners):
    g, m, l, c, a = ref_proc.atrium_scene(**SMALL_ATRIUM, with_banners=banners)
    ref = ref_render.Renderer(ref_render.build_scene(g, m, l, c, atlas=a), RefConfig(**CFG))
    ref.step()
    scene, bundle = from_reference(ref.scene, ref.packed)
    assert (bundle.alpha is not None) == banners
    port = R.Renderer(scene, RenderConfig(**{**CFG, "use_sun_sky": False, "sun_disk": True}),
                      device="cpu", packed=bundle, renderer="wide")
    port.step()
    _check(np.asarray(ref.accum), [ref.last_rays], port.accum.numpy(), [port.last_rays])


SMALL = ["--scene", "cornell", "--size", "32", "24", "--depth", "3", "--spp", "2"]


def test_cli_wide_matches_renderer_and_reference(tmp_path, capsys):
    out = tmp_path / "port.npy"
    assert cli.main([*SMALL, "--device", "cpu", "--renderer", "wide", "--stats",
                     "-o", str(tmp_path / "port.png"), "--hdr-out", str(out)]) == 0
    stats = json.loads([ln for ln in capsys.readouterr().err.splitlines()
                        if ln.startswith("{") and "bvh_nodes" in ln][0])
    g, m, l, c = procedural.cornell_box()
    r = R.Renderer(R.build_scene(g, m, l, c, sun_sky=default_sun_sky()),
                   RenderConfig(width=32, height=24, max_depth=3, max_samples=1,
                                firefly_clamp=10.0, hdr_multiplier=0.0),
                   device="cpu", renderer="wide")
    for _ in range(2):
        r.step()
    hdr = np.load(out)
    np.testing.assert_array_equal(hdr, r.hdr().numpy())
    assert stats["bvh_nodes"] == int(r.packed.opaque.rows.shape[0])
    ref_out = tmp_path / "ref.npy"
    assert ref_cli.main([*SMALL, "--renderer", "wide", "-o", str(tmp_path / "ref.png"),
                         "--hdr-out", str(ref_out)]) == 0
    ref = np.load(ref_out)
    assert hdr.shape == ref.shape and np.isfinite(hdr).all()
    assert np.isclose(hdr, ref, rtol=1e-3, atol=1e-4).all(-1).mean() >= 0.99


def _wait_for(svc, pred, timeout=240.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        with svc._lock:
            st = dict(svc._state)
        if pred(st):
            return st
        time.sleep(0.1)
    raise AssertionError("timeout")


def test_viewer_switches_to_wide(tmp_path, monkeypatch):
    from vk_raytrace_torch.utils import cache

    monkeypatch.setenv(cache.ENV, str(tmp_path / "cache"))
    argv = ["--device", "cpu", "--scene", "cornell", "--size", "32", "24", "--depth", "2",
            "--pbr", "gltf"]
    svc = V.ViewerService(V.build_parser().parse_args(argv))
    t = threading.Thread(target=svc.run_render_loop, daemon=True)
    t.start()
    try:
        _wait_for(svc, lambda st: st.get("frame", 0) >= 1)
        fused = svc._renderer
        assert fused.renderer == "fused" and fused.packed.opaque is None
        with svc._lock:
            svc._controls.append({"cmd": "set", "key": "renderer", "value": "wide"})
        t0 = time.time()
        while (svc._renderer is fused or svc._renderer.renderer != "wide") and time.time() - t0 < 120:
            time.sleep(0.1)
        wide = svc._renderer
        assert wide.renderer == "wide" and wide.packed.opaque is not None
        # The planar tables kept: the same storage.
        assert (wide.packed.opaque_planar.rows.data_ptr()
                == fused.packed.opaque_planar.rows.data_ptr())
        _wait_for(svc, lambda st: st.get("frame", 0) >= 2)
        assert "BVH rows" in svc._state["stats"]
        args = V.build_parser().parse_args(argv)
        scene, _ = cli.load_scene_from_args(args, "cpu")
        by_hand = R.Renderer(scene, wide.cfg, device="cpu", renderer="wide")
        for x, y in ((16, 12), (3, 20), (30, 2)):
            got, want = svc.pick(x, y), by_hand.pick(x, y)
            assert (got is None) == (want is None)
            if want is not None:
                assert (got["triangle"], got["material"], got["t"]) == (
                    want["triangle"], want["material"], want["t"])
    finally:
        svc._stop = True
        t.join(timeout=60)
        assert not t.is_alive()
