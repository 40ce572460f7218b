"""``vk_raytrace_torch/viewer.py`` case for case as ``tests/test_viewer.py``
holds the reference's viewer (the PNG encoder, the orbit camera's math,
the control page's inventory, the scene-derived pivot, the profiler and
statistics panels, the max-frames stop, interaction descaling with its
history rings), the orbit camera and the two panels held against the
reference's own (``vk_raytrace_tpu/viewer.py``) on the same inputs, plus
an HTTP round trip on localhost: ``/``,
``/frame.png``, ``/state``, POST ``/control`` and ``/pick`` (against
``Renderer.pick`` on the same camera). The render loop runs on the CPU; it
is stopped through ``_stop`` and joined with a timeout."""

import io
import json
import re
import threading
import time
import urllib.request

import numpy as np
import pytest

from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401
from vk_raytrace_torch import render as R
from vk_raytrace_torch import viewer as V
from vk_raytrace_torch.models import procedural
from vk_raytrace_torch.models.procedural import look_at_camera
from vk_raytrace_torch.models.schema import PBR_GLTF, RenderConfig
from vk_raytrace_torch.utils import png

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(autouse=True)
def own_cache(tmp_path, monkeypatch):
    """Bookmarks and accel entries in the test's own directory."""
    from vk_raytrace_torch.utils import cache

    monkeypatch.setenv(cache.ENV, str(tmp_path / "cache"))


def test_png_bytes_roundtrip():
    img = np.zeros((8, 8, 3), np.float32)
    img[2, 3] = [1.0, 0.5, 0.25]
    data = V._png_bytes(img)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    from PIL import Image

    back = np.asarray(Image.open(io.BytesIO(data)))
    assert back.shape == (8, 8, 3)
    assert tuple(back[2, 3]) == (255, 128, 64)
    assert back[0, 0].sum() == 0
    assert np.array_equal(png.decode_rgba(data)[..., :3], back)


def test_orbit_preserves_pivot_distance():
    cam = look_at_camera([0, 1, 3], [0, 1, 0], [0, 1, 0], 45.0, 1.0)
    oc = V.OrbitCamera(cam, 64, 64)
    r0 = np.linalg.norm(oc.eye - oc.center)
    oc.orbit(120.0, -35.0)
    r1 = np.linalg.norm(oc.eye - oc.center)
    np.testing.assert_allclose(r0, r1, rtol=1e-5)
    # dolly changes the distance, pan moves both points together
    oc.dolly(-2.0)
    assert np.linalg.norm(oc.eye - oc.center) < r1
    c_before = oc.center.copy()
    d_before = oc.eye - oc.center
    oc.pan(30.0, -10.0)
    np.testing.assert_allclose(oc.eye - oc.center, d_before, atol=1e-6)
    assert np.linalg.norm(oc.center - c_before) > 0


def test_orbit_camera_produces_valid_matrices():
    cam = look_at_camera([2, 2, 2], [0, 0, 0], [0, 1, 0], 45.0, 16 / 9)
    oc = V.OrbitCamera(cam, 160, 90)
    oc.orbit(50, 20)
    vi = np.asarray(oc.camera().view_inverse)
    r = vi[:3, :3]  # the rotation block is orthonormal
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)


def _orbit_pair(bounds):
    """The port's and the reference's OrbitCamera over the same camera."""
    from vk_raytrace_tpu import viewer as RV
    from vk_raytrace_tpu.models.procedural import look_at_camera as ref_look_at

    args = ([1.5, 2.0, 6.0], [0.2, 0.8, -0.4], [0, 1, 0], 50.0, 4 / 3, 0.0, 0.05)
    port = V.OrbitCamera(look_at_camera(*args), 96, 72, bounds=bounds)
    ref = RV.OrbitCamera(ref_look_at(*args), 96, 72, bounds=bounds)
    return port, ref


def _hold_cameras(port, ref, step):
    for k in ("eye", "center", "up"):
        np.testing.assert_allclose(getattr(port, k), getattr(ref, k), rtol=0, atol=1e-6,
                                   err_msg=f"{k} after {step}")
    for k in ("dist", "fov", "focal", "aperture", "width", "height"):
        assert getattr(port, k) == pytest.approx(getattr(ref, k), abs=1e-6), (k, step)
    pc, rc = port.camera(), ref.camera()
    for k in ("view_inverse", "proj_inverse", "focal_dist", "aperture"):
        np.testing.assert_allclose(np.asarray(getattr(pc, k), np.float64),
                                   np.asarray(getattr(rc, k), np.float64), rtol=0, atol=1e-6,
                                   err_msg=f"camera().{k} after {step}")
    pd, rd = port.to_dict(), ref.to_dict()
    assert pd.keys() == rd.keys()
    for k in pd:
        np.testing.assert_allclose(pd[k], rd[k], rtol=0, atol=1e-6, err_msg=f"to_dict {k}")


@pytest.mark.parametrize("bounds", [None, ([-2.0, 0.0, -3.0], [2.5, 3.0, 1.0])],
                         ids=["no-bounds", "bounds"])
def test_orbit_camera_matches_reference(bounds):
    """The same sequence of orbit, dolly, pan and set_pivot calls moves the
    port's camera as it moves the reference's (vk_raytrace_tpu/viewer.py),
    eye, centre, up and the ``camera()`` matrices within 1e-6 after each
    call; a bookmark round trip included."""
    port, ref = _orbit_pair(bounds)
    _hold_cameras(port, ref, "init")
    steps = [("orbit", (120.0, -35.0)), ("dolly", (-2.0,)), ("pan", (30.0, -10.0)),
             ("orbit", (-400.0, 900.0)),  # phi clamps at the pole
             ("set_pivot", ([0.5, 1.0, -1.0],)), ("orbit", (15.0, 25.0)),
             ("dolly", (3.5,)), ("pan", (-7.0, 42.0)), ("orbit", (0.0, -900.0))]
    for name, a in steps:
        getattr(port, name)(*a)
        getattr(ref, name)(*a)
        _hold_cameras(port, ref, f"{name}{a}")
    d = ref.to_dict()
    port.from_dict(d)
    ref.from_dict(d)
    _hold_cameras(port, ref, "from_dict")


def test_control_page_covers_sample_gui_inventory():
    """Every sample_gui.cpp control family has a counterpart on the page:
    the 13 debug modes, the tonemapper, the sun&sky editor, aperture and
    focal distance, the back-end select (offering exactly what the port's
    CLI accepts: ``fused`` and ``wide``), the statistics and profiler panels
    and the plots."""
    from vk_raytrace_torch.cli import build_parser

    page = V._PAGE
    for v, name in [(0, "none"), (1, "base color"), (2, "normal"), (3, "metallic"),
                    (4, "emissive"), (5, "alpha"), (6, "roughness"), (7, "texcoord"),
                    (8, "tangent"), (9, "radiance"), (10, "weight"), (11, "ray dir"),
                    (12, "heatmap")]:
        assert f'<option value="{v}">{name}</option>' in page, name
    for ctl in ["fov", "aperture", "focal", "depth", "spp", "pbr", "renderer", "tonemode",
                "exposure", "brightness", "contrast", "saturation", "vignette", "autoexp",
                "dither", "sunsky", "azimuth", "elevation", "haze", "rbshift", "horizon",
                "horizonblur", "sundisk", "sunscale", "sunglow"]:
        assert f'id="{ctl}"' in page, ctl
    assert 'id="stats"' in page and 'id="prof"' in page
    for pl in ["pl_ms", "pl_mrays", "pl_mem"]:
        assert f'id="{pl}"' in page, pl
    select = re.search(r'<select id="renderer">(.*?)</select>', page).group(1)
    offered = re.findall(r'<option value="([^"]+)"', select)
    accepted = next(a.choices for a in build_parser()._actions if a.dest == "renderer")
    assert offered == list(accepted) == ["fused", "wide"]


def test_scene_derived_pivot_and_set_pivot():
    """The pivot comes from the scene's bounds and a pick re-targets it
    (sample_example.cpp:493-510)."""
    cam = look_at_camera([0, 1, 10], [0, 1, 0], [0, 1, 0], 45.0, 1.0)
    bounds = (np.asarray([-2.0, 0.0, -2.0]), np.asarray([2.0, 2.0, 2.0]))
    oc = V.OrbitCamera(cam, 64, 64, bounds=bounds)
    np.testing.assert_allclose(oc.dist, 10.0, atol=0.5)
    oc.set_pivot([1.0, 1.0, 1.0])
    np.testing.assert_allclose(oc.center, [1.0, 1.0, 1.0])
    np.testing.assert_allclose(oc.fov, 45.0, atol=0.5)  # from the projection


def test_prof_and_stats_strings():
    class _FakeRenderer:
        frame = 3
        last_rays = 1_000_000
        build_times = {"accel_s": 1.2}

    s = V._prof_stats(_FakeRenderer(), 0.5, RenderConfig(width=8, height=8), mem_mib=12.0)
    assert "Mrays/s" in s and "2.00" in s and "accel_s" in s and "dev mem" in s
    assert "dev mem" not in V._prof_stats(_FakeRenderer(), 0.5, RenderConfig(width=8, height=8))
    g, m, l, c = procedural.cornell_box()
    r = R.Renderer(R.build_scene(g, m, l, c), RenderConfig(width=8, height=8), device="cpu")
    stats = V._scene_stats(r)
    assert f"triangles {len(g.indices):>10,}" in stats and "BVH rows" in stats
    pool, inst, m, l, c, a = procedural.bistro_scene(detail=0.05)
    r = R.Renderer(R.build_instanced_scene(pool, inst, m, l, c, atlas=a),
                   RenderConfig(width=8, height=8), device="cpu")
    stats = V._scene_stats(r)
    assert f"instances {len(inst.mesh_id):>10,}" in stats and "meshes" in stats


def test_prof_and_stats_strings_match_reference(monkeypatch):
    """The statistics and profiler panels print the reference's strings
    (vk_raytrace_tpu/viewer.py) for the same inputs: the profiler for one
    fake renderer with and without device memory (the reference reads it
    from its profiler, the port takes it as an argument), the statistics
    for the Cornell box built by each package."""
    import jax

    from vk_raytrace_tpu import render as RR
    from vk_raytrace_tpu import viewer as RV
    from vk_raytrace_tpu.models import procedural as rproc
    from vk_raytrace_tpu.models.schema import RenderConfig as RefConfig
    from vk_raytrace_tpu.utils import profiler as rprof

    class _FakeRenderer:
        frame = 7
        last_rays = 3_456_789
        build_times = {"accel_s": 1.25, "scene_s": 0.5}

    cfg = RenderConfig(width=8, height=8, max_samples=3)
    rcfg = RefConfig(width=8, height=8, max_samples=3)
    monkeypatch.setattr(rprof, "device_memory_stats", lambda: [{"bytes_in_use": -1}])
    assert V._prof_stats(_FakeRenderer(), 0.0375, cfg) == RV._prof_stats(
        _FakeRenderer(), 0.0375, rcfg)
    monkeypatch.setattr(rprof, "device_memory_stats", lambda: [{"bytes_in_use": 123 * 2**20}])
    assert V._prof_stats(_FakeRenderer(), 0.0375, cfg, mem_mib=123.0) == RV._prof_stats(
        _FakeRenderer(), 0.0375, rcfg)

    def planar_rows(p):
        """The reference's rows at the traversal width, the rows the port
        counts: its ``BVH rows`` line counts the 8-wide tables of its XLA
        body, which the port does not build."""
        if getattr(p, "blas_planar", None) is not None:
            return int(np.asarray(p.blas_planar.rows).shape[0])
        return sum(int(np.asarray(t.rows).shape[0])
                   for t in (p.opaque_planar, p.alpha_planar) if t is not None)

    def hold(port_r, ref_r):
        port, ref = V._scene_stats(port_r), RV._scene_stats(ref_r)
        *head, rows = ref.split("\n")
        assert rows.startswith("BVH rows  ")
        assert port == "\n".join(head + [f"BVH rows  {planar_rows(ref_r.packed):>10,}"]), (
            port, ref)

    cfg8 = RenderConfig(width=8, height=8)
    rcfg8 = RefConfig(width=8, height=8)
    with jax.default_device(jax.devices("cpu")[0]):
        g, m, l, c = procedural.cornell_box()
        rg, rm, rl, rc = rproc.cornell_box()
        hold(R.Renderer(R.build_scene(g, m, l, c), cfg8, device="cpu"),
             RR.Renderer(RR.build_scene(rg, rm, rl, rc), rcfg8))
        pool, inst, m, l, c, a = procedural.bistro_scene(detail=0.05)
        rpool, rinst, rm, rl, rc, ra = rproc.bistro_scene(detail=0.05)
        hold(R.Renderer(R.build_instanced_scene(pool, inst, m, l, c, atlas=a), cfg8,
                        device="cpu"),
             RR.Renderer(RR.build_instanced_scene(rpool, rinst, rm, rl, rc, atlas=ra), rcfg8))


def test_max_frames_stops_accumulation():
    """``cfg.max_frames`` halts the accumulation (m_maxFrames,
    sample_example.cpp:407-408); ``reset()`` re-arms it."""
    g, m, l, c = procedural.cornell_box()
    cfg = RenderConfig(width=16, height=16, max_depth=2, max_samples=1, hdr_multiplier=0.0,
                       pbr_mode=PBR_GLTF, max_frames=2)
    r = R.Renderer(R.build_scene(g, m, l, c), cfg, device="cpu")
    for _ in range(4):
        r.step()
    assert r.frame == 2 and r.converged
    frozen = r.accum.numpy().copy()
    r.step()
    np.testing.assert_array_equal(r.accum.numpy(), frozen)
    r.reset()
    assert not r.converged
    r.step()
    assert r.frame == 1


def _service(argv):
    svc = V.ViewerService(V.build_parser().parse_args(argv))
    t = threading.Thread(target=svc.run_render_loop, daemon=True)
    t.start()
    return svc, t


def _wait_for(svc, pred, timeout=240.0):
    t0 = time.time()
    st = {}
    while time.time() - t0 < timeout:
        with svc._lock:
            st = dict(svc._state)
        if pred(st):
            return st
        time.sleep(0.1)
    raise AssertionError(f"timeout; last state={st}")


def _stop(svc, t):
    svc._stop = True
    t.join(timeout=60)
    assert not t.is_alive()


def test_viewer_interaction_descaling():
    """During a camera drag the viewer renders at 1/DS resolution through a
    twin renderer that shares the accel, then returns to full-resolution
    accumulation (sample_example.cpp:410-415). Asserted on the monotonic
    counters: the transient ``descaled`` flag can slip between polls."""
    svc, t = _service(["--device", "cpu", "--scene", "cornell", "--size", "32", "32",
                       "--depth", "2"])
    try:
        st0 = _wait_for(svc, lambda st: st.get("frame", 0) >= 2)
        desc0, resets0 = st0.get("descale_frames", 0), st0.get("resets", 0)
        with svc._lock:
            svc._controls.append({"cmd": "orbit", "dx": 40.0, "dy": 10.0})
        st = _wait_for(svc, lambda st: st.get("descale_frames", 0) > desc0)
        assert st.get("resets", 0) > resets0  # the accumulation restarted
        st = _wait_for(svc, lambda st: not st.get("descaled") and st.get("frame", 0) >= 2)
        hist = st.get("hist")
        assert hist and len(hist["ms"]) >= 2 and len(hist["mrays"]) >= 2
        assert all(isinstance(x, (int, float)) and x >= 0 for x in hist["ms"])
        n0 = len(hist["ms"])
        if n0 < 120:  # the ring is not yet full: it keeps growing
            _wait_for(svc, lambda st: len(st["hist"]["ms"]) > n0)
    finally:
        _stop(svc, t)


def test_http_round_trip():
    """The server on an ephemeral localhost port: the page, a lit
    ``/frame.png`` that ``utils/png.py`` decodes, ``/state``'s frame count
    growing, ``/pick`` equal to ``Renderer.pick`` of a renderer built alike
    (and its pivot queued), a POST ``/control`` orbit that descales and
    resets, and a tonemapper edit."""
    argv = ["--device", "cpu", "--scene", "cornell", "--size", "32", "24", "--depth", "2",
            "--pbr", "gltf"]
    svc, t = _service(argv)
    httpd = V.serve(svc, "127.0.0.1", 0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=60) as resp:
            return resp.read()

    def state():
        return json.loads(get("/state"))

    try:
        assert b"vk_raytrace_torch viewer" in get("/")
        _wait_for(svc, lambda st: st.get("frame", 0) >= 2)
        img = png.decode_rgba(get("/frame.png"))
        assert img.shape == (24, 32, 4) and img[..., :3].max() > 0
        f0 = state()["frame"]
        t0 = time.time()
        while state()["frame"] <= f0 and time.time() - t0 < 120:
            time.sleep(0.1)
        assert state()["frame"] > f0
        pick = json.loads(get("/pick?x=16&y=12"))
        args = V.build_parser().parse_args(argv)
        from vk_raytrace_torch import cli

        scene, _ = cli.load_scene_from_args(args, "cpu")
        ref = R.Renderer(scene, svc._renderer.cfg, device="cpu").pick(16, 12)
        assert pick is not None and ref is not None
        assert (pick["triangle"], pick["material"], pick["t"]) == (
            ref["triangle"], ref["material"], ref["t"])
        np.testing.assert_array_equal(np.asarray(pick["position"], np.float32), ref["position"])
        st = state()
        req = urllib.request.Request(base + "/control", method="POST",
                                     data=json.dumps({"cmd": "orbit", "dx": 30.0, "dy": 5.0}).encode())
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert json.loads(resp.read()) == {}
        _wait_for(svc, lambda s: s["descale_frames"] > st["descale_frames"]
                  and s["resets"] > st["resets"])
        req = urllib.request.Request(base + "/control", method="POST", data=json.dumps(
            {"cmd": "set", "key": "exposure", "value": 1.0}).encode())
        urllib.request.urlopen(req, timeout=60).close()
        _wait_for(svc, lambda s: float(svc._renderer.tonemapper.avg_lum) == 2.0)
        with pytest.raises(urllib.error.HTTPError):
            get("/pick?x=nope")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=30)
        _stop(svc, t)
