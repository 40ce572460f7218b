"""The port's CLI (``python -m vk_raytrace_torch.cli``) on the CPU against
the port's ``Renderer`` driven by hand and against the reference's CLI.

* ``cli.main([... "--device", "cpu"])`` on the Cornell box at 32x24, depth
  3, 2 spp (Disney, the CLI's default), and on quirks.glb (two levels by
  ``--instancing auto``): its ``--hdr-out`` equals, bit for bit, the same
  scene rendered through ``Renderer`` by hand, and matches the reference
  CLI's ``--hdr-out`` on at least 99% of pixels within rtol 1e-3 / atol
  1e-4 (``tests/test_torch_render.py``'s tolerance; the packages' traversal
  trees and FMA contraction differ). Its PNG decodes to the post-processed
  image.
* ``--checkpoint``: two runs of 1 spp equal one run of 2 bit for bit; the
  ``.npz`` of either package resumes in the other (the same keys and
  dtypes), and the resumed image matches the other package's straight run
  within the tolerance above.
* ``-e env.hdr`` and the materials scene's procedural sky set the firefly
  clamp and the HDR multiplier by the reference CLI's rules.
* Without a card and without ``--device cpu`` the CLI fails; it never
  renders on the CPU instead. ``--stats`` prints the reference's keys.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401
from vk_raytrace_tpu import cli as ref_cli
from vk_raytrace_tpu.utils import cache as ref_cache
from vk_raytrace_torch import cli
from vk_raytrace_torch import render as R
from vk_raytrace_torch.models import procedural
from vk_raytrace_torch.models.gltf import load_gltf
from vk_raytrace_torch.models.schema import RenderConfig, default_sun_sky
from vk_raytrace_torch.utils import png

pytestmark = pytest.mark.usefixtures("one_torch_thread")

QUIRKS = os.path.join(os.path.dirname(__file__), "assets", "quirks.glb")
SCENES = {"cornell": ["--scene", "cornell"], "quirks": ["-f", QUIRKS]}
SMALL = ["--size", "32", "24", "--depth", "3"]


@pytest.fixture(autouse=True)
def no_reference_compile_cache(monkeypatch):
    """The reference CLI turns on XLA's persistent compile cache under the
    home directory; the tests keep it off."""
    monkeypatch.setattr(ref_cache, "enable_compile_cache", lambda: None)


def _port(tmp_path, name, *extra):
    out = tmp_path / f"port_{name}.npy"
    assert cli.main([*SCENES[name], *SMALL, "--device", "cpu", "-o",
                     str(tmp_path / f"port_{name}.png"), "--hdr-out", str(out), *extra]) == 0
    return np.load(out)


def _ref(tmp_path, name, *extra):
    out = tmp_path / f"ref_{name}.npy"
    assert ref_cli.main([*SCENES[name], *SMALL, "-o", str(tmp_path / f"ref_{name}.png"),
                         "--hdr-out", str(out), *extra]) == 0
    return np.load(out)


def _close(a, b):
    assert a.shape == b.shape and np.isfinite(a).all()
    share = np.isclose(a, b, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert share >= 0.99, share


def _by_hand(name, spp):
    """The scene of ``SCENES[name]`` through ``Renderer`` as the CLI sets
    it up by default: Disney, no environment, no sun (so no HDR
    multiplier), firefly clamp 10."""
    if name == "cornell":
        g, m, l, c = procedural.cornell_box()
        scene = R.build_scene(g, m, l, c, sun_sky=default_sun_sky())
    else:
        (pool, inst), m, l, c, a = load_gltf(QUIRKS, instancing="auto")
        scene = R.build_instanced_scene(pool, inst, m, l, c, sun_sky=default_sun_sky(), atlas=a)
    r = R.Renderer(scene, RenderConfig(width=32, height=24, max_depth=3, max_samples=1,
                                       firefly_clamp=10.0, hdr_multiplier=0.0), device="cpu")
    for _ in range(spp):
        r.step()
    return r


@pytest.mark.parametrize("name", sorted(SCENES))
def test_cli_matches_renderer_and_reference(name, tmp_path):
    hdr = _port(tmp_path, name, "--spp", "2")
    r = _by_hand(name, 2)
    np.testing.assert_array_equal(hdr, r.hdr().numpy())
    _close(hdr, _ref(tmp_path, name, "--spp", "2"))
    # The PNG is the post-processed image, rounded as write_png rounds it.
    want = png.to_uint8(r.postprocess().numpy())
    data = (tmp_path / f"port_{name}.png").read_bytes()
    np.testing.assert_array_equal(png.decode_rgba(data)[..., :3], want)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / f"port_{name}.png")), want)


def test_cli_resume_equals_straight_run(tmp_path):
    ck = str(tmp_path / "ck.npz")
    _port(tmp_path, "cornell", "--spp", "1", "--checkpoint", ck)
    assert int(np.load(ck)["frame"]) == 1
    resumed = _port(tmp_path, "cornell", "--spp", "1", "--checkpoint", ck)
    assert int(np.load(ck)["frame"]) == 2
    straight = _port(tmp_path, "cornell", "--spp", "2")
    np.testing.assert_array_equal(resumed, straight)


def test_checkpoint_crosses_packages(tmp_path, capsys):
    """A checkpoint of the reference CLI resumes in the port's, and one of
    the port's in the reference's."""
    port_ck, ref_ck = str(tmp_path / "port_ck.npz"), str(tmp_path / "ref_ck.npz")
    _port(tmp_path, "cornell", "--spp", "1", "--checkpoint", port_ck)
    _ref(tmp_path, "cornell", "--spp", "1", "--checkpoint", ref_ck)
    with np.load(port_ck) as p, np.load(ref_ck) as r:
        assert sorted(p.files) == sorted(r.files) == ["accum", "frame"]
        for k in p.files:
            assert p[k].dtype == r[k].dtype and p[k].shape == r[k].shape, k
    capsys.readouterr()
    port_resumed = _port(tmp_path, "cornell", "--spp", "1", "--checkpoint", ref_ck)
    ref_resumed = _ref(tmp_path, "cornell", "--spp", "1", "--checkpoint", port_ck)
    assert capsys.readouterr().err.count("resumed at frame 1") == 2
    assert int(np.load(ref_ck)["frame"]) == int(np.load(port_ck)["frame"]) == 2
    port_straight = _port(tmp_path, "cornell", "--spp", "2")
    ref_straight = _ref(tmp_path, "cornell", "--spp", "2")
    _close(port_resumed, ref_straight)
    _close(ref_resumed, port_straight)


@pytest.mark.parametrize("scene", ["cornell_hdr", "materials"])
def test_cli_environment_and_clamp_rules(scene, tmp_path):
    """``-e env.hdr`` (decoded, built on the device) and the procedural sky
    of the materials scene: the firefly clamp is 4 + the environment's
    integral and the HDR multiplier 1, as in the reference CLI; the HDR
    equals the renderer driven by hand with those values."""
    from test_torch_baseline_scenes import _write_hdr
    from vk_raytrace_torch.models import hdr

    if scene == "cornell_hdr":
        rgbe = np.random.default_rng(5).integers(0, 256, (8, 16, 4), dtype=np.uint8)
        rgbe[..., 3] = 128
        _write_hdr(tmp_path / "env.hdr", rgbe, rle=True)
        args = ["--scene", "cornell", "-e", str(tmp_path / "env.hdr")]
        env = hdr.build_environment(hdr.load_hdr(str(tmp_path / "env.hdr")))
        g, m, l, c = procedural.cornell_box()
    else:
        args = ["--scene", "materials"]
        env = hdr.build_environment(hdr.procedural_sky_hdr())
        g, m, l, c = procedural.material_test_grid()
    out = str(tmp_path / "out.npy")
    assert cli.main([*args, *SMALL, "--spp", "2", "--device", "cpu", "-o",
                     str(tmp_path / "out.png"), "--hdr-out", out]) == 0
    r = R.Renderer(R.build_scene(g, m, l, c, env=env),
                   RenderConfig(width=32, height=24, max_depth=3, hdr_multiplier=1.0,
                                firefly_clamp=4.0 + float(env.integral)), device="cpu")
    r.step()
    r.step()
    np.testing.assert_array_equal(np.load(out), r.hdr().numpy())


def test_cli_without_card_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the CLI on a machine without a card")
    out = tmp_path / "c.png"
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["--scene", "cornell", "--size", "16", "12", "--spp", "1", "-o", str(out)])
    assert not out.exists()


def test_cli_stats_profile_and_options(tmp_path, capsys):
    """``--stats`` prints the reference's keys (``bvh_nodes``: the planar
    rows); ``--profile`` a JSON line of each frame's seconds and rays;
    ``--multichip`` on no or one card, the row width, the fused shading
    request, the render scale and the tonemapper flags all run."""
    assert cli.main(["--scene", "cornell", "--size", "32", "24", "--depth", "2", "--spp", "2",
                     "--device", "cpu", "--stats", "--profile", "--multichip", "--row-width",
                     "32", "--fused-shade", "--pbr", "gltf", "--render-scale", "2",
                     "--tm-exposure", "2", "--tm-no-dither", "--renderer", "fused",
                     "-o", str(tmp_path / "s.png")]) == 0
    err = capsys.readouterr().err.splitlines()
    stats = json.loads(err[0])
    assert set(stats) == {"triangles", "vertices", "materials", "lights", "textures",
                          "bvh_nodes", "devices"}
    assert stats["devices"] == ["cpu"] and stats["bvh_nodes"] > 0
    prof = json.loads([ln for ln in err if ln.startswith('{"profile"')][0])["profile"]
    assert prof["frames"] == prof["frame"] == 2 and len(prof["frame_s"]) == 2
    assert prof["stage"] == "fused" and min(prof["rays"]) > 16 * 12
    assert np.asarray(Image.open(tmp_path / "s.png")).shape == (12, 16, 3)
    with pytest.raises(SystemExit):  # a back end neither package has
        cli.main(["--renderer", "rtx", "--device", "cpu"])
