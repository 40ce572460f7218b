"""``vk_raytrace_torch/parallel/sharding.py`` (tile x sample sharding on
``torch.distributed``) against the port's one-device ``Renderer`` and the
reference's ``sharded_render_step``, the cases of ``tests/test_sharding.py``:

* ``make_mesh``'s shapes (4 ranks) and its errors (one rank in process);
* one spawn of 4 gloo CPU ranks (``tests/sharding_ranks.py``) renders the
  reference's Cornell tables (``convert.from_reference``): tile 4 x sample
  1 equals the port's ``Renderer`` bit for bit over 3 frames at 32x32 (the
  default pool) and at 16x16 (a pool of 16 lanes, which refills); tile 2 x
  sample 2 (3 frames, 32x32) meets ``tests/test_torch_render.py``'s
  criterion against the reference's ``sharded_render_step`` on 4 of
  conftest's 8 virtual devices (frame 0's rays aside, below), and its
  first frame equals the per-rank bodies (``rank_frame``) composed here
  over every (t, s) bit for bit;
* ``graft_entry.dryrun_multichip(4)``;
* ``cli.main --multichip`` in 2 gloo CPU ranks writes the PNG and the HDR
  image of the one-rank CLI, bit for bit (the pooled wavefront, and a
  debug mode through the unrolled step).

Each spawn has a timeout: a rank that hangs fails the test."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sharding_ranks as SR
from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401
from vk_raytrace_tpu import render as ref_render
from vk_raytrace_tpu.models import procedural as ref_proc
from vk_raytrace_tpu.models.schema import PBR_GLTF, RenderConfig as RefConfig
from vk_raytrace_tpu.parallel import sharding as ref_sharding
from vk_raytrace_torch import cli
from vk_raytrace_torch import render as R
from vk_raytrace_torch.convert import from_reference
from vk_raytrace_torch.parallel import sharding

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SPAWN_TIMEOUT_S = 240.0
CASES = (("t4_32", (4, 1), (32, 32), 3, None), ("t4_16", (4, 1), (16, 16), 3, 16),
         ("t2s2", (2, 2), (32, 32), 3, None))


@pytest.fixture(scope="module")
def cornell():
    geom, mats, lights, cam = ref_proc.cornell_box()
    scene = ref_render.build_scene(geom, mats, lights, cam)
    packed = ref_render.pack_scene(scene.bvh, scene.geometry)
    return scene, packed, from_reference(scene, packed)


@pytest.fixture(scope="module")
def spawned(cornell, tmp_path_factory):
    """The 4-rank spawn's images and ray counts."""
    d = tmp_path_factory.mktemp("sharding")
    torch.save(cornell[2], d / "scene.pt")
    sharding.spawn_ranks(SR.render_cases, 4, (str(d / "scene.pt"), str(d / "out.npz"), CASES),
                         timeout_s=SPAWN_TIMEOUT_S)
    with np.load(d / "out.npz") as z:
        return dict(z)


def _single(port, w, h, frames):
    r = R.Renderer(*port[:1], SR.cfg_of(w, h), device="cpu", packed=port[1])
    rays = []
    for _ in range(frames):
        r.step()
        rays.append(r.last_rays)
    return r, r.hdr().numpy(), rays


def test_mesh_shapes(spawned):
    assert spawned["shape_default"].tolist() == [4, 1]
    assert spawned["shape_sample2"].tolist() == [2, 2]
    assert spawned["shape_tile1"].tolist() == [1, 4]


def test_make_mesh_errors():
    """One gloo rank in this process: the default shape, the shape checks,
    no silent backend or device choice."""
    sharding.init_process_group("cpu", 0, 1, f"tcp://127.0.0.1:{sharding.free_port()}",
                                timeout_s=60.0)
    try:
        assert sharding.mesh_shape(sharding.make_mesh("cpu")) == {"tile": 1, "sample": 1}
        with pytest.raises(ValueError, match="mesh 2x1 != 1 ranks"):
            sharding.make_mesh("cpu", tile=2, sample=1)
        with pytest.raises(ValueError, match="mesh 2x0 != 1 ranks"):
            sharding.make_mesh("cpu", tile=2)
        with pytest.raises(ValueError, match="runs gloo, the cpu mesh asks for nccl"):
            sharding.make_mesh("cpu", backend="nccl")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="needs CUDA"):
                sharding.make_mesh("cuda")
        with pytest.raises(ValueError, match="no default backend"):
            sharding.backend_for("xla")
        assert sharding.backend_for("cuda") == "nccl" and sharding.backend_for("cpu") == "gloo"
        assert sharding.backend_for("cuda", "gloo") == "gloo"
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("name", ("t4_32", "t4_16"))
def test_tile_sharded_matches_single_device(cornell, spawned, name):
    """Tile-only sharding over 4 ranks: the one-device image bit for bit
    after each of 3 progressive frames' accumulation, and the same rays."""
    _, _, (w, h), frames, _ = dict((c[0], c) for c in CASES)[name]
    _, single, rays = _single(cornell[2], w, h, frames)
    assert np.array_equal(spawned[name][-1], single), np.abs(spawned[name][-1] - single).max()
    assert spawned[f"{name}_rays"].tolist() == rays and min(rays) > 0


def test_sample_axis_against_reference(cornell, spawned):
    """Tile 2 x sample 2 against the reference's sharded step on 4 virtual
    devices over 3 frames: after each, the render criterion of
    ``tests/test_torch_render.py``; the rays of the jittered frames 1-2
    within 0.1%. Frame 0 shoots through pixel centres, and on the Cornell
    box's axis-aligned walls some centre rays meet a triangle edge exactly,
    where the reference's XLA (multiply-adds contracted into FMAs) and the
    port differ by an ulp in v (ROADMAP's differences the gates account
    for): the one-device renders differ there by 7 of 1,830 rays, both
    sample shards repeat it, so frame 0's rays are held within 0.5%. As in
    ``tests/test_sharding.py``, the first frame's mean is within 10% of the
    tile-only render's."""
    scene, packed, port = cornell
    cfg = RefConfig(width=32, height=32, max_depth=2, max_samples=1, hdr_multiplier=0.0,
                    pbr_mode=PBR_GLTF, firefly_clamp=1e4)
    mesh = ref_sharding.make_mesh(jax.devices()[:4], tile=2, sample=2)
    step = ref_sharding.sharded_render_step(mesh, ref_sharding.replicate(mesh, scene),
                                            ref_sharding.replicate(mesh, packed), cfg, False)
    accum = ref_sharding.shard_accum(mesh, jnp.zeros((32, 32, 3), jnp.float32))
    for f in range(3):
        accum, ref_rays = step(accum, jnp.asarray(f, jnp.int32))
        ref_img = np.asarray(jax.device_get(accum))
        img, rays = spawned["t2s2"][f], int(spawned["t2s2_rays"][f])
        assert np.isfinite(img).all() and img.mean() > 0.0
        share = np.isclose(img, ref_img, rtol=1e-3, atol=1e-4).all(-1).mean()
        assert share >= 0.99, (f, share)
        rel = abs(rays - int(ref_rays)) / int(ref_rays)
        assert rel <= (5e-3 if f == 0 else 1e-3), (f, rays, int(ref_rays))
    single = _single(port, 32, 32, 1)[1]
    first = spawned["t2s2"][0]
    assert abs(first.mean() - single.mean()) / single.mean() < 0.1


def test_rank_bodies_compose_to_the_sharded_frame(cornell, spawned):
    """``rank_frame`` over every (t, s) of a 2 x 2 and a 4 x 1 mesh, in this
    process: the tiles stacked and each tile's two sample images averaged
    ((a + b) / 2, the all-reduce's mean for two ranks) give the spawned
    ranks' first frame bit for bit, and the 4 x 1 tiles the one-device
    frame."""
    r, single, _ = _single(cornell[2], 32, 32, 1)
    args = (r.scene, r.packed, r._run_cfg, 0)
    kw = dict(alpha_pack=r.alpha_pack, features=r.features)
    tiles = [sharding.rank_frame(*args, t, 4, 0, 1, **kw)[0] for t in range(4)]
    assert np.array_equal(torch.cat(tiles).numpy(), single)
    composed = []
    for t in range(2):
        a, b = (sharding.rank_frame(*args, t, 2, s, 2, **kw)[0] for s in range(2))
        composed.append((a + b) / 2.0)
    assert np.array_equal(torch.cat(composed).numpy(), spawned["t2s2"][0])


def test_dryrun_multichip_four_ranks(capfd):
    from vk_raytrace_torch import graft_entry

    graft_entry.dryrun_multichip(4, timeout_s=SPAWN_TIMEOUT_S)
    assert "dryrun_multichip(4): mesh={'tile': 2, 'sample': 2}" in capfd.readouterr().out


@pytest.mark.parametrize("debug", ("none", "normal"))
def test_cli_multichip_matches_one_rank(tmp_path, debug):
    """``--multichip`` over 2 gloo CPU ranks (tile only) writes the one-rank
    CLI's PNG and HDR image, bit for bit: the pooled wavefront, and a debug
    mode through ``sharded_render_step_unrolled``."""
    base = ["--device", "cpu", "--scene", "cornell", "--size", "32", "24", "--spp", "3",
            "--depth", "3", "--pbr", "gltf", "--debug-mode", debug]
    mc = [str(tmp_path / f) for f in ("mc.png", "mc.npy")]
    sharding.spawn_ranks(SR.cli_rank, 2, (base + ["--multichip", "-o", mc[0], "--hdr-out", mc[1]],),
                         timeout_s=SPAWN_TIMEOUT_S)
    one = [str(tmp_path / f) for f in ("one.png", "one.npy")]
    assert cli.main(base + ["-o", one[0], "--hdr-out", one[1]]) == 0
    with open(mc[0], "rb") as a, open(one[0], "rb") as b:
        assert a.read() == b.read()
    assert np.array_equal(np.load(mc[1]), np.load(one[1]))
    assert not os.path.exists(tmp_path / "out.png")
