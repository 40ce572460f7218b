"""The pooled wavefront in the reference's form (``integrator/wavefront.py``:
the state over the whole pool under its ``active`` mask, the tiered tail,
the loop control on the device) and its two bookkeeping stages
(``integrator/pool.py``: ``regenerate`` and ``retire``, each a kernel of
``csrc/wavefront.cu`` with a plain version).

Against the reference's ``render_units_pooled(track_steps=True,
track_occupancy=True)`` on the reduced atrium (``test_torch_render.py``'s
``SMALL_ATRIUM``; scenes and BVHs through ``convert.from_reference``),
frame 1, two cases: 64x48 at 1 spp in a pool of 3072 lanes with the banners
(the reference's fused path, ``VKRT_FUSED=1``, Pallas in interpret mode, so
that both count the same planar nodes), no tiers; and 64x48 at 4 spp in a
pool of 8192 (12,288 paths: the tiered tail in both) without them (the
reference's 8-wide XLA trees). In both the iteration count is equal and
every occupancy entry within 0.1% of the reference's (the rare float32 flip
of a Russian-roulette or alpha branch), the image and rays within
``test_torch_render.py``'s gates (99% of pixels at rtol 1e-3 / atol 1e-4,
rays within 0.1%). Steps: with the banners both count the planar trees' nodes
of the closest hit (opaque pass, then each alpha round's nodes), so 98% of
pixels hold the reference's count exactly (a ray an ulp apart may visit
other nodes on its way to the same hit) and the sums agree within 0.5%;
without them the reference counts
its 8-wide XLA trees' nodes, which the port does not have, so the port's
record is held against its own per-ray counts (each active lane's closest-hit
steps at each retirement) summed per pixel with numpy.

The plain versions against the reference's clauses on random pools
(numpy-seeded); the kernels, built from ``csrc/wavefront.cu`` as host C++
under ``tests/cuda_host_shim/cuda_runtime.h`` (chunks of one lane; the
camera's sum in the CPU's order and x / w divided, as torch does on the
CPU), against the plain versions: bit for bit but the camera rays, whose
normalise takes libm's correctly rounded sqrt where torch's CPU sqrt is not
always (within 2 ulp); a full pool, a mostly dead one, one with every unit
granted already, the tiers' widths, every lane dead, none dead, and a pool
off a multiple of the card's 256-lane chunk (the host build's chunks are one
lane, so its blocks run the scan's look-back in launch order and never
wait); the retirement on pools of 1, 3, 2,085, 4,099 and 2^14 lanes.
"""

import os
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_render import CFG, SMALL_ATRIUM
from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401 (fixtures)
from vk_raytrace_tpu import render as ref_render
from vk_raytrace_tpu.integrator import wavefront as ref_wf
from vk_raytrace_tpu.models import procedural as ref_proc
from vk_raytrace_tpu.models.schema import RenderConfig as RefConfig
from vk_raytrace_tpu.ops import rng as ref_rng
from vk_raytrace_tpu.ops.math import firefly_luminance as ref_luminance
from vk_raytrace_torch import cuda_build
from vk_raytrace_torch import render as port_render
from vk_raytrace_torch.convert import from_reference
from vk_raytrace_torch.integrator import pool as P
from vk_raytrace_torch.integrator import wavefront as wf
from vk_raytrace_torch.integrator.camera import with_aspect
from vk_raytrace_torch.models import procedural as port_proc
from vk_raytrace_torch.models.schema import RenderConfig

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHIM = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_host_shim")
FRAME = 1
# (banners, spp, pool): no tiers; the tiers (a pool of 8192 lanes).
CASES = ((True, 1, 3072), (False, 4, 8192))


def _pooled_pair(banners, spp, pool, monkeypatch):
    if banners:
        monkeypatch.setenv("VKRT_FUSED", "1")
    cfg = {**CFG, "max_samples": spp}
    g, m, l, c, a = ref_proc.atrium_scene(**SMALL_ATRIUM, with_banners=banners)
    ref = ref_render.Renderer(ref_render.build_scene(g, m, l, c, atlas=a), RefConfig(**cfg))
    n_pix = cfg["width"] * cfg["height"]
    r_img, r_steps, r_rays, r_occ = ref_wf.render_units_pooled(
        ref.scene, ref.packed, ref._run_cfg, jnp.asarray(FRAME, jnp.int32), ref.has_alpha,
        jnp.asarray(0, jnp.int32), n_pix, pool, features=ref.features, track_steps=True,
        track_occupancy=True,
    )
    scene, bundle = from_reference(ref.scene, ref.packed)
    port = port_render.Renderer(
        scene, RenderConfig(**{**cfg, "use_sun_sky": False, "sun_disk": True}), device="cpu",
        packed=bundle,
    )
    # The port's own per-ray counts: each active lane's closest-hit steps at
    # each retirement, summed per pixel here.
    own = np.zeros(n_pix, np.int64)
    retire = P.retire

    def counting(st, b, *args):
        act = st["active"].numpy()
        np.add.at(own, st["pix"].numpy()[act], b["hit_steps"].numpy()[act])
        return retire(st, b, *args)

    monkeypatch.setattr(P, "retire", counting)
    wf.reset_counts()
    img, rays, steps, occ = wf.render_units_pooled(
        port.scene, port.packed, port._run_cfg, FRAME, 0, n_pix, pool, alpha_pack=port.alpha_pack,
        features=port.features, track_steps=True, track_occupancy=True,
    )
    assert wf.LOOP["host_reads"] == wf.LOOP["iterations"]
    return (np.asarray(r_img), np.asarray(r_steps), int(r_rays), np.asarray(r_occ)), (
        img.numpy(), steps.numpy(), int(rays), occ.numpy(), own, wf.LOOP["iterations"])


@pytest.mark.parametrize("banners, spp, pool", CASES)
def test_pooled_matches_reference(banners, spp, pool, monkeypatch):
    (r_img, r_steps, r_rays, r_occ), (img, steps, rays, occ, own, iters) = _pooled_pair(
        banners, spp, pool, monkeypatch)
    # The schedule: the same iterations, each within 0.1% of the live lanes.
    n_it = int((r_occ >= 0).sum())
    assert occ.shape == r_occ.shape == (P.OCC_LEN,) and occ.dtype == np.int32
    assert int((occ >= 0).sum()) == n_it == iters > 3
    assert (occ[n_it:] == -1).all()
    assert (np.abs(occ[:n_it] - r_occ[:n_it]) <= 1e-3 * r_occ[:n_it]).all(), (occ[:n_it],
                                                                              r_occ[:n_it])
    assert occ[0] == min(pool, img.shape[0] * spp)
    if pool == 8192:  # the tiers: past the units, the pool decays below a sixteenth
        assert occ[n_it - 1] <= pool // 16
    # The image and the rays, as test_torch_render.py holds a frame.
    assert np.isfinite(img).all() and img.mean() > 0.0
    share = np.isclose(img, r_img, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert share >= 0.99, share
    assert abs(rays - r_rays) <= 1e-3 * r_rays, (rays, r_rays)
    # Steps.
    assert steps.shape == (img.shape[0],) and steps.dtype == np.int32
    np.testing.assert_array_equal(steps, own)
    if banners:
        # A ray an ulp apart (XLA's FMA) can test a box or a tie the other
        # way and visit other nodes, or meet another alpha candidate, on its
        # way to the same hit: 1.2% of pixels differ by -7 to +2 steps here
        # (sums 30,069 and 30,105), all within the image gate.
        assert (steps == r_steps).mean() >= 0.98, (steps == r_steps).mean()
        assert abs(int(steps.sum()) - int(r_steps.sum())) <= 5e-3 * r_steps.sum()
    assert (steps > 0).all()


# ---------------------------------------------------------------------------
# The plain versions against the reference's clauses on random pools
# ---------------------------------------------------------------------------

W, H = 64, 48


@pytest.fixture(scope="module")
def cameras():
    """The small atrium's camera at 64x48."""
    g, m, l, c, a = port_proc.atrium_scene(**SMALL_ATRIUM, with_banners=False)
    cam = with_aspect(port_render.build_scene(g, m, l, c, atlas=a).camera, W, H).to("cpu")
    return cam


def _slice(cam, spp, frame, stream=None, width=W, **kw):
    cfg = RenderConfig(width=width, height=H, max_depth=4, max_samples=spp, firefly_clamp=10.0,
                       **kw)
    return P.make_slice(cam, cfg, width * H, 96, frame if stream is None else stream, frame)


def _random_pool(rng, n, dead_share, n_units=5000):
    st = P.empty_pool(n, "cpu")
    f32 = lambda lo, hi, *s: torch.tensor(rng.uniform(lo, hi, s), dtype=torch.float32)  # noqa: E731
    for k in ("origin", "direction", "radiance", "throughput", "absorption"):
        st[k] = f32(-2.0, 2.0, n, 3)
    st["bsdf_pdf"], st["tdist"] = f32(0.0, 3.0, n), f32(0.0, 30.0, n)
    st["pix"] = torch.tensor(rng.integers(96, 96 + W * H, n))
    st["unit"] = torch.randperm(n_units, generator=torch.Generator().manual_seed(int(
        rng.integers(1 << 30))))[:n]
    st["depth"] = torch.tensor(rng.integers(0, 5, n))
    st["seed"] = torch.tensor(rng.integers(0, 2**32, n))
    st["active"] = torch.tensor(rng.random(n) >= dead_share)
    return st


def _copy(st):
    return {k: v.clone() for k, v in st.items()}


def _ref_regenerate(st, next_unit, sl, cam):
    """The reference's ``regenerate`` clauses (``vk_raytrace_tpu/integrator/
    wavefront.py:158-196``) in jax.numpy on the same pool."""
    from vk_raytrace_tpu.integrator.camera import generate_rays_for_pixels as ref_camera
    from vk_raytrace_tpu.models.schema import Camera as RefCamera

    dead = ~jnp.asarray(st["active"].numpy())
    rank = jnp.cumsum(dead.astype(jnp.int32)) - dead.astype(jnp.int32)
    unit = next_unit + rank
    granted = dead & (unit < sl.total_units)
    n_granted = min(int(dead.sum()), sl.total_units - next_unit)
    p_rank = unit // sl.spp
    local = P.unit_to_local(sl, p_rank) if sl.tiled else p_rank
    upix = jnp.uint32(sl.pix0) + local.astype(jnp.uint32)
    usamp = (unit % sl.spp).astype(jnp.uint32)
    seed = ref_rng.tea(upix, jnp.uint32(sl.stream) * sl.spp + usamp)
    rcam = RefCamera(*(jnp.asarray(np.asarray(x)) for x in (
        cam.view_inverse, cam.proj_inverse, cam.focal_dist, cam.aperture)))
    o, d, seed = ref_camera(rcam, sl.width, sl.height, upix, jnp.int32(sl.frame), seed)
    return (np.asarray(granted), np.asarray(upix).astype(np.int64), np.asarray(unit),
            np.asarray(o), np.asarray(d), np.asarray(seed).astype(np.int64),
            next_unit + n_granted)


@pytest.mark.parametrize("spp, frame, dead_share, granted_share, width", [
    (1, 0, 0.3, 0.0, W),    # frame 0: pixel centres
    (4, 1, 0.95, 0.5, W),   # mostly dead, jittered
    (3, 2, 0.6, 0.99, 60),  # fewer units left than dead lanes; 60 wide: not tiled
])
def test_regenerate_plain_matches_reference(cameras, spp, frame, dead_share, granted_share,
                                            width):
    rng = np.random.default_rng(17 + spp)
    sl = _slice(cameras, spp, frame, stream=frame * 2 + 1, width=width)
    st = _random_pool(rng, 2053, dead_share)
    next_unit = int(granted_share * sl.total_units)
    ctrl = torch.tensor([next_unit, 9, 11])
    occ = torch.full((P.OCC_LEN,), -1, dtype=torch.int32)
    before = _copy(st)
    P._regenerate_plain(st, ctrl, occ, 5, sl)
    granted, upix, unit, o, d, seed, next_ref = _ref_regenerate(before, next_unit, sl, cameras)
    assert granted.any() and not granted.all()
    assert ctrl.tolist() == [next_ref, 0, 11]
    assert int(occ[5]) == int(st["active"].sum()) == int(before["active"].sum()) + granted.sum()
    assert (occ[:5] == -1).all() and (occ[6:] == -1).all()
    g = torch.from_numpy(granted)
    np.testing.assert_array_equal(st["active"].numpy(), before["active"].numpy() | granted)
    np.testing.assert_array_equal(st["pix"][g].numpy(), upix[granted])
    np.testing.assert_array_equal(st["unit"][g].numpy(), unit[granted])
    np.testing.assert_array_equal(st["seed"][g].numpy(), seed[granted])
    # XLA on the CPU fuses the camera's products into FMAs: a few ulp.
    np.testing.assert_allclose(st["origin"][g].numpy(), o[granted], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(st["direction"][g].numpy(), d[granted], rtol=1e-5, atol=1e-6)
    for k, v in (("radiance", 0.0), ("throughput", 1.0), ("absorption", 0.0)):
        assert (st[k][g] == v).all(), k
    for k in ("depth", "bsdf_pdf", "tdist"):
        assert (st[k][g] == 0).all(), k
    for k in P.FIELDS:  # lanes not granted keep their state
        torch.testing.assert_close(st[k][~g], before[k][~g], rtol=0, atol=0)


def _random_bounce(rng, st):
    n = st["active"].shape[0]
    f32 = lambda lo, hi, *s: torch.tensor(rng.uniform(lo, hi, s), dtype=torch.float32)  # noqa: E731
    alive = torch.tensor(rng.random(n) < 0.7) & st["active"]
    b = dict(alive=alive, visible=torch.tensor(rng.random(n) < 0.6) & alive,
             occluded=torch.tensor(rng.random(n) < 0.4), radiance=f32(0.0, 40.0, n, 3),
             throughput=f32(0.0, 2.0, n, 3), nee=f32(0.0, 3.0, n, 3),
             rr_pcont=f32(-0.1, 1.0, n), pdf_b=f32(0.0, 3.0, n),
             seed=torch.tensor(rng.integers(0, 2**32, n)),
             hit_steps=torch.tensor(rng.integers(0, 60, n), dtype=torch.int32))
    return b


@pytest.mark.parametrize("rr", [True, False])
def test_retire_plain_matches_reference(cameras, rr):
    """The epilogue's clauses of the reference's ``bounce`` (:399-472)."""
    rng = np.random.default_rng(3 + rr)
    sl = _slice(cameras, 2, 1, rr=rr, rr_depth=2)
    n = 3001
    st = _random_pool(rng, n, 0.4, n_units=sl.total_units)
    b = _random_bounce(rng, st)
    ctrl = torch.tensor([sl.total_units, 0, 100])
    out = torch.zeros(sl.total_units + n, 3)
    steps = torch.zeros(sl.n_pix + 1, dtype=torch.int32)
    before = _copy(st)
    P._retire_plain(st, b, ctrl, out, steps, sl)

    j = {k: jnp.asarray(v.numpy()) for k, v in {**before, **b}.items() if k != "seed"}
    act, alive, vis = j["active"], j["alive"], j["visible"]
    rr_gate = j["depth"] >= sl.rr_depth if rr else jnp.zeros_like(alive)
    pcont = jnp.where(rr_gate, j["rr_pcont"], 1.0)
    radiance = j["radiance"] + jnp.where((vis & ~j["occluded"])[..., None], j["nee"], 0.0)
    seed, u_rr = ref_rng.rand(jnp.asarray(b["seed"].numpy()).astype(jnp.uint32))
    thr = j["throughput"]
    if rr:
        alive = alive & ~(rr_gate & (u_rr >= pcont))
        thr = jnp.where(alive[..., None], thr / jnp.maximum(pcont, 1e-9)[..., None], thr)
    depth = j["depth"] + act.astype(jnp.int64)
    alive = alive & (depth < sl.max_depth)
    died = np.asarray(act & ~alive)
    lum = ref_luminance(radiance)
    scale = jnp.where(lum > sl.clamp, sl.clamp / jnp.maximum(lum, 1e-20), 1.0)
    contrib = np.asarray(radiance * scale[..., None])

    assert 0 < died.sum() < act.sum()
    np.testing.assert_array_equal(st["active"].numpy(), np.asarray(alive))
    np.testing.assert_array_equal(st["radiance"].numpy(), np.asarray(radiance))
    np.testing.assert_array_equal(st["throughput"].numpy(), np.asarray(thr))
    np.testing.assert_array_equal(st["seed"].numpy(), np.asarray(seed).astype(np.int64))
    np.testing.assert_array_equal(st["depth"].numpy(), np.asarray(depth))
    np.testing.assert_array_equal(
        st["bsdf_pdf"].numpy(), np.asarray(jnp.where(alive, j["pdf_b"], j["bsdf_pdf"])))
    units = before["unit"].numpy()[died]
    # XLA may fuse the luminance's products into FMAs: a few ulp.
    np.testing.assert_allclose(out[units].numpy(), contrib[died], rtol=4e-7, atol=0)
    untouched = np.ones(sl.total_units, bool)
    untouched[units] = False
    assert (out[:sl.total_units][torch.from_numpy(untouched)] == 0).all()
    a = before["active"].numpy()
    assert ctrl.tolist() == [sl.total_units, int(np.asarray(alive).sum()),
                             100 + int(a.sum() + b["visible"].numpy().sum())]
    want = np.bincount(before["pix"].numpy()[a] - sl.pix0, b["hit_steps"].numpy()[a],
                       minlength=sl.n_pix)
    np.testing.assert_array_equal(steps[:sl.n_pix].numpy(), want)


# ---------------------------------------------------------------------------
# The kernels (host C++ build) against the plain versions
# ---------------------------------------------------------------------------


class _Stream:
    cuda_stream = 0


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source as host C++")
    out = tmp_path_factory.mktemp("wavefront_host")
    cpp = out / "wavefront_host.cpp"
    with open(os.path.join(cuda_build.CSRC, "wavefront.cu")) as f:
        cpp.write_text(re.sub(r"([A-Za-z_]\w*(?:<[^<>;()]*>)?)<<<(.*?)>>>\(",
                              r"vkrt_launch(\1, \2)(", f.read(), flags=re.S))
    lib = out / "libwavefront_host.so"
    res = subprocess.run(
        ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-DVKRT_REGEN_CHUNK=1", "-DVKRT_TORCH_CPU=1", f"-I{SHIM}",
         "-o", str(lib), str(cpp)], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    return str(lib)


@pytest.fixture
def host_kernels(host_lib, monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: _Stream())
    monkeypatch.setattr(P, "build", lambda verbose=False: host_lib)
    monkeypatch.setattr(P, "_lib", None)


def _same_state(a, b, camera_ulps=False):
    for k in a:
        if camera_ulps and k in ("origin", "direction"):
            torch.testing.assert_close(a[k], b[k], rtol=2.4e-7, atol=1.2e-7)
            continue
        x, y = (v.view(torch.int32) if v.dtype == torch.float32 else v for v in (a[k], b[k]))
        assert torch.equal(x, y), k


@pytest.mark.parametrize("n, dead_share, granted_share, frame, track", [
    (2053, 0.3, 0.0, 0, True),     # a fresh pool, frame 0
    (3001, 0.97, 0.4, 2, True),    # mostly dead, jittered
    (2053, 0.5, 1.0, 1, False),    # every unit granted already: nothing changes
    (8192 // 16, 0.8, 0.999, 3, True),  # the last tier's width, the last few units
    (1000, 1.0, 0.0, 1, True),     # every lane dead, a fresh slice
    (1500, 0.0, 0.2, 2, True),     # no lane dead: nothing granted
    (8 * 256 + 37, 0.6, 0.5, 1, True),  # off a multiple of the card's 256-lane chunk
])
def test_regenerate_kernel_matches_plain(host_kernels, cameras, n, dead_share, granted_share,
                                         frame, track):
    rng = np.random.default_rng(n + frame)
    sl = _slice(cameras, 4, frame)
    st = _random_pool(rng, n, dead_share)
    nu = int(granted_share * sl.total_units)
    runs = []
    for fn in (P._regenerate_plain, P._regenerate_cuda):
        s, ctrl = _copy(st), torch.tensor([nu, 7, 11])
        occ = torch.full((P.OCC_LEN,), -1, dtype=torch.int32) if track else None
        fn(s, ctrl, occ, 1030, sl)
        runs.append((s, ctrl, occ))
    (a, ca, oa), (b, cb, ob) = runs
    _same_state(a, b, camera_ulps=frame != 0)
    assert ca.tolist() == cb.tolist() and ca[1] == 0
    if track:
        assert torch.equal(oa, ob) and int(ob[-1]) == int(b["active"].sum())
    if granted_share == 1.0:
        _same_state(a, st)


@pytest.mark.parametrize("rr, track, n, dead_share", [
    (True, True, 4099, 0.35), (False, True, 4099, 0.35), (True, False, 4099, 0.35),
    (True, True, 1, 0.0),       # one lane, three: part of one block
    (False, True, 3, 0.0),
    (True, True, 2085, 0.35),   # off a multiple of the card's 256-lane block
    (True, True, 1 << 14, 0.35),  # the last tier's width of a 2^18 pool
])
def test_retire_kernel_matches_plain(host_kernels, cameras, rr, track, n, dead_share):
    rng = np.random.default_rng(11 + rr + 2 * track + (0 if n == 4099 else n))
    sl = _slice(cameras, 3 if n <= 4099 else 6, 1, rr=rr, rr_depth=1)  # a unit a lane
    st = _random_pool(rng, n, dead_share, n_units=sl.total_units)
    b = _random_bounce(rng, st)
    runs = []
    for fn in (P._retire_plain, P._retire_cuda):
        s, ctrl = _copy(st), torch.tensor([123, 0, 1000])
        out = torch.zeros(sl.total_units + n, 3)
        steps = torch.zeros(sl.n_pix + 1, dtype=torch.int32) if track else None
        fn(s, b, ctrl, out, steps, sl)
        runs.append((s, ctrl, out, steps))
    (a, ca, oa, sa), (k, ck, ok, sk) = runs
    _same_state(a, k)
    assert ca.tolist() == ck.tolist()
    assert torch.equal(oa[:sl.total_units].view(torch.int32), ok[:sl.total_units].view(torch.int32))
    if track:
        assert torch.equal(sa[:sl.n_pix], sk[:sl.n_pix]) and int(sk.sum()) > 0


def test_loop_through_host_kernels(host_kernels, monkeypatch):
    """The whole loop on the CPU through the host-built kernels (the wrappers
    routed to them) against the loop through the plain versions, frame 0
    (pixel centres, where the camera's normalise rounds alike here): the
    same iterations, occupancy, steps, rays and image bits; a pool of 8192
    lanes runs the tiers."""
    g, m, l, c, a = port_proc.atrium_scene(**SMALL_ATRIUM, with_banners=True)
    cfg = RenderConfig(**{**CFG, "max_samples": 3, "use_sun_sky": False, "max_depth": 3})
    r = port_render.Renderer(port_render.build_scene(g, m, l, c, atlas=a), cfg, device="cpu")
    runs = []
    for kern in (False, True):
        if kern:
            monkeypatch.setattr(P, "regenerate", lambda *x: P._regenerate_cuda(*x))
            monkeypatch.setattr(P, "retire", lambda *x: P._retire_cuda(*x))
        P.reset_launches()
        wf.reset_counts()
        img, rays, steps, occ = wf.render_units_pooled(
            r.scene, r.packed, r._run_cfg, 0, 0, W * H, 8192, alpha_pack=r.alpha_pack,
            features=r.features, track_steps=True, track_occupancy=True)
        runs.append((img, int(rays), steps, occ, dict(P.LAUNCHES), dict(wf.LOOP)))
    (ia, ra, sa, oa, la, loop_a), (ib, rb, sb, ob, lb, loop_b) = runs
    n_it = int((oa >= 0).sum())
    assert loop_a == loop_b == {"iterations": n_it, "host_reads": n_it}
    assert la == {"regenerate": 0, "retire": 0} and lb == {"regenerate": n_it, "retire": n_it}
    assert torch.equal(oa, ob) and oa[n_it - 1] <= 8192 // 16
    assert ra == rb and torch.equal(sa, sb)
    assert torch.equal(ia.view(torch.int32), ib.view(torch.int32))
