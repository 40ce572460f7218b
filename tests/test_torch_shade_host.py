"""The whole fused shading stage (``vkrt_shade_stage`` in ``csrc/shade.cu``)
run on the CPU: the CUDA source compiled as host C++ under the stand-in
headers ``tests/cuda_host_shim/`` (blocks of one thread, a one-lane warp,
g++ ``-ffp-contract=off``), bound through the port's own ctypes wrapper,
and held against the stage's plain version (``shade_inputs`` +
``_shade_plain``) on numpy-seeded hits and lane states: the 2x2-bay atrium
with its baked sky and ``bistro_scene(detail=0.05)`` (instanced), with full
MIS, the sun disk and the mip LOD each both ways, and every branch through
a synthetic shade-row and tap-row table (``chip_smoke.every_branch_stage``).
The body alone (``vkrt_shade``) is held against ``_shade_plain`` on
gathered inputs, and on lane counts off its 64-lane block bit for bit
against a longer run; its wrapper and C entry refuse rows that do not start
on 16 bytes; its records in shared memory (the runs of the shade row its
bulk copies move, their pieces and banks) are checked against what the body
reads from shade.cu's own constants. Skips where g++ is missing.

Tolerances: seeds, miss and the path length exact; alive and visible agree
on 99.99% of the lanes (the card gate's share); every output vector within
the card gate's rtol 1e-5 / atol 1e-6 on 99.5% of the lanes where the masks
agree, and every such lane within atol 1e-6 and the key's rtol in
``LOOSE_RTOL``. The card gate itself (``chip_smoke.py`` phases 6 and 10,
``tests/test_torch_cuda.py``) holds every agreeing lane to rtol 1e-5: there
the kernel and the plain stage both call libdevice. Here torch's CPU
kernels take sqrt, exp, log and the trigonometry from MKL's vector math,
which is not correctly rounded (``torch.sqrt`` of 22.291357 gives 4.7213721
where IEEE gives 4.7213726), and the host build takes C's libm: an ulp
apart, which an acos near +-1 or a GGX peak at roughness 0.001 grows. The
worst lanes measured over these cases (relative error past atol 1e-6):
pdf_b 2.0e-2 (the every-branch cases, 0.37% of the lanes past rtol 1e-5),
throughput 7.9e-4 (0.05%), new_dir 5.0e-5, rr_pcont 3.3e-5, light_dir
8.7e-6, nee 1.4e-6, light_dist 1.0e-7; new_origin, radiance and absorption
exact. ``LOOSE_RTOL`` sits 2.5-10x above those, so that a fault on a rare
branch that is off by more fails here and not only on the card.
"""

import dataclasses
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from vk_raytrace_torch import cuda_build
from vk_raytrace_torch import render as R
from vk_raytrace_torch.integrator import shade_fused as sf
from vk_raytrace_torch.integrator.shade import mat_features
from vk_raytrace_torch.models import procedural
from vk_raytrace_torch.models.schema import PBR_GLTF, RenderConfig
from vk_raytrace_torch.ops.traverse_fused import Hit

SHIM = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_host_shim")
SMALL_ATRIUM = dict(bays_x=2, bays_z=2, column_segments=16, column_rows=12)
N = 4096
SPREAD = 0.002
MASK_SHARE, RTOL, ATOL = 0.9999, 1e-5, 1e-6
LANE_SHARE = 0.995
LOOSE_RTOL = {"pdf_b": 5e-2, "throughput": 2e-3, "new_dir": 2e-4, "rr_pcont": 1e-4,
              "light_dir": 1e-4, "nee": 1e-5, "light_dist": 1e-5, "new_origin": RTOL,
              "radiance": RTOL, "absorption": RTOL}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source as host C++")
    out = tmp_path_factory.mktemp("shade_host")
    with open(os.path.join(cuda_build.CSRC, "shade.cu")) as f:
        src = f.read().replace("extern __shared__ float smem[];",
                               "float* smem = vkrt_dynamic_shared;")
        src = re.sub(r"([A-Za-z_]\w*(?:<[^<>;()]*>)?)<<<(.*?)>>>\(", r"vkrt_launch(\1, \2)(",
                     src, flags=re.S)
    cpp, lib = out / "shade_host.cpp", out / "libshade_host.so"
    cpp.write_text(src)
    res = subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                          f"-I{SHIM}", "-o", str(lib), str(cpp)], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    return str(lib)


class _Stream:
    cuda_stream = 0


@pytest.fixture
def host_kernel(host_lib, monkeypatch):
    """The wrapper bound to the host library; CPU tensors go to the kernel
    through ``_stage_launch`` / ``_shade_cuda`` (the plain dispatch is for
    ``shade_bounce_fused``)."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: _Stream())
    monkeypatch.setattr(sf, "build", lambda verbose=False: host_lib)
    monkeypatch.setattr(sf, "_lib", None)


def _baked(scene):
    cfg = RenderConfig(width=64, height=48, pbr_mode=PBR_GLTF, use_sun_sky=True)
    return R.prepare_sun_sky(scene, cfg, "cpu")[0]


@pytest.fixture(scope="module")
def scenes():
    """name -> (scene on the CPU, InstanceTable or None)."""
    out = {}
    g, m, l, c, a = procedural.atrium_scene(**SMALL_ATRIUM)
    out["atrium"] = (_baked(R.build_scene(g, m, l, c, atlas=a)).to("cpu"), None)
    p, i, m, l, c, a = procedural.bistro_scene(detail=0.05)
    b = _baked(R.build_instanced_scene(p, i, m, l, c, atlas=a))
    out["bistro"] = (dataclasses.replace(b, instances=None).to("cpu"), b.instances.inst.to("cpu"))
    return out


def _inputs(scene, instances, seed):
    """Hits on random triangles (10% misses) and random lane states."""
    rng = np.random.default_rng(seed)
    tri = rng.integers(0, scene.shade_rows.shape[0], N)
    tri[rng.random(N) < 0.1] = -1
    w = rng.dirichlet(np.ones(3), N).astype(np.float32)
    t = np.where(tri >= 0, rng.uniform(0.1, 20.0, N), 1e32).astype(np.float32)
    inst = None
    if instances is not None:
        inst = torch.tensor(rng.integers(0, instances.object_to_world.shape[0], N))
    hit = Hit(torch.tensor(t), torch.tensor(tri), torch.tensor(w[:, 1]), torch.tensor(w[:, 2]),
              torch.zeros(N, dtype=torch.int32), inst)
    d = rng.standard_normal((N, 3))
    d = torch.tensor(d / np.linalg.norm(d, axis=1, keepdims=True), dtype=torch.float32)
    return hit, chip_smoke.StageState(rng, d), rng


def _compare(kern, plain):
    for k in ("seed", "miss", "tdist"):
        if k in plain:
            assert torch.equal(kern[k], plain[k]), f"{k} differs"
    same = (kern["alive"] == plain["alive"]) & (kern["visible"] == plain["visible"])
    assert same.float().mean().item() >= MASK_SHARE
    for k in chip_smoke.STAGE_VEC_KEYS:
        if k == "tdist" or k not in plain:
            continue
        a, b = kern[k][same].double(), plain[k][same].double()
        torch.testing.assert_close(a, b, rtol=LOOSE_RTOL[k], atol=ATOL, equal_nan=True, msg=k)
        ok = torch.isclose(a, b, rtol=RTOL, atol=ATOL, equal_nan=True)
        ok = ok.reshape(ok.shape[0], -1).all(dim=1)
        assert ok.float().mean().item() >= LANE_SHARE, (k, ok.float().mean().item())
    assert kern["alive"].float().mean().item() > 0.2


CASES = [  # (scene, full_mis, sun_disk, mip)
    ("atrium", True, True, True),
    ("atrium", False, True, True),
    ("atrium", True, False, False),
    ("atrium", False, False, True),
    ("bistro", True, True, True),
    ("bistro", False, True, False),
    ("bistro", True, False, True),
]


@pytest.mark.parametrize("name,full_mis,sun_disk,mip", CASES)
def test_stage_kernel_matches_plain(host_kernel, scenes, name, full_mis, sun_disk, mip):
    scene, instances = scenes[name]
    hit, st, _ = _inputs(scene, instances, seed=len(CASES) * full_mis + 2 * sun_disk + mip)
    tables = sf.stage_tables(scene, instances)
    feats = mat_features(scene.materials)
    args = (scene, feats, full_mis, 0.5, 1.0, hit, *st.lanes())
    tail = (instances, sun_disk, (SPREAD, None) if mip else None, st.tdist)
    before = dict(sf.LAUNCHES)
    kern = sf._stage_launch(*args, *tail, tables)
    assert sf.LAUNCHES["shade_stage"] == before["shade_stage"] + 1
    assert sf.LAUNCHES["shade_bounce"] == before["shade_bounce"]
    plain = sf.shade_bounce_fused(*args, *tail, tables)
    assert sf.LAUNCHES["shade_stage"] == before["shade_stage"] + 1  # the CPU path is no launch
    _compare(kern, plain)


@pytest.mark.parametrize("name", ["atrium", "bistro"])
def test_stage_kernel_every_branch(host_kernel, scenes, name):
    """Every texture, anisotropy, the sun disk and the mip LOD over the
    synthetic tables: texel coordinates below zero, every wrap mode, mip
    chains on half the lanes, 5% misses."""
    scene, instances = scenes[name]
    hit, st, rng = _inputs(scene, instances, seed=77)
    tables = sf.stage_tables(scene, instances)
    scene2, tables2, hit2, feats = chip_smoke.every_branch_stage(scene, tables, hit, rng)
    for full_mis in (True, False):
        args = (scene2, feats, full_mis, 0.5, 1.0, hit2, *st.lanes())
        tail = (instances, True, (SPREAD, None), st.tdist)
        _compare(sf._stage_launch(*args, *tail, tables2), sf._stage_plain(*args, *tail))


def test_stage_refuses_and_allocates(host_kernel, scenes):
    """The wrapper refuses an input it does not take (a wrong dtype, no
    tables, the LOD's path length given whole); with no lanes it launches
    nothing."""
    scene, _ = scenes["atrium"]
    hit, st, _ = _inputs(scene, None, seed=3)
    tables = sf.stage_tables(scene)
    feats = mat_features(scene.materials)
    args = (scene, feats, False, 0.5, 1.0)
    lanes = st.lanes()
    with pytest.raises(ValueError, match="tri"):
        sf._stage_launch(*args, hit._replace(tri=hit.tri.int()), *lanes, None, False, None,
                         st.tdist, tables)
    with pytest.raises(ValueError, match="StageTables"):
        sf._stage_launch(*args, hit, *lanes, None, False, None, st.tdist, None)
    with pytest.raises(ValueError, match="path_tdist"):
        sf._stage_launch(*args, hit, *lanes, None, False, (SPREAD, st.tdist), None, tables)
    before = sf.LAUNCHES["shade_stage"]
    empty = Hit(*(x[:0] for x in hit[:5]), None)
    out = sf._stage_launch(*args, empty, *(x[:0] if x is not None else None for x in lanes),
                           None, False, None, st.tdist[:0], tables)
    assert sf.LAUNCHES["shade_stage"] == before and out["tdist"].shape == (0,)


@pytest.mark.parametrize("name", ["atrium", "bistro"])
def test_body_kernel_matches_plain(host_kernel, scenes, name):
    """The body alone on gathered inputs, every branch (the card's phases 6
    and 10 gate): the same tolerances."""
    scene, instances = scenes[name]
    hit, st, rng = _inputs(scene, instances, seed=5)
    x = sf.shade_inputs(scene, mat_features(scene.materials), True, 0.5, 1.0, hit,
                        *st.lanes(), instances=instances, sun_disk=True, mip=(SPREAD, st.tdist))
    srow, taps, aux, flags = chip_smoke.every_branch(x, rng, True)
    before = sf.LAUNCHES["shade_bounce"]
    k_vec, k_alive, k_vis = sf._shade_cuda(srow, taps, aux, flags)
    assert sf.LAUNCHES["shade_bounce"] == before + 1
    p_vec, p_alive, p_vis = sf._shade_plain(srow, taps, aux, flags)
    kern = dict(alive=k_alive, visible=k_vis, **{k: k_vec[:, 3 * j:3 * j + 3] for j, k in
                                                 enumerate(sf._VEC_OUT)})
    plain = dict(alive=p_alive, visible=p_vis, **{k: p_vec[:, 3 * j:3 * j + 3] for j, k in
                                                  enumerate(sf._VEC_OUT)})
    _compare(kern, plain)


def _body_args(scene, instances, seed):
    """Every-branch body inputs of N lanes (``chip_smoke.every_branch``)."""
    hit, st, rng = _inputs(scene, instances, seed=seed)
    x = sf.shade_inputs(scene, mat_features(scene.materials), True, 0.5, 1.0, hit,
                        *st.lanes(), instances=instances, sun_disk=True, mip=(SPREAD, st.tdist))
    return chip_smoke.every_branch(x, rng, True)


def _body_dict(out):
    vec, alive, vis = out
    return dict(alive=alive, visible=vis,
                **{k: vec[:, 3 * j:3 * j + 3] for j, k in enumerate(sf._VEC_OUT)})


@pytest.mark.parametrize("name", ["atrium", "bistro"])
def test_body_kernel_lane_counts_off_the_tile(host_kernel, scenes, name):
    """The body alone on lane counts off its 64-lane block: 1, 31, 33, 129
    and N + 7 (the every-branch inputs, the last 7 lanes repeated): each
    count's outputs equal the first lanes of the N + 7 run bit for bit (a
    lane's result does not depend on the lanes beside it or on where the
    last block ends), and the N + 7 run holds to ``_shade_plain`` with the
    module's tolerances; single-level and instanced."""
    scene, instances = scenes[name]
    srow, taps, aux, flags = _body_args(scene, instances, seed=11)
    full = tuple(torch.cat([t, t[:7]]) for t in (srow, taps, aux))
    whole = sf._shade_cuda(*full, flags)
    _compare(_body_dict(whole), _body_dict(sf._shade_plain(*full, flags)))
    for n in (1, 31, 33, 129, N + 7):
        before = sf.LAUNCHES["shade_bounce"]
        part = sf._shade_cuda(*(t[:n] for t in full), flags)
        assert sf.LAUNCHES["shade_bounce"] == before + 1
        for got, want in zip(part, whole):
            assert got.shape[0] == n
            assert torch.equal(got.view(torch.int32) if got.dtype == torch.float32 else got,
                               (want.view(torch.int32) if want.dtype == torch.float32
                                else want)[:n]), n


def test_body_kernel_refuses_misaligned_rows(host_kernel, scenes):
    """The body copies its rows in 16-byte pieces: the wrapper refuses a
    srow, taps or aux tensor that does not start on 16 bytes, and launches
    nothing; the C entry refuses it too."""
    scene, _ = scenes["atrium"]
    args = list(_body_args(scene, None, seed=12))
    n = 65
    args[:3] = [t[:n].contiguous() for t in args[:3]]

    def shifted(t):  # the same values one element past an aligned start
        out = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
        out.copy_(t)
        assert out.is_contiguous() and out.data_ptr() % 16
        return out

    before = sf.LAUNCHES["shade_bounce"]
    for k, name in enumerate(("srow", "taps", "aux")):
        bad = list(args)
        bad[k] = shifted(args[k])
        with pytest.raises(ValueError, match=name):
            sf._shade_cuda(*bad)
        out = torch.empty(n, sf.OUT_W)
        mask = torch.empty(n, dtype=torch.bool)
        assert sf._load().vkrt_shade(*(t.data_ptr() for t in bad[:3]), n, bad[3].bits(),
                                     out.data_ptr(), mask.data_ptr(), mask.data_ptr(),
                                     None) != 0
    assert sf.LAUNCHES["shade_bounce"] == before


@pytest.mark.parametrize("instanced", [False, True])
def test_body_records_hold_what_the_body_reads(instanced):
    """The body alone's records in shared memory, from shade.cu's own
    constants: the staged first words of the shade row (kRowWords, through
    kCcRough) hold every shade-row word the body reads with every flag on
    (``chip_smoke.shade_lanes``), and the row, aux and taps are whole
    16-byte pieces (the bulk copies' granule and alignment); a record is an
    odd number of pieces, so that a warp's 32 lanes reading one word meet a
    bank at most 4 times; a block's records fit the 227 KB a block may use.
    The host build runs blocks of one lane and shows none of this."""
    with open(os.path.join(cuda_build.CSRC, "shade.cu")) as f:
        src = f.read()

    def const(pattern):
        return int(re.search(pattern, src).group(1))

    assert "constexpr int kRowWords = kCcRough + 1;" in src
    row_words = const(r"constexpr int kMat = (\d+);") + const(r"kCcRough = kMat \+ (\d+);") + 1
    flags = sf.ShadeFlags(True, True, True, True, True, True, instanced)
    row, taps, aux = chip_smoke.shade_lanes(flags)
    n_aux = sf.aux_width(instanced)
    assert max(row) < row_words and max(aux) < n_aux and max(taps) < 16
    assert row_words % 4 == 0 and n_aux % 4 == 0
    assert "static constexpr int kWords = ((kTaps + 16) / 4 | 1) * 4;" in src
    words = ((row_words + n_aux + 16) // 4 | 1) * 4
    assert words // 4 % 2 == 1
    for k in range(words):
        assert np.bincount((np.arange(32) * words + k) % 32, minlength=32).max() == 4
    assert const(r"constexpr int kBodyLanes = (\d+);") * words * 4 <= 227 * 1024
