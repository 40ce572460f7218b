"""Card-only checks of the port (skip without CUDA). They import no JAX, so
they also run on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

The traversal kernel against its plain twin (CPU) for modes a/b/c on the
reduced atrium with banners and, with per-lane roots, on the small bistro's
subset tables, at row widths 16 and 32; the child sort, the capped and
no-gather entries and the two-level alpha machine against their plain
versions (exact), the single-level alpha rounds (their stack's spill
on ``chip_smoke.alpha_cloud`` too) and the two-level opaque
machine against their round loops (exact on tri/inst/seed/steps); two
builds of the sun&sky environment on the card, byte for byte; the
persistent mode a/b entry on the full atrium at both widths (bit for bit,
steps included), its occupancy and ptxas report, and its scratch reused
across calls; the whole shading stage kernel and the body alone
(single-level and instanced) against their plain versions; and the render
slices (atrium, bistro) on the card against the CPU; the Disney BSDF
(material grid), the debug modes through the unrolled integrator and its
masked closest hit on the card against the CPU; the brute-force
anchor on the card; ``Renderer.pick`` on the card against the CPU, and
beside a render loop in another thread against picks and frames made alone; the
CLI on the card (against ``--device cpu``, and a checkpointed run against
a straight one); the machines beyond 512 instances (their instance table in
global memory) on a small plaza against the chunked round loops; the
persistent machines' occupancy and ptxas report, and their stack's spill
on ``chip_smoke.cloud_instances`` against the round loops; the
instance-level split of an all-alpha pool on the card against the CPU; the
sharded step under NCCL at world size 1 against ``Renderer.step``; and the
graft entry on the card against the CPU; the wide back end's tree kernel
against its plain version and its two-level machine against its round loop
on the same CUDA tensors (bit for bit); the alpha pass's two forms (the
standalone root prefilter, then the rounds on its mask, against the rounds
alone, whose ray intake runs the need line) bit for bit, a fused atrium
frame that launches no standalone prefilter against the same frame through
the plain need mask and the loop's plain bookkeeping, and ``vkrt_retire``
against its plain version on a frame's pools and their tails; the body
alone on lane counts off its block and the standalone prefilter on ray
counts off its groups and past one stride of its persistent grid. Kernel vs twin: same float32 operations in the same order, rounded
per operation (nvcc -fmad=false), so ``tri`` and the hit masks are equal
and t within rtol 1e-5. Render: CUDA and CPU transcendentals round
differently, so 99% of pixels within rtol 1e-3 / atol 1e-4 and ray counts
within 0.1%, as in ``tests/test_torch_render.py``.
"""

import numpy as np
import pytest
import torch

from vk_raytrace_torch import render as R
from vk_raytrace_torch.models import procedural
from vk_raytrace_torch.models.schema import PBR_GLTF, RenderConfig
from vk_raytrace_torch.ops import tlas
from vk_raytrace_torch.ops import traverse_fused as tf
from vk_raytrace_torch.ops.bvh8 import build_accel_bundle
from vk_raytrace_torch.ops.traverse_wide import make_alpha_pack

try:  # where the reference is installed, its cache is kept out of these tests too
    from test_torch_traverse import isolated_reference  # noqa: F401 (autouse)
except ImportError:  # a card machine without JAX: nothing here reads that cache
    pass

SMALL_ATRIUM = dict(bays_x=3, bays_z=2, column_segments=16, column_rows=12)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.fixture(scope="module")
def scene():
    return procedural.atrium_scene(**SMALL_ATRIUM)


def _rays(seed, geom, n, alpha):
    rng = np.random.default_rng(seed)
    pos = np.asarray(geom.positions)
    lo, hi = pos.min(0), pos.max(0)
    o = rng.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo), (n, 3))
    if alpha:
        ids = np.where(np.asarray(geom.tri_flags) & 2)[0]
        p = pos[np.asarray(geom.indices)[rng.choice(ids, n)]]
        d = np.einsum("rk,rkc->rc", rng.dirichlet(np.ones(3), n), p) - o
    else:
        d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.tensor(o, dtype=torch.float32), torch.tensor(d, dtype=torch.float32)


@pytest.mark.parametrize("mode", tf.MODES)
def test_kernel_matches_twin(scene, mode):
    _need_cuda()
    _kernel_vs_twin(scene[0], mode, 16)


@pytest.mark.parametrize("mode", tf.MODES)
def test_w32_kernel_matches_twin(scene, mode):
    _need_cuda()
    _kernel_vs_twin(scene[0], mode, 32)


def _kernel_vs_twin(geom, mode, width):
    bundle = build_accel_bundle(geom, width=width)
    planar = bundle.alpha_planar if mode == "candidate" else bundle.opaque_planar
    n = 4099
    o, d = _rays(3, geom, n, alpha=mode == "candidate")
    rng = np.random.default_rng(4)
    t_max = torch.tensor(rng.uniform(0.5, 30.0, n), dtype=torch.float32)
    active = torch.tensor(rng.random(n) < 0.9)
    cull = mode != "any"
    twin = tf.traverse(planar.to("cpu"), o, d, t_max, active, mode=mode, cull=cull)
    key = tf.launch_key(mode, width)
    before = tf.LAUNCHES[key]
    kern = tf.traverse(planar.to("cuda"), o.cuda(), d.cuda(), t_max.cuda(), active.cuda(),
                       mode=mode, cull=cull)
    torch.cuda.synchronize()
    assert tf.LAUNCHES[key] == before + 1
    k = [None if x is None else x.cpu().numpy() for x in kern]
    p = [None if x is None else x.numpy() for x in twin]
    np.testing.assert_array_equal(k[1], p[1])
    np.testing.assert_allclose(k[0], p[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(k[4], p[4])  # identical node visits
    if mode == "candidate":
        np.testing.assert_allclose(k[5], p[5], rtol=1e-5, atol=1e-6)
    assert 0.05 < (p[1] >= 0).mean() < 0.99


def test_kernel_rejects_bad_input(scene):
    _need_cuda()
    planar = build_accel_bundle(scene[0]).opaque_planar.to("cuda")
    o = torch.zeros(8, 3, device="cuda")
    d = torch.ones(3, 8, device="cuda").t()  # not contiguous
    with pytest.raises(ValueError):
        tf.traverse(planar, o, d, torch.ones(8, device="cuda"))
    with pytest.raises(ValueError):
        tf.traverse(planar, o.double(), o, torch.ones(8, device="cuda"))
    good = torch.ones(8, 3, device="cuda")
    for mode, cull in (("closest", False), ("any", True)):  # pairs the kernel lacks
        with pytest.raises(ValueError):
            tf.traverse(planar, o, good, torch.ones(8, device="cuda"), mode=mode, cull=cull)


def test_render_slice_cuda_matches_cpu(scene):
    _need_cuda()
    g, m, l, c, a = scene
    small = R.build_scene(g, m, l, c, atlas=a)
    cfg = RenderConfig(width=64, height=48, max_depth=4, pbr_mode=PBR_GLTF,
                       firefly_clamp=10.0, use_sun_sky=True)
    small, run_cfg = R.prepare_sun_sky(small, cfg, "cpu")  # one env for both
    acc = build_accel_bundle(small.geometry)
    out = {}
    for dev in ("cuda", "cpu"):
        r = R.Renderer(small, run_cfg, device=dev, packed=acc)
        r.step()
        r.step()
        out[dev] = (r.accum.cpu().numpy(), r.last_rays)
    share = np.isclose(out["cuda"][0], out["cpu"][0], rtol=1e-3, atol=1e-4).all(-1).mean()
    assert share >= 0.99, share
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-3 * out["cpu"][1]


@pytest.mark.parametrize("full_mis", [True, False])
def test_shade_kernel_matches_plain(scene, full_mis):
    """The shading kernel against its plain torch version on the card, every
    flag on and the material lanes redrawn (``chip_smoke.every_branch``):
    the same float32 operations, so masks agree on 99.99% of lanes and
    vectors within rtol 1e-5 / atol 1e-6 where they agree."""
    _need_cuda()
    import chip_smoke
    from vk_raytrace_torch.integrator import shade_fused as sf
    from vk_raytrace_torch.integrator.shade import mat_features

    g, m, l, c, a = scene
    small = R.build_scene(g, m, l, c, atlas=a)
    cfg = RenderConfig(width=64, height=48, pbr_mode=PBR_GLTF, use_sun_sky=True)
    small, _ = R.prepare_sun_sky(small, cfg, "cpu")
    feats = mat_features(small.materials)
    small = small.to("cuda")
    planar = build_accel_bundle(g).opaque_planar.to("cuda")
    n = 8192
    o, d = _rays(7, g, n, alpha=False)
    o, d = o.cuda(), d.cuda()
    hit = tf.closest_hit_fused(planar, o, d)
    rng = np.random.default_rng(8)
    seed = torch.tensor(rng.integers(0, 2**32, n), device="cuda")
    z = torch.zeros(n, 3, device="cuda")
    x = sf.shade_inputs(small, feats, full_mis, 0.5, 1.0, hit, o, d, seed,
                        None, z, torch.ones(n, 3, device="cuda"), z, torch.zeros(n, device="cuda"),
                        sun_disk=True, mip=(0.002, hit.t))
    for args in ((x.srow, x.taps, x.aux, x.flags), chip_smoke.every_branch(x, rng, full_mis)):
        before = sf.LAUNCHES["shade_bounce"]
        kern = sf.shade(*args)
        torch.cuda.synchronize()
        assert sf.LAUNCHES["shade_bounce"] == before + 1
        plain = sf._shade_plain(*args)
        same = (kern[1] == plain[1]) & (kern[2] == plain[2])
        assert same.float().mean().item() >= 0.9999
        np.testing.assert_allclose(kern[0][same].cpu().numpy(), plain[0][same].cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert kern[1].float().mean().item() > 0.2


def _stage_vs_plain(scene, features, hit, st, instances, tables, full_mis, sun_disk, mip,
                    rng):
    """The stage kernel (one launch, not the body alone) against the plain
    stage on the card, then every branch through the synthetic tables
    (``chip_smoke.every_branch_stage``): ``chip_smoke.compare_stage``."""
    import chip_smoke
    from vk_raytrace_torch.integrator import shade_fused as sf

    args = (scene, features, full_mis, 0.5, 1.0, hit, *st.lanes())
    tail = (instances, sun_disk, (0.002, None) if mip else None, st.tdist)
    before = dict(sf.LAUNCHES)
    kern = sf.shade_bounce_fused(*args, *tail, tables)
    torch.cuda.synchronize()
    assert sf.LAUNCHES["shade_stage"] == before["shade_stage"] + 1
    assert sf.LAUNCHES["shade_bounce"] == before["shade_bounce"]
    chip_smoke.compare_stage(kern, sf._stage_plain(*args, *tail))
    scene2, tables2, hit2, feats = chip_smoke.every_branch_stage(scene, tables, hit, rng)
    args = (scene2, feats, full_mis, 0.5, 1.0, hit2, *st.lanes())
    tail = (instances, True, (0.002, None), st.tdist)
    chip_smoke.compare_stage(sf._stage_launch(*args, *tail, tables2), sf._stage_plain(*args, *tail))


@pytest.mark.parametrize("full_mis,sun_disk,mip", [(True, True, True), (False, False, False),
                                                   (False, True, False)])
def test_stage_kernel_matches_plain(scene, full_mis, sun_disk, mip):
    """The whole stage (``vkrt_shade_stage``) against ``shade_inputs`` +
    ``_shade_plain`` on the card, on the reduced atrium's camera-ray hits
    with random lane states: seeds and miss exact, masks on 99.99% of
    lanes, vectors within rtol 1e-5 / atol 1e-6 where they agree."""
    _need_cuda()
    import chip_smoke
    from vk_raytrace_torch.integrator import shade_fused as sf
    from vk_raytrace_torch.integrator.shade import mat_features

    g, m, l, c, a = scene
    small = R.build_scene(g, m, l, c, atlas=a)
    cfg = RenderConfig(width=64, height=48, pbr_mode=PBR_GLTF, use_sun_sky=True)
    small, _ = R.prepare_sun_sky(small, cfg, "cpu")
    feats = mat_features(small.materials)
    small = small.to("cuda")
    planar = build_accel_bundle(g).opaque_planar.to("cuda")
    n = 8192
    o, d = _rays(9, g, n, alpha=False)
    o, d = o.cuda(), d.cuda()
    hit = tf.closest_hit_fused(planar, o, d)
    rng = np.random.default_rng(12)
    st = chip_smoke.StageState(rng, d, origin=o)
    _stage_vs_plain(small, feats, hit, st, None, sf.stage_tables(small), full_mis, sun_disk,
                    mip, rng)


@pytest.fixture(scope="module")
def bistro():
    return procedural.bistro_scene(detail=0.05)


@pytest.mark.parametrize("mode", tf.MODES)
def test_roots_kernel_matches_twin(bistro, mode):
    """Per-lane roots (the two-level path): each ray's first instance
    candidate in object space, the kernel against the CPU twin."""
    _need_cuda()
    _roots_vs_twin(bistro, mode, 16)


@pytest.mark.parametrize("mode", tf.MODES)
def test_w32_roots_kernel_matches_twin(bistro, mode):
    _need_cuda()
    _roots_vs_twin(bistro, mode, 32)


def _roots_vs_twin(bistro, mode, width):
    import chip_smoke

    acc = tlas.build_instanced_accel(bistro[0], bistro[1], width=width).to("cuda")
    subset = "alp" if mode == "candidate" else "opq"
    rng = np.random.default_rng(9)
    origins = rng.uniform([-50, 0.5, -10], [50, 8, 10], (6000, 3))
    if subset == "alp":  # toward the foliage instances
        pick = rng.choice(np.nonzero(acc.inst_alpha.cpu().numpy())[0], 6000)
        o, d = chip_smoke.rays_toward_instances(rng, bistro[0], bistro[1], pick, origins, "cuda")
    else:
        o = torch.tensor(origins, dtype=torch.float32, device="cuda")
        d = torch.nn.functional.normalize(torch.randn(6000, 3, device="cuda"), dim=1)
    far = mode != "any"
    tm = torch.full((6000,), tf.INF, device="cuda") if far else torch.tensor(
        rng.uniform(0.5, 20.0, 6000), dtype=torch.float32, device="cuda")
    oo, dd, tm, root0, _ = chip_smoke.first_candidates(acc, subset, o, d, tm, 4099)
    planar = getattr(acc, f"blas_planar_{subset}")
    cull = mode != "any"
    key = tf.launch_key(f"{mode}_roots", width)
    before = tf.LAUNCHES[key]
    kern = tf.traverse(planar, oo, dd, tm, mode=mode, cull=cull, root0=root0)
    torch.cuda.synchronize()
    assert tf.LAUNCHES[key] == before + 1
    twin = tf.traverse(planar.to("cpu"), oo.cpu(), dd.cpu(), tm.cpu(), mode=mode, cull=cull,
                       root0=root0.cpu())
    k = [None if x is None else x.cpu().numpy() for x in kern]
    p = [None if x is None else x.numpy() for x in twin]
    np.testing.assert_array_equal(k[1], p[1])
    np.testing.assert_allclose(k[0], p[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(k[4], p[4])  # identical node visits
    assert 0.05 < (p[1] >= 0).mean()


@pytest.mark.parametrize("width", tf.WIDTHS)
def test_sort_kernel_matches_plain(width):
    """The child sort on the card against its plain version (a stable
    ``torch.sort`` with every miss as ``INF``, and a gather): keys with
    ties, misses (``INF``, larger keys, +inf, NaN) and signed zeros, exact
    bit for bit; a row count that leaves a partial block."""
    _need_cuda()
    from vk_raytrace_torch import travbench as tb

    rng = np.random.default_rng(50 + width)
    n = 20001
    keys = torch.tensor(rng.integers(0, 8, (n, width)) / 4.0 - 0.5, dtype=torch.float32)
    for share, value in ((0.3, tf.INF), (0.03, 3e33), (0.03, float("inf")), (0.05, float("nan")),
                         (0.05, -0.0)):
        keys[torch.tensor(rng.random((n, width)) < share)] = value
    refs = torch.tensor(rng.integers(-2**30, 2**30, (n, width)), dtype=torch.int32)
    plain = tf.sort_children(keys, refs)
    key = tf.launch_key("sort_children", width)
    before = tf.LAUNCHES[key]
    kern = tf.sort_children(keys.cuda(), refs.cuda())
    torch.cuda.synchronize()
    assert tf.LAUNCHES[key] == before + 1
    assert tb.same_sort([x.cpu() for x in kern], plain)


@pytest.mark.parametrize("width", tf.WIDTHS)
@pytest.mark.parametrize("any_hit", [False, True])
def test_alpha_machine_matches_round_loop(bistro, width, any_hit):
    """The alpha machine kernel (one launch, every ray's rounds) on the
    small bistro's rays toward its foliage against the round loop on the
    CPU (the plain version): tri, inst, seed and steps exact, t/u/v within
    rtol 1e-5 / atol 1e-6 (the same float32 operations, rounded alike);
    closest hit with culling and any hit without."""
    _need_cuda()
    import chip_smoke

    pool, inst, m, l, c, a = bistro
    scene = R.build_instanced_scene(pool, inst, m, l, c, atlas=a, width=width).to("cpu")
    acc = scene.instances
    pack = make_alpha_pack(scene.materials, scene.atlas, scene.geometry.tri_material)
    rng = np.random.default_rng(12 + width)
    n = 4099
    pick = rng.choice(np.nonzero(acc.inst_alpha.numpy())[0], n)
    o, d = chip_smoke.rays_toward_instances(rng, pool, inst, pick,
                                            rng.uniform([-50, 0.5, -10], [50, 8, 10], (n, 3)),
                                            "cpu")
    t_max = (torch.tensor(rng.uniform(1.0, 60.0, n), dtype=torch.float32) if any_hit
             else torch.full((n,), tf.INF))
    seed = torch.tensor(rng.integers(0, 2**32, n))
    act = torch.tensor(rng.random(n) < 0.95)
    plain = tlas._two_level_alpha_pass(acc, pack, o, d, t_max, seed, act, any_hit, not any_hit)
    key = tf.launch_key("alpha_machine", width)
    before = dict(tf.LAUNCHES)
    cuda = lambda x: x.to("cuda")  # noqa: E731
    kern = tlas._two_level_alpha_pass(acc.to("cuda"), make_alpha_pack(*(
        cuda(x) for x in (scene.materials, scene.atlas, scene.geometry.tri_material))),
        cuda(o), cuda(d), cuda(t_max), cuda(seed), cuda(act), any_hit, not any_hit)
    torch.cuda.synchronize()
    assert tf.LAUNCHES[key] == before[key] + 1
    assert tf.LAUNCHES[tf.launch_key("candidate_roots", width)] == before[
        tf.launch_key("candidate_roots", width)]
    k = [x.cpu() for x in kern]
    for i in (1, 4, 5, 6):  # tri, inst, seed, steps
        assert torch.equal(k[i], plain[i]), i
    for i in (0, 2, 3):
        np.testing.assert_allclose(k[i].numpy(), plain[i].numpy(), rtol=1e-5, atol=1e-6)
    assert 0.05 < (plain[1] >= 0).float().mean() < 0.99
    assert (plain[5] != seed).any()


def _pack_to(pack, dev):
    import dataclasses

    return dataclasses.replace(pack, rows=pack.rows.to(dev), alpha_plane=pack.alpha_plane.to(dev))


def _cpu_and_cuda_outputs_equal(kern, plain, exact, what):
    """Kernel outputs (on the card) against the loop's (on the CPU): the
    fields ``exact`` equal, the rest (t, u, v) within rtol 1e-5 / atol 1e-6."""
    k = [x.cpu() for x in kern]
    for i in range(len(k)):
        if i in exact:
            assert torch.equal(k[i].long(), plain[i].long()), (what, i)
        else:
            np.testing.assert_allclose(k[i].numpy(), plain[i].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{what} field {i}")


@pytest.mark.parametrize("width", tf.WIDTHS)
@pytest.mark.parametrize("kind", ["closest", "any"])
def test_alpha_rounds_kernel_matches_round_loop(scene, width, kind):
    """The single-level alpha rounds kernel (one launch, every ray's rounds)
    on the reduced atrium's rays toward its banners against the round loop
    on the CPU (the plain version), with the alpha pack and without it:
    tri, seed and steps exact, t/u/v within rtol 1e-5 / atol 1e-6; and
    ``closest_hit_bundle`` / ``any_hit_bundle`` on the card launch it once
    and the per-round candidate kernel never."""
    _need_cuda()
    from vk_raytrace_torch.ops import traverse_alpha as ta
    from vk_raytrace_torch.ops import traverse_wide as tw

    g, m, l, c, a = scene
    small = R.build_scene(g, m, l, c, atlas=a).to("cpu")
    bundle = build_accel_bundle(g, width=width).to("cpu")
    pack = make_alpha_pack(small.materials, small.atlas, small.geometry.tri_material)
    n = 4099
    o, d = _rays(13, g, n, alpha=True)
    rng = np.random.default_rng(14)
    t_lim = torch.tensor(rng.uniform(1.0, 40.0, n), dtype=torch.float32)
    seed = torch.tensor(rng.integers(0, 2**32, n))
    need = torch.tensor(rng.random(n) < 0.95)
    cull = kind == "closest"
    cuda = lambda x: x.to("cuda")  # noqa: E731
    planar = bundle.alpha_planar
    key = tf.launch_key("alpha_rounds", width)
    for pk in (pack, None):
        # The kernel's intake runs the alpha pass's need line on its mask.
        plain = ta._rounds_core(planar, pk, o, d, t_lim, seed,
                                tf._alpha_need_plain(planar, o, d, t_lim, need), cull)
        before = tf.LAUNCHES[key]
        kern = ta._rounds(planar.to("cuda"), None if pk is None else _pack_to(pk, "cuda"),
                          cuda(o), cuda(d), cuda(t_lim), cuda(seed), cuda(need), cull)
        torch.cuda.synchronize()
        assert tf.LAUNCHES[key] == before + 1
        _cpu_and_cuda_outputs_equal(kern, plain, (1, 4, 5), f"pack={pk is not None}")
        assert 0.05 < (plain[1] >= 0).float().mean() < 0.99
    assert (plain[4] == seed).all()  # the null pack draws nothing
    before = dict(tf.LAUNCHES)
    gb, gp = bundle.to("cuda"), _pack_to(pack, "cuda")
    if kind == "closest":
        tw.closest_hit_bundle(gb, gp, cuda(o), cuda(d), cuda(seed))
    else:
        tw.any_hit_bundle(gb, gp, cuda(o), cuda(d), cuda(t_lim), cuda(seed))
    torch.cuda.synchronize()
    assert tf.LAUNCHES[key] == before[key] + 1
    ck = tf.launch_key("candidate", width)
    assert tf.LAUNCHES[ck] == before[ck]


@pytest.mark.parametrize("width", tf.WIDTHS)
@pytest.mark.parametrize("kind", ["closest", "any"])
def test_alpha_rounds_spill_matches_round_loop(width, kind):
    """The single-level rounds kernel's stack spill: ``chip_smoke.
    alpha_cloud`` (an alpha tree whose rays push past the sixteen shared
    stack entries a thread) against the round loop on the CPU: tri, seed
    and steps exact, t/u/v within rtol 1e-5 / atol 1e-6; the deepest stack
    past the shared entries."""
    _need_cuda()
    import chip_smoke
    from vk_raytrace_torch.ops import traverse_alpha as ta

    planar, pack, rays = chip_smoke.alpha_cloud(np.random.default_rng(43), 1500, "cpu",
                                                width=width)
    cull = kind == "closest"
    o, d, t_lim, seed, act = rays
    # The kernel's intake runs the alpha pass's need line on its mask.
    plain = ta._rounds_core(planar, pack, o, d, t_lim, seed,
                            tf._alpha_need_plain(planar, o, d, t_lim, act), cull)
    kern = ta._rounds(planar.to("cuda"), _pack_to(pack, "cuda"), *(x.to("cuda") for x in rays),
                      cull)
    torch.cuda.synchronize()
    _cpu_and_cuda_outputs_equal(kern, plain, (1, 4, 5), f"cloud w{width} {kind}")
    assert 16 < tf.stack_reached(width, "cuda") <= planar.stack_depth
    assert (plain[1] >= 0).any()


@pytest.mark.parametrize("width", tf.WIDTHS)
def test_alpha_pass_forms_equal_on_card(scene, width):
    """The alpha pass's two forms on the card (``chip_smoke.fold_case``):
    (a) ``vkrt_root_prefilter``, then ``vkrt_alpha_rounds`` on its need
    mask; (b) ``vkrt_alpha_rounds`` alone on the pass's ``active``, its ray
    intake running the need line: bit for bit in t, tri, u, v, seed and
    steps, and (b)'s intake counts the need mask's rays; on the reduced
    atrium's rays toward its banners (95% active, closest and any hit) and
    on each of ``chip_smoke.prefilter_rays``' sets with ``active`` absent,
    about half and none."""
    _need_cuda()
    import chip_smoke

    g, m, l, c, a = scene
    small = R.build_scene(g, m, l, c, atlas=a).to("cuda")
    planar = build_accel_bundle(g, width=width).alpha_planar.to("cuda")
    pack = make_alpha_pack(small.materials, small.atlas, small.geometry.tri_material)
    n = 4099
    o, d = (x.to("cuda") for x in _rays(23, g, n, alpha=True))
    rng = np.random.default_rng(24)
    t_lim = torch.tensor(rng.uniform(1.0, 40.0, n), dtype=torch.float32, device="cuda")
    seed = torch.tensor(rng.integers(0, 2**32, n), device="cuda")
    act = torch.tensor(rng.random(n) < 0.95, device="cuda")
    for cull in (True, False):
        res = chip_smoke.fold_case(f"banners cull {cull}", (planar, o, d, t_lim, act),
                                   (pack, seed, cull), "card", reps=0)
        assert 0 < res["needed"] < n
    for k, case in enumerate(chip_smoke.PREFILTER_CASES):
        o, d, t_lim = (x.to("cuda") for x in chip_smoke.prefilter_rays(case, planar, n, rng))
        for j, active in enumerate(chip_smoke.PREFILTER_ACTIVE):
            act = chip_smoke.prefilter_active(active, n, rng)
            chip_smoke.fold_case(f"{case} {active}", (planar, o, d, t_lim,
                                                      None if act is None else act.to("cuda")),
                                 (pack, seed, (k + j) % 2 == 0), "card", reps=0)


def test_fused_frame_folds_the_prefilter(scene):
    """A fused atrium frame on the card launches the alpha rounds and no
    standalone root prefilter, and equals, byte for byte and ray for ray,
    the same frame through the plain versions of what the fold and the
    loop's bookkeeping replaced: the need mask by ``_alpha_need_plain``
    (then the rounds kernel on it) and ``_regenerate_plain`` /
    ``_retire_plain``."""
    _need_cuda()
    import chip_smoke
    from vk_raytrace_torch.integrator import pool as wp
    from vk_raytrace_torch.ops import traverse_alpha as ta

    g, m, l, c, a = scene
    cfg = RenderConfig(width=160, height=96, max_depth=4, max_samples=2, pbr_mode=PBR_GLTF,
                       firefly_clamp=10.0, use_sun_sky=True)
    r = R.Renderer(R.build_scene(g, m, l, c, atlas=a), cfg, device="cuda", fused_shade=True)
    r.render_frame(0)
    for mod in (tf, wp):
        mod.reset_launches()
    img = r.render_frame(1).cpu().numpy()
    rays = r.last_rays
    lau = {**tf.LAUNCHES, **wp.LAUNCHES}
    assert lau["alpha_rounds"] > 0 and lau["retire"] > 0, lau
    chip_smoke.assert_folded("fused frame", lau)
    real = ta._alpha_rounds

    def two_launches(planar, pack, o, d, t_limit, seed, active, cull):
        if seed is None:
            seed = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)
        need = tf._alpha_need_plain(planar, o, d, t_limit, active)
        t, tri, u, v, seed, steps = ta._alpha_rounds_cuda(planar, pack, o, d, t_limit, seed,
                                                          need, cull)
        return tf.Hit(t=t, tri=tri, u=u, v=v, steps=steps), seed

    ta._alpha_rounds = two_launches
    try:
        with chip_smoke.plain_pool():
            ref = r.render_frame(1).cpu().numpy()
    finally:
        ta._alpha_rounds = real
    assert np.isfinite(img).all() and img.mean() > 0.0
    assert img.tobytes() == ref.tobytes() and rays == r.last_rays


def test_retire_kernel_matches_plain_on_frame_pools(scene):
    """``vkrt_retire`` against ``_retire_plain`` on the pools of a fused
    atrium frame (``chip_smoke.capture_states``: a fresh pool, a full one,
    the tiers) and on the full pool cut to 1, 3 and 2,085 lanes: every lane
    field, the loop control, the retired units' radiance and the step
    record bit for bit."""
    _need_cuda()
    import chip_smoke
    from vk_raytrace_torch.integrator import pool as wp

    g, m, l, c, a = scene
    cfg = RenderConfig(width=320, height=192, max_depth=4, max_samples=1, pbr_mode=PBR_GLTF,
                       firefly_clamp=10.0, use_sun_sky=True)
    r = R.Renderer(R.build_scene(g, m, l, c, atlas=a), cfg, device="cuda", fused_shade=True)
    r.render_frame(0)
    _, retire = chip_smoke.capture_states(r, 1)
    full = next(x for w, x in retire if w.startswith("iteration 2,"))
    retire += [(f"first {n}", chip_smoke.cut_pool(full, n)) for n in chip_smoke.RETIRE_TAILS]
    assert len({x[0]["active"].shape[0] for _, x in retire}) >= 5
    for what, (st0, b, ctrl0, sl) in retire:
        n = st0["active"].shape[0]
        runs = []
        for fn in (wp._retire_cuda, wp._retire_plain):
            st, ctrl = {k: v.clone() for k, v in st0.items()}, ctrl0.clone()
            out = torch.zeros(sl.total_units + n, 3, device="cuda")
            steps = torch.zeros(sl.n_pix + 1, dtype=torch.int32, device="cuda")
            fn(st, b, ctrl, out, steps, sl)
            runs.append((st, {"ctrl": ctrl, "out": out[:sl.total_units],
                              "steps": steps[:sl.n_pix]}))
        torch.cuda.synchronize()
        chip_smoke.same_bits(what, runs[0][0], runs[1][0])
        chip_smoke.same_bits(what, runs[0][1], runs[1][1])


def test_environment_builds_equal_on_card():
    """Two builds of the atrium's sun&sky environment on the card (as
    ``Renderer`` builds it, ``render.prepare_sun_sky``): the baked image,
    the alias table, the pdfs and the packed rows byte for byte."""
    _need_cuda()
    import chip_smoke

    geom, mats, lights, cam, atlas = procedural.atrium_scene(**SMALL_ATRIUM)
    scene = R.build_scene(geom, mats, lights, cam, atlas=atlas)
    cfg = RenderConfig(width=64, height=48, use_sun_sky=True)
    r = R.Renderer(scene, cfg, device="cuda")
    assert chip_smoke.same_environment(r, scene, cfg) > 0


@pytest.mark.parametrize("width", tf.WIDTHS)
@pytest.mark.parametrize("any_hit", [False, True])
def test_opaque_machine_matches_round_loop(bistro, width, any_hit):
    """The two-level opaque machine kernel (one launch, every ray's opaque
    rounds) on the small bistro against the round loop on the CPU, over
    the opaque subsets (the alpha scenes' pass) and over the full table
    (the pass without an alpha pack): tri, inst and steps exact, t/u/v
    within rtol 1e-5 / atol 1e-6; closest hit with culling and any hit
    without. Some origins carry -0 coordinates, which the machine must
    move into object space unchanged."""
    _need_cuda()
    import chip_smoke

    pool, inst, m, l, c, a = bistro
    acc = R.build_instanced_scene(pool, inst, m, l, c, atlas=a, width=width).instances.to("cpu")
    rng = np.random.default_rng(15 + width)
    n = 4099
    origins = rng.uniform([-50, 0.5, -10], [50, 8, 10], (n, 3))
    origins[:64, 0] = -0.0
    o, d = chip_smoke.rays_toward_instances(rng, pool, inst, rng.choice(len(inst.mesh_id), n),
                                            origins, "cpu")
    t_max = (torch.tensor(rng.uniform(0.5, 20.0, n), dtype=torch.float32) if any_hit
             else torch.full((n,), tf.INF))
    act = torch.tensor(rng.random(n) < 0.95)
    key = tf.launch_key("opaque_machine", width)
    cacc = acc.to("cuda")
    for subset in ("opq", "full"):
        planar, roots, view, mask = tlas._subset(acc, subset)
        plain = tlas._two_level_pass(planar, roots, view, o, d, t_max, act, mask, not any_hit,
                                     any_hit)
        before = dict(tf.LAUNCHES)
        kern = tlas._two_level_opaque_pass(cacc, subset, o.to("cuda"), d.to("cuda"),
                                           t_max.to("cuda"), act.to("cuda"), not any_hit,
                                           any_hit)
        torch.cuda.synchronize()
        assert tf.LAUNCHES[key] == before[key] + 1
        roots_key = tf.launch_key("any_roots" if any_hit else "closest_roots", width)
        assert tf.LAUNCHES[roots_key] == before[roots_key]
        _cpu_and_cuda_outputs_equal(kern, plain, (1, 4, 5), subset)
        assert 0.05 < (plain[1] >= 0).float().mean() < 0.99


def _same_bits(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("case", ["opaque", "alpha", "roots"])
def test_wide_kernel_matches_plain(scene, bistro, case, any_hit):
    """``vkrt_traverse_wide`` (persistent warps, the stack in shared memory
    with its spill) against its plain version on the same CUDA tensors:
    every output (t, tri, u, v, steps, seed) bit for bit; the small atrium's
    opaque tree, its alpha tree toward the banners with the pack, and the
    small bistro's 8-wide BLAS from per-lane roots with the pack."""
    _need_cuda()
    import chip_smoke
    from vk_raytrace_torch.ops import bvh8
    from vk_raytrace_torch.ops import traverse_wide as tw

    dev = torch.device("cuda")
    rng = np.random.default_rng(21 + any_hit)
    n = 8191
    root0 = None
    if case == "roots":
        pool, inst, m, l, c, a = bistro
        bs = R.build_instanced_scene(pool, inst, m, l, c, atlas=a)
        acc = tlas.with_wide(bs.instances, bs.geometry).to(dev)
        wide = acc.blas
        o = torch.tensor(rng.uniform(-3, 3, (n, 3)), dtype=torch.float32, device=dev)
        d = torch.nn.functional.normalize(torch.tensor(rng.standard_normal((n, 3)),
                                                       dtype=torch.float32, device=dev), dim=1)
        roots = np.asarray(torch.as_tensor(acc.mesh_root).cpu())
        root0 = torch.tensor(roots[rng.integers(0, len(roots), n)], dtype=torch.int32,
                             device=dev)
        sc = bs.to(dev)
    else:
        geom, mats, lights, cam, atlas = scene
        opq, alp = bvh8.build_wide(geom)
        wide = (opq if case == "opaque" else alp).to(dev)
        ids = np.where(np.asarray(geom.tri_flags) & 2)[0] if case == "alpha" else np.arange(
            len(geom.indices))
        o, d = chip_smoke.rays_at(rng, geom, ids, n, dev)
        sc = R.build_scene(geom, mats, lights, cam, atlas=atlas).to(dev)
    pack = None if case == "opaque" else make_alpha_pack(sc.materials, sc.atlas,
                                                         sc.geometry.tri_material)
    t_max = (torch.tensor(rng.uniform(0.5, 30.0, n), dtype=torch.float32, device=dev) if any_hit
             else torch.full((n,), tf.INF, device=dev))
    seed = torch.tensor(rng.integers(0, 2**32, n), device=dev)
    active = torch.tensor(rng.random(n) < 0.95, device=dev)
    plain = tw._traverse_wide_plain(wide, pack, o, d, t_max, seed, active, any_hit, root0=root0)
    before = tf.LAUNCHES["traverse_wide"]
    kern = tw.traverse_wide(wide, pack, o, d, t_max, seed, active, any_hit, root0=root0)
    torch.cuda.synchronize()
    assert tf.LAUNCHES["traverse_wide"] == before + 1
    for name, a, b in zip(("t", "tri", "u", "v", "steps", "seed"), kern, plain):
        assert _same_bits(a, b), name
    assert (plain[1] >= 0).any()


@pytest.mark.parametrize("any_hit", [False, True])
def test_wide_machine_matches_round_loop(bistro, any_hit):
    """``vkrt_wide_machine`` (one launch a pass) on the small bistro against
    its plain version, the round loop, on the same CUDA tensors: every
    output bit for bit, for each pass of the instance-level split with and
    without the pack."""
    _need_cuda()
    import chip_smoke

    dev = torch.device("cuda")
    pool, inst, m, l, c, a = bistro
    bs = R.build_instanced_scene(pool, inst, m, l, c, atlas=a)
    acc = tlas.with_wide(bs.instances, bs.geometry).to(dev)
    sc = bs.to(dev)
    pack = make_alpha_pack(sc.materials, sc.atlas, sc.geometry.tri_material)
    rng = np.random.default_rng(31 + any_hit)
    n = 8191
    pick = rng.choice(len(inst.mesh_id), n)
    o, d = chip_smoke.rays_toward_instances(rng, pool, inst, pick,
                                            rng.uniform([-50, 0.5, -10], [50, 8, 10], (n, 3)),
                                            dev)
    t_max = (torch.tensor(rng.uniform(1.0, 60.0, n), dtype=torch.float32, device=dev)
             if any_hit else torch.full((n,), tf.INF, device=dev))
    seed = torch.tensor(rng.integers(0, 2**32, n), device=dev)
    act = torch.tensor(rng.random(n) < 0.95, device=dev)
    for part, with_pack in (("all", False), ("all", True), ("opaque", False), ("alpha", True)):
        args = (acc, pack if with_pack else None, o, d, t_max, seed, act, part, any_hit)
        before = tf.LAUNCHES["wide_machine"]
        kern = tlas._wide_pass(*args)
        torch.cuda.synchronize()
        assert tf.LAUNCHES["wide_machine"] == before + 1
        plain = tlas._wide_rounds(*args)
        for name, x, y in zip(("t", "tri", "u", "v", "inst", "seed", "steps"), kern, plain):
            assert _same_bits(x.to(y.dtype), y), (part, with_pack, name)
        assert (plain[1] >= 0).any()


@pytest.mark.parametrize("nogather", [False, True])
@pytest.mark.parametrize("width", tf.WIDTHS)
def test_capped_kernel_matches_plain(scene, width, nogather):
    """The capped entry and its no-gather variant (on the table padded to a
    row per ray) against the plain versions on the CPU at caps 0, 1, 8,
    kShStack - 1, kShStack and 40 (at width 16 the ring of shared entries
    below kShStack steps, else the spilling stack): exact."""
    _need_cuda()
    geom = scene[0]
    planar = build_accel_bundle(geom, width=width).opaque_planar.to("cpu")
    if nogather:
        planar = tf.own_rows(planar, 4099)
    o, d = _rays(11, geom, 4099, alpha=False)
    t_max = torch.full((4099,), tf.INF)
    key = tf.launch_key("nogather" if nogather else "capped", width)
    k = tf.shared_stack(width)
    full = tf.traverse(planar, o, d, t_max)[4] if not nogather else None
    gp, go, gd, gt = planar.to("cuda"), o.cuda(), d.cuda(), t_max.cuda()
    for cap in (0, 1, 8, k - 1, k, 40):
        plain = tf.traverse_capped(planar, o, d, t_max, cap, nogather=nogather)
        before = tf.LAUNCHES[key]
        kern = tf.traverse_capped(gp, go, gd, gt, cap, nogather=nogather)
        torch.cuda.synchronize()
        assert tf.LAUNCHES[key] == before + 1
        for a, b in zip(kern[:5], plain[:5]):
            assert torch.equal(a.cpu(), b), cap
        if nogather:  # no-gather rays never end
            assert bool((plain[4] == cap).all())
        else:
            assert int(plain[4].max()) == min(cap, int(full.max()))
    if nogather:
        assert tf.capped_stack_reached(width, gp.rows.device) > tf.CAPPED_STACK  # past 128: dropped


@pytest.mark.parametrize("full_mis", [True, False])
def test_instanced_shade_kernel_matches_plain(bistro, full_mis):
    """The instanced shading kernel (72-lane aux) against its plain torch
    version on the card: the bistro's camera hits with their instances, and
    every branch."""
    _need_cuda()
    import chip_smoke
    from vk_raytrace_torch.integrator import shade_fused as sf
    from vk_raytrace_torch.integrator.camera import generate_rays_for_pixels
    from vk_raytrace_torch.ops import rng as vrng

    pool, inst, m, l, c, a = bistro
    cfg = RenderConfig(width=128, height=72, pbr_mode=PBR_GLTF, use_sun_sky=True)
    r = R.Renderer(R.build_instanced_scene(pool, inst, m, l, c, atlas=a), cfg, device="cuda",
                   fused_shade=True)
    pix = torch.arange(128 * 72, device="cuda")
    o, d, _ = generate_rays_for_pixels(r.scene.camera, 128, 72, pix, 1, vrng.tea(pix, 0))
    o, d = o.contiguous(), d.contiguous()
    n = o.shape[0]
    rng = np.random.default_rng(10)
    seed = torch.tensor(rng.integers(0, 2**32, n), device="cuda")
    hit, _ = tlas.closest_hit_instanced(r.packed, r.alpha_pack, o, d, seed=seed)
    z = torch.zeros(n, 3, device="cuda")
    x = sf.shade_inputs(r.scene, r.features, full_mis, 0.5, 1.0, hit, o, d, seed, None, z,
                        torch.ones(n, 3, device="cuda"), z, torch.zeros(n, device="cuda"),
                        instances=r.packed.inst, sun_disk=True, mip=(0.002, hit.t))
    assert x.flags.instanced and x.aux.shape[1] == 72
    for args in ((x.srow, x.taps, x.aux, x.flags), chip_smoke.every_branch(x, rng, full_mis)):
        before = sf.LAUNCHES["shade_bounce"]
        kern = sf.shade(*args)
        torch.cuda.synchronize()
        assert sf.LAUNCHES["shade_bounce"] == before + 1
        plain = sf._shade_plain(*args)
        same = (kern[1] == plain[1]) & (kern[2] == plain[2])
        assert same.float().mean().item() >= 0.9999
        np.testing.assert_allclose(kern[0][same].cpu().numpy(), plain[0][same].cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert kern[1].float().mean().item() > 0.2


def _body_every_branch(scene, bistro, instanced, rng):
    """Every-branch inputs of the body alone on the card (``chip_smoke.
    every_branch``): the reduced atrium's hits, or the small bistro's camera
    hits with their instances."""
    import chip_smoke
    from vk_raytrace_torch.integrator import shade_fused as sf
    from vk_raytrace_torch.integrator.camera import generate_rays_for_pixels
    from vk_raytrace_torch.ops import rng as vrng

    cfg = RenderConfig(width=128, height=72, pbr_mode=PBR_GLTF, use_sun_sky=True)
    if instanced:
        pool, inst, m, l, c, a = bistro
        sc = R.build_instanced_scene(pool, inst, m, l, c, atlas=a)
    else:
        g, m, l, c, a = scene
        sc = R.build_scene(g, m, l, c, atlas=a)
    r = R.Renderer(sc, cfg, device="cuda", fused_shade=True)
    pix = torch.arange(128 * 72, device="cuda")
    o, d, _ = generate_rays_for_pixels(r.scene.camera, 128, 72, pix, 1, vrng.tea(pix, 0))
    o, d = o.contiguous(), d.contiguous()
    n = o.shape[0]
    seed = torch.tensor(rng.integers(0, 2**32, n), device="cuda")
    if instanced:
        hit, _ = tlas.closest_hit_instanced(r.packed, r.alpha_pack, o, d, seed=seed)
    else:
        hit = tf.closest_hit_fused(r.packed.opaque_planar, o, d)
    z = torch.zeros(n, 3, device="cuda")
    x = sf.shade_inputs(r.scene, r.features, True, 0.5, 1.0, hit, o, d, seed, None, z,
                        torch.ones(n, 3, device="cuda"), z, torch.zeros(n, device="cuda"),
                        instances=r.packed.inst if instanced else None, sun_disk=True,
                        mip=(0.002, hit.t))
    return chip_smoke.every_branch(x, rng, True)


@pytest.mark.parametrize("instanced", [False, True])
def test_body_kernel_lane_counts_on_card(scene, bistro, instanced):
    """The body alone on lane counts off its 64-lane block (1, 31, 33, 129
    and all lanes + 7, the last 7 repeated), every branch: each count's
    outputs equal the first lanes of the longest run bit for bit, and that
    run holds to the plain version (masks on 99.99% of the lanes, vectors
    within rtol 1e-5 / atol 1e-6 where they agree); a srow or aux that does
    not start on 16 bytes is refused."""
    _need_cuda()
    from vk_raytrace_torch.integrator import shade_fused as sf

    rng = np.random.default_rng(12 + instanced)
    srow, taps, aux, flags = _body_every_branch(scene, bistro, instanced, rng)
    full = tuple(torch.cat([t, t[:7]]) for t in (srow, taps, aux))
    n_all = full[0].shape[0]
    whole = sf.shade(*full, flags)
    plain = sf._shade_plain(*full, flags)
    same = (whole[1] == plain[1]) & (whole[2] == plain[2])
    assert same.float().mean().item() >= 0.9999
    np.testing.assert_allclose(whole[0][same].cpu().numpy(), plain[0][same].cpu().numpy(),
                               rtol=1e-5, atol=1e-6)
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t  # noqa: E731
    for n in (1, 31, 33, 129, n_all):
        part = sf.shade(*(t[:n] for t in full), flags)
        torch.cuda.synchronize()
        for got, want in zip(part, whole):
            assert torch.equal(bits(got), bits(want)[:n]), n
    for k, name in ((0, "srow"), (2, "aux")):
        bad = list(full)
        t = full[k]
        bad[k] = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")[1:].view(t.shape)
        bad[k].copy_(t)
        with pytest.raises(ValueError, match=name):
            sf.shade(*bad, flags)


@pytest.mark.parametrize("width", tf.WIDTHS)
def test_root_prefilter_counts_on_card(scene, width):
    """The standalone prefilter (persistent blocks, quad boxes first) on
    counts that fill no block (1, 3, 5, 255, 1021) and on more rays than any
    resident grid takes in one stride (1,100,003 > 132 SMs x 2,048 threads),
    each of ``chip_smoke.prefilter_rays``' sets with
    ``active`` absent, about half and none: equal to ``_alpha_need_plain``
    bool for bool."""
    _need_cuda()
    import chip_smoke

    g = scene[0]
    planar = build_accel_bundle(g, width=width).alpha_planar.to("cuda")
    rng = np.random.default_rng(40 + width)
    big = 1_100_003
    for case in chip_smoke.PREFILTER_CASES:
        rays = [x.to("cuda") for x in chip_smoke.prefilter_rays(case, planar, big, rng)]
        for active in chip_smoke.PREFILTER_ACTIVE:
            act = chip_smoke.prefilter_active(active, big, rng)
            act = None if act is None else act.to("cuda")
            for n in (1, 3, 5, 255, 1021, big):
                sub = [x[:n] for x in rays] + [None if act is None else act[:n]]
                kern = tf.alpha_need(planar, *sub)
                plain = tf._alpha_need_plain(planar, *sub)
                assert torch.equal(kern, plain), (case, active, n, int((kern != plain).sum()))


@pytest.mark.parametrize("full_mis,sun_disk,mip", [(True, True, True), (False, False, False),
                                                   (False, True, True)])
def test_instanced_stage_kernel_matches_plain(bistro, full_mis, sun_disk, mip):
    """The instanced whole stage against the plain stage on the card: the
    small bistro's camera hits with their instances, random lane states,
    the renderer's own stage tables."""
    _need_cuda()
    import chip_smoke
    from vk_raytrace_torch.integrator import shade_fused as sf
    from vk_raytrace_torch.integrator.camera import generate_rays_for_pixels
    from vk_raytrace_torch.ops import rng as vrng

    pool, inst, m, l, c, a = bistro
    cfg = RenderConfig(width=128, height=72, pbr_mode=PBR_GLTF, use_sun_sky=True)
    r = R.Renderer(R.build_instanced_scene(pool, inst, m, l, c, atlas=a), cfg, device="cuda",
                   fused_shade=True)
    pix = torch.arange(128 * 72, device="cuda")
    o, d, _ = generate_rays_for_pixels(r.scene.camera, 128, 72, pix, 1, vrng.tea(pix, 0))
    o, d = o.contiguous(), d.contiguous()
    rng = np.random.default_rng(13)
    seed = torch.tensor(rng.integers(0, 2**32, o.shape[0]), device="cuda")
    hit, _ = tlas.closest_hit_instanced(r.packed, r.alpha_pack, o, d, seed=seed)
    st = chip_smoke.StageState(rng, d, origin=o)
    assert r._shade_tables is not None and r._shade_tables.o2w is not None
    _stage_vs_plain(r.scene, r.features, hit, st, r.packed.inst, r._shade_tables, full_mis,
                    sun_disk, mip, rng)


@pytest.mark.parametrize("fused", [False, True])
def test_bistro_slice_cuda_matches_cpu(bistro, fused):
    _need_cuda()
    pool, inst, m, l, c, a = bistro
    cfg = RenderConfig(width=64, height=40, max_depth=4, pbr_mode=PBR_GLTF, firefly_clamp=10.0,
                       use_sun_sky=True, full_mis=False)
    scene, run_cfg = R.prepare_sun_sky(R.build_instanced_scene(pool, inst, m, l, c, atlas=a),
                                       cfg, "cpu")  # one env for both
    out = {}
    for dev in ("cuda", "cpu"):
        r = R.Renderer(scene, run_cfg, device=dev, fused_shade=fused)
        r.step()
        r.step()
        out[dev] = (r.accum.cpu().numpy(), r.last_rays)
    share = np.isclose(out["cuda"][0], out["cpu"][0], rtol=1e-3, atol=1e-4).all(-1).mean()
    assert share >= 0.99, share
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-3 * out["cpu"][1]


@pytest.fixture(scope="module")
def full_atrium():
    """The full atrium's geometry and camera (built only where a card runs
    the tests that take it)."""
    geom, _, _, cam, _ = procedural.atrium_scene()
    return geom, cam


@pytest.mark.parametrize("width", tf.WIDTHS)
@pytest.mark.parametrize("mode", ["closest", "any"])
def test_persistent_ab_matches_twin_full_atrium(full_atrium, width, mode):
    """Modes a/b from the root (the persistent entry) on the full atrium,
    chip_smoke's phase-3 rays cut to 2^16: t, tri, u, v and steps equal the
    twin's bit for bit; the deepest stack within the tree's bound."""
    _need_cuda()
    import chip_smoke as cs
    from vk_raytrace_torch import travbench as tb
    from vk_raytrace_torch.integrator.camera import with_aspect

    geom, cam = full_atrium
    planar = build_accel_bundle(geom, width=width).opaque_planar.to("cuda")
    rng = np.random.default_rng(1234)
    n = 1 << 16
    oc, dc = cs.camera_rays(with_aspect(cam, 1920, 1080).to("cuda"), 1920, 1080, n // 2, rng,
                            "cuda")
    orr, drr = cs.random_rays(rng, np.asarray(geom.positions), n // 2, "cuda")
    o, d = torch.cat([oc, orr]).contiguous(), torch.cat([dc, drr]).contiguous()
    tm = (torch.full((n,), tf.INF, device="cuda") if mode == "closest" else
          torch.tensor(rng.uniform(0.5, 20.0, n), dtype=torch.float32, device="cuda"))
    cull = mode == "closest"
    kern = tf.traverse(planar, o, d, tm, mode=mode, cull=cull)
    twin = tf._traverse_plain(planar, o, d, tm, None, mode, cull)
    torch.cuda.synchronize()
    assert tb.same_hits(kern, twin)
    assert 0 < tf.stack_reached(width, "cuda") <= planar.stack_depth


@pytest.mark.parametrize("mode", ["closest", "any"])
def test_persistent_ab_occupancy_and_report(mode):
    """The occupancy entry: at least one block of 128 resides per SM, and
    ptxas's report of the kernel is kept beside the library."""
    _need_cuda()
    from vk_raytrace_torch import cuda_build

    for width in tf.WIDTHS:
        assert tf.ab_occupancy(width, mode) >= 1
        res = cuda_build.resources(f"traverse{width}",
                                   f"persistent_traverse_kernelILi{tf._MODE_ID[mode]}E")
        assert res["registers"] > 0


@pytest.mark.parametrize("mode, cull, roots", [
    ("candidate", True, False), ("candidate", False, False), ("closest", True, True),
    ("any", False, True), ("candidate", True, True), ("candidate", False, True)])
def test_round_occupancy_and_report(mode, cull, roots):
    """Each per-round kernel (mode c from the root, every mode with roots):
    at least one block of 128 resides per SM, and ptxas's report of it is
    kept beside the library."""
    _need_cuda()
    from vk_raytrace_torch import cuda_build

    for width in tf.WIDTHS:
        assert tf.round_occupancy(width, mode, cull, roots) >= 1
        res = cuda_build.resources(
            f"traverse{width}", f"round_traverse_kernelILi{tf._MODE_ID[mode]}ELb{int(cull)}"
                                f"ELi{width}ELb{int(roots)}E")
        assert res["registers"] > 0


def test_persistent_ab_scratch_reused(scene):
    """Two calls on one stream share the entry's scratch (its ray counter is
    zeroed by each call): the second call, on other rays, and a third on the
    first rays give what each gives alone; a deeper tree grows the scratch."""
    _need_cuda()
    planar = build_accel_bundle(scene[0]).opaque_planar.to("cuda")
    inf = lambda n: torch.full((n,), tf.INF, device="cuda")  # noqa: E731
    o1, d1 = (x.cuda() for x in _rays(21, scene[0], 5000, alpha=False))
    o2, d2 = (x.cuda() for x in _rays(22, scene[0], 3001, alpha=False))
    first = tf.traverse(planar, o1, d1, inf(5000))
    second = tf.traverse(planar, o2, d2, inf(3001))
    third = tf.traverse(planar, o1, d1, inf(5000))
    torch.cuda.synchronize()
    from vk_raytrace_torch import travbench as tb

    assert tb.same_hits(first, third)
    assert tb.same_hits(second, tf._traverse_plain(planar, o2, d2, inf(3001), None, "closest",
                                                   True))
    key = (torch.device("cuda", torch.cuda.current_device()),
           torch.cuda.current_stream().cuda_stream)
    before = tf._AB_GRIDS[16].scratch[key].numel()
    deep = tf.PlanarScene(planar.rows, 100, 16)  # a stack bound past the shared entries
    again = tf.traverse(deep, o1, d1, inf(5000))
    torch.cuda.synchronize()
    assert tf._AB_GRIDS[16].scratch[key].numel() > before
    assert tb.same_hits(first, again)


def _two_renders(scene, cfg, n_frames=2, **kw):
    """The same renderer on the card and on the CPU: {dev: (accum, rays)}."""
    out = {}
    for dev in ("cuda", "cpu"):
        r = R.Renderer(scene, cfg, device=dev, **kw)
        for _ in range(n_frames):
            r.step()
        out[dev] = (r.hdr().cpu().numpy(), r.last_rays)
    assert np.isfinite(out["cuda"][0]).all() and out["cuda"][0].max() > 0.0
    share = np.isclose(out["cuda"][0], out["cpu"][0], rtol=1e-3, atol=1e-4).all(-1).mean()
    assert share >= 0.99, share
    return out


def test_disney_slice_cuda_matches_cpu():
    """The Disney BSDF (the default config) on the material grid under the
    procedural sky: card against CPU."""
    _need_cuda()
    from vk_raytrace_torch.models import hdr

    g, m, l, c = procedural.material_test_grid(n=2)
    scene = R.build_scene(g, m, l, c, env=hdr.build_environment(hdr.procedural_sky_hdr()))
    out = _two_renders(scene, RenderConfig(width=48, height=32, max_depth=6, max_samples=2,
                                           firefly_clamp=10.0, full_mis=False))
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-3 * out["cpu"][1]


@pytest.mark.parametrize("mode", [1, 2, 7, 12])
def test_debug_mode_cuda_matches_cpu(scene, mode):
    """The unrolled integrator on the card (modes a/b and the alpha rounds
    kernel with an active mask) against the CPU, on the atrium with
    banners: base colour, normal, texcoord and the step heatmap."""
    _need_cuda()
    g, m, l, c, a = scene
    small = R.build_scene(g, m, l, c, atlas=a)
    cfg = RenderConfig(width=64, height=48, max_depth=3, pbr_mode=PBR_GLTF, firefly_clamp=10.0,
                       use_sun_sky=True, debug_mode=mode)
    small, run_cfg = R.prepare_sun_sky(small, cfg, "cpu")
    tf.reset_launches()
    _two_renders(small, run_cfg, n_frames=1, packed=build_accel_bundle(small.geometry))
    assert all(tf.LAUNCHES[k] > 0 for k in ("closest", "any", "alpha_rounds")), tf.LAUNCHES


def test_closest_hit_bundle_mask_on_card(scene):
    """Rays outside the active mask miss and keep their seed on the card as
    on the CPU, through mode a and the alpha rounds kernel."""
    _need_cuda()
    from vk_raytrace_torch.ops.traverse_wide import closest_hit_bundle

    g = scene[0]
    o, d = _rays(31, g, 4096, alpha=True)
    active = torch.arange(4096) % 3 != 0
    seed = torch.arange(4096, dtype=torch.int64) * 2654435761 % 2**32
    sc = R.build_scene(*scene[:4], atlas=scene[4])
    out = {}
    for dev in ("cuda", "cpu"):
        s = sc.to(dev)
        acc = build_accel_bundle(g).to(dev)
        pack = make_alpha_pack(s.materials, s.atlas, s.geometry.tri_material)
        hit, sd = closest_hit_bundle(acc, pack, o.to(dev), d.to(dev), seed.to(dev),
                                     active=active.to(dev))
        out[dev] = (hit.tri.cpu(), hit.t.cpu(), sd.cpu())
    assert torch.equal(out["cuda"][0], out["cpu"][0]) and torch.equal(out["cuda"][2], out["cpu"][2])
    assert (out["cuda"][0][~active] == -1).all() and torch.equal(out["cuda"][2][~active], seed[~active])
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-5, atol=1e-5)


def test_anchor_on_card():
    """The BVH kernels against the brute-force tracer on the card (the
    anchor's criterion), Cornell box, glTF."""
    _need_cuda()
    import dataclasses

    from vk_raytrace_torch.integrator import brute
    from vk_raytrace_torch.integrator.camera import with_aspect
    from vk_raytrace_torch.integrator.shade import mat_features

    g, m, l, c = procedural.cornell_box()
    sc = R.build_scene(g, m, l, c)
    cfg = RenderConfig(width=64, height=64, max_depth=4, max_samples=2, pbr_mode=PBR_GLTF,
                       hdr_multiplier=0.0, rr=False)
    feats = mat_features(sc.materials)
    sc = dataclasses.replace(sc, camera=with_aspect(sc.camera, 64, 64)).to("cuda")
    packed = build_accel_bundle(g).to("cuda")
    img = brute.anchor_render(sc, packed, cfg, 2, feats).cpu().numpy()
    ref = brute.anchor_render(sc, packed, cfg, 2, feats,
                              tracer=brute.BruteTracer(sc.geometry)).cpu().numpy()
    ok, share, rmse = brute.images_match(img, ref)
    assert ok, (share, rmse)


def test_pick_on_card_matches_cpu():
    """``pick`` on the card against ``pick_many`` on the CPU: the reduced
    atrium (banners picked as opaque) and the small bistro (two levels)."""
    _need_cuda()
    g, m, l, c, a = procedural.atrium_scene(**SMALL_ATRIUM)
    pool, inst, bm, bl, bc, ba = procedural.bistro_scene(detail=0.05)
    cfg = RenderConfig(width=96, height=54)
    rng = np.random.default_rng(4)
    xs, ys = rng.integers(0, 96, 64), rng.integers(0, 54, 64)
    for sc in (R.build_scene(g, m, l, c, atlas=a),
               R.build_instanced_scene(pool, inst, bm, bl, bc, atlas=ba)):
        card = R.Renderer(sc, cfg, device="cuda")
        got = [card.pick(int(x), int(y)) for x, y in zip(xs, ys)]
        want = R.Renderer(sc, cfg, device="cpu").pick_many(xs, ys)
        assert [p is None for p in got] == [p is None for p in want]
        assert sum(p is not None for p in got) > 16
        for p, q in zip(got, want):
            if p is not None:
                assert (p["triangle"], p["material"], p.get("instance")) == (
                    q["triangle"], q["material"], q.get("instance")) or p["t"] == q["t"]
                np.testing.assert_allclose(p["t"], q["t"], rtol=1e-5)


def test_pick_beside_render_loop_on_card():
    """``pick`` from this thread while another thread renders on the same
    stream, as the viewer's ``/pick`` runs beside its render loop: every
    pick equals the same pick made alone, and the frames equal those
    rendered alone, bit for bit. The persistent kernels share one scratch a
    stream; each call holds its grid's lock from the scratch's reset
    through its launch, so neither finds the other's ray counter."""
    _need_cuda()
    import threading

    g, m, l, c, a = procedural.atrium_scene(**SMALL_ATRIUM)
    sc = R.build_scene(g, m, l, c, atlas=a)
    cfg = RenderConfig(width=96, height=54, max_depth=4)
    rng = np.random.default_rng(6)
    xs, ys = rng.integers(0, 96, 32), rng.integers(0, 54, 32)
    alone = R.Renderer(sc, cfg, device="cuda", fused_shade=True)
    want = [alone.pick(int(x), int(y)) for x, y in zip(xs, ys)]
    assert sum(p is not None for p in want) > 8
    n_frames = 8
    for _ in range(n_frames):
        alone.step()
    busy = R.Renderer(sc, cfg, device="cuda", fused_shade=True, packed=alone.packed)
    picker = R.Renderer(sc, cfg, device="cuda", packed=alone.packed)
    errors = []

    def render():
        try:
            for _ in range(n_frames):
                busy.step()
        except BaseException as e:  # reported below, in this thread
            errors.append(e)

    t = threading.Thread(target=render)
    t.start()
    rounds = 0
    while t.is_alive() or rounds == 0:
        for x, y, w in zip(xs, ys, want):
            got = picker.pick(int(x), int(y))
            assert (got is None) == (w is None), (x, y, got, w)
            if got is not None:
                assert (got["triangle"], got["material"], got["t"]) == (
                    w["triangle"], w["material"], w["t"]), (x, y, got, w)
                np.testing.assert_array_equal(got["position"], w["position"])
        rounds += 1
    t.join()
    assert not errors, errors
    torch.cuda.synchronize()
    assert torch.equal(busy.accum, alone.accum)
    assert busy.frame == alone.frame == n_frames


def test_cli_on_card(tmp_path):
    """The CLI on the card: quirks.glb (two levels) against ``--device cpu``
    (the render slice's tolerance), and 1 + 1 spp through ``--checkpoint``
    equal to 2 straight, bit for bit."""
    _need_cuda()
    import os

    from vk_raytrace_torch import cli

    quirks = os.path.join(os.path.dirname(__file__), "assets", "quirks.glb")
    base = ["-f", quirks, "--size", "64", "48", "--depth", "4", "--pbr", "gltf"]

    def run(name, *extra):
        out = str(tmp_path / f"{name}.npy")
        assert cli.main([*base, "-o", str(tmp_path / f"{name}.png"), "--hdr-out", out,
                         *extra]) == 0
        return np.load(out)

    card, cpu = run("card", "--spp", "2"), run("cpu", "--spp", "2", "--device", "cpu")
    assert np.isfinite(card).all() and card.mean() > 0.0
    assert np.isclose(card, cpu, rtol=1e-3, atol=1e-4).all(-1).mean() >= 0.99
    ck = str(tmp_path / "ck.npz")
    run("half", "--spp", "1", "--checkpoint", ck)
    assert np.array_equal(run("resumed", "--spp", "1", "--checkpoint", ck), card)


def _small_plaza(tmp_path, name, **kw):
    """A small plaza glTF (``chip_smoke.write_plaza``) loaded in two levels:
    (pool, inst, accel on the CPU, alpha pack on the CPU or None)."""
    import chip_smoke
    from vk_raytrace_torch.models.gltf import load_gltf

    path = str(tmp_path / f"{name}.gltf")
    chip_smoke.write_plaza(path, **{**dict(nx=15, nz=20, trunk_segments=6, trunk_rings=2,
                                           cards=4), **kw})
    (pool, inst), m, l, c, a = load_gltf(path, instancing="auto")
    sc = R.build_instanced_scene(pool, inst, m, l, c, atlas=a)
    pack = make_alpha_pack(sc.materials.to("cpu"), sc.atlas.to("cpu"),
                           torch.as_tensor(np.asarray(pool.geometry.tri_material)).long())
    return pool, inst, sc.instances.to("cpu"), pack


@pytest.mark.parametrize("which", ["opaque", "alpha"])
@pytest.mark.parametrize("kind", ["closest", "any"])
def test_global_table_machines_match_chunked_loop(tmp_path, which, kind):
    """The machines beyond 512 instances (the instance table read from global
    memory) on a 601-instance plaza against the chunked round loops on the
    CPU: tri, inst, steps (and seed) exact, t/u/v within rtol 1e-5 / atol
    1e-6; one launch each. (On the card against the loop on the card, bit
    for bit: ``chip_smoke.py`` phase 28.)"""
    _need_cuda()
    import chip_smoke

    pool, inst, acc, pack = _small_plaza(tmp_path, "plaza")
    assert acc.inst.aabb_min.shape[0] > tlas._DENSE_I_MAX
    rng = np.random.default_rng(28)
    n = 4099
    origins = rng.uniform([-25, 0.5, -32], [25, 12, 32], (n, 3))
    o, d = chip_smoke.rays_toward_instances(rng, pool, inst, rng.integers(0, len(inst.mesh_id), n),
                                            origins, "cpu")
    any_hit = kind == "any"
    t_max = (torch.tensor(rng.uniform(1.0, 40.0, n), dtype=torch.float32) if any_hit
             else torch.full((n,), tf.INF))
    act = torch.tensor(rng.random(n) < 0.95)
    seed = torch.tensor(rng.integers(0, 2**32, n), dtype=torch.int64)
    cacc, cpack = acc.to("cuda"), _pack_to(pack, "cuda")
    if which == "alpha":
        args = (o, d, t_max, seed, act)
        plain = tlas._alpha_rounds(acc, pack, *args, any_hit, not any_hit)
        key = tf.launch_key("alpha_machine", 16)
        before = tf.LAUNCHES[key]
        kern = tlas._two_level_alpha_pass(cacc, cpack, *(x.to("cuda") for x in args), any_hit,
                                          not any_hit)
        exact = (1, 4, 5, 6)
    else:
        planar, roots, view, mask = tlas._subset(acc, "opq")
        plain = tlas._two_level_pass(planar, roots, view, o, d, t_max, act, mask, not any_hit,
                                     any_hit)
        key = tf.launch_key("opaque_machine", 16)
        before = tf.LAUNCHES[key]
        kern = tlas._two_level_opaque_pass(cacc, "opq", o.to("cuda"), d.to("cuda"),
                                           t_max.to("cuda"), act.to("cuda"), not any_hit, any_hit)
        exact = (1, 4, 5)
    torch.cuda.synchronize()
    assert tf.LAUNCHES[key] == before + 1
    _cpu_and_cuda_outputs_equal(kern, plain, exact, f"{which} {kind}")
    assert 0.05 < (plain[1] >= 0).float().mean() < 1.0


@pytest.mark.parametrize("which", ["opaque", "alpha"])
def test_machine_occupancy_and_report(which):
    """The machines' occupancy entry, with the instance table in shared
    memory (166 instances, the bistro's) and in global memory (600): at least
    one block of 128 resides per SM, no more with the larger shared table;
    ptxas's report of every instantiation is kept beside the library."""
    _need_cuda()
    from vk_raytrace_torch import cuda_build

    alpha = which == "alpha"
    for width in tf.WIDTHS:
        for any_hit in (False, True):
            small, large = (tf.machine_occupancy(width, alpha, any_hit, n) for n in (166, 512))
            assert small >= large >= 1
            assert tf.machine_occupancy(width, alpha, any_hit, 600) >= 1
            for table in (0, 1):
                res = cuda_build.resources(
                    f"traverse{width}", f"{which}_machine_kernelILb{int(any_hit)}ELi{width}ELb"
                                        f"{table}E")
                assert res["registers"] > 0


@pytest.mark.parametrize("which", ["opaque", "alpha"])
@pytest.mark.parametrize("kind", ["closest", "any"])
def test_machines_spill_match_round_loop(which, kind):
    """The stack's spill on the card: the machines on
    ``chip_smoke.cloud_instances`` (BLAS stack bounds past the sixteen
    shared entries a thread, which its rays pass) against the round loops on
    the CPU: tri, inst, steps (and seed) exact, t/u/v within rtol 1e-5 /
    atol 1e-6; the deepest stack past the shared entries."""
    _need_cuda()
    import chip_smoke

    rng = np.random.default_rng(31)
    acc, pack = chip_smoke.cloud_instances(rng)
    n = 4099
    o = torch.tensor(rng.uniform([-1.0, 0.0, 0.0], [-0.2, 1.0, 1.0], (n, 3)), dtype=torch.float32)
    d = torch.tensor(rng.normal([1.0, 0.0, 0.0], 0.3, (n, 3)), dtype=torch.float32)
    d = (d / d.norm(dim=1, keepdim=True)).contiguous()
    any_hit = kind == "any"
    t_max = (torch.tensor(rng.uniform(1.0, 8.0, n), dtype=torch.float32) if any_hit
             else torch.full((n,), tf.INF))
    act = torch.tensor(rng.random(n) < 0.95)
    seed = torch.tensor(rng.integers(0, 2**32, n), dtype=torch.int64)
    cacc, cpack = acc.to("cuda"), _pack_to(pack, "cuda")
    cuda = [x.to("cuda") for x in (o, d, t_max, seed, act)]
    if which == "alpha":
        plain = tlas._alpha_rounds(acc, pack, o, d, t_max, seed, act, any_hit, not any_hit)
        kern = tlas._two_level_alpha_pass(cacc, cpack, *cuda, any_hit, not any_hit)
        exact, planar = (1, 4, 5, 6), acc.blas_planar_alp
    else:
        planar, roots, view, mask = tlas._subset(acc, "opq")
        plain = tlas._two_level_pass(planar, roots, view, o, d, t_max, act, mask, not any_hit,
                                     any_hit)
        kern = tlas._two_level_opaque_pass(cacc, "opq", cuda[0], cuda[1], cuda[2], cuda[4],
                                           not any_hit, any_hit)
        exact = (1, 4, 5)
    torch.cuda.synchronize()
    _cpu_and_cuda_outputs_equal(kern, plain, exact, f"cloud {which} {kind}")
    assert 16 < tf.stack_reached(16, "cuda") <= planar.stack_depth
    assert (plain[1] >= 0).any()


def test_instance_level_split_on_card(tmp_path):
    """An all-alpha instanced pool (the plaza's foliage alone, 300
    instances of one mesh): ``closest_hit_instanced`` / ``any_hit_instanced``
    on the card launch the alpha machine alone over the full tables, and
    equal the CPU's loops."""
    _need_cuda()
    import chip_smoke

    pool, inst, acc, pack = _small_plaza(tmp_path, "foliage", ground=False, trunks=False)
    assert acc.blas_planar_opq is None and bool(acc.inst_alpha.all())
    rng = np.random.default_rng(30)
    n = 4099
    o, d = chip_smoke.rays_toward_instances(rng, pool, inst, rng.integers(0, len(inst.mesh_id), n),
                                            rng.uniform([-25, 0.5, -32], [25, 12, 32], (n, 3)),
                                            "cpu")
    seed = torch.tensor(rng.integers(0, 2**32, n), dtype=torch.int64)
    t_max = torch.tensor(rng.uniform(1.0, 40.0, n), dtype=torch.float32)
    cacc, cpack = acc.to("cuda"), _pack_to(pack, "cuda")
    tf.reset_launches()
    hc, sc = tlas.closest_hit_instanced(cacc, cpack, o.cuda(), d.cuda(), seed=seed.cuda())
    occ_c, so = tlas.any_hit_instanced(cacc, cpack, o.cuda(), d.cuda(), t_max.cuda(),
                                       seed=seed.cuda())
    torch.cuda.synchronize()
    assert tf.LAUNCHES["opaque_machine"] == 0 and tf.LAUNCHES["alpha_machine"] == 2
    hp, sp = tlas.closest_hit_instanced(acc, pack, o, d, seed=seed)
    occ_p, sop = tlas.any_hit_instanced(acc, pack, o, d, t_max, seed=seed)
    _cpu_and_cuda_outputs_equal((hc.t, hc.tri, hc.u, hc.v, hc.inst, hc.steps, sc),
                                (hp.t, hp.tri, hp.u, hp.v, hp.inst, hp.steps, sp),
                                (1, 4, 5, 6), "closest")
    assert torch.equal(occ_c.cpu(), occ_p) and torch.equal(so.cpu(), sop)
    assert 0.05 < (hp.tri >= 0).float().mean() < 1.0


def test_sharded_nccl_world_one_matches_renderer():
    """``parallel/sharding.py`` on the card: NCCL at world size 1 in this
    process (tile 1 x sample 1) over 3 frames of the reduced atrium equals
    ``Renderer.step`` on the same tables bit for bit, rays included."""
    _need_cuda()
    import torch.distributed as dist

    from vk_raytrace_torch.parallel import sharding

    g, m, l, c, a = procedural.atrium_scene(**SMALL_ATRIUM)
    cfg = RenderConfig(width=96, height=54, max_depth=4, pbr_mode=PBR_GLTF, use_sun_sky=True)
    r = R.Renderer(R.build_scene(g, m, l, c, atlas=a), cfg, device="cuda")
    assert sharding.init_process_group(
        "cuda", 0, 1, f"tcp://127.0.0.1:{sharding.free_port()}", timeout_s=120) == "nccl"
    try:
        mesh = sharding.make_mesh("cuda")
        sharding.replicate(mesh, (r.scene, r.packed, r.alpha_pack, r._shade_tables))
        step = sharding.sharded_render_step(mesh, r.scene, r.packed, r._run_cfg,
                                            alpha_pack=r.alpha_pack, features=r.features)
        rows = sharding.shard_accum(mesh, torch.zeros(54, 96, 3, device="cuda"))
        rays = []
        for f in range(3):
            rows, n = step(rows, f)
            rays.append(n)
        img = sharding.gather_accum(mesh, rows).cpu().numpy()
    finally:
        dist.destroy_process_group()
    single = []
    for _ in range(3):
        r.step()
        single.append(r.last_rays)
    assert rays == single
    np.testing.assert_array_equal(img, r.accum.cpu().numpy())


def test_graft_entry_on_card():
    """``graft_entry.entry()`` on the card against the CPU under the render
    criterion; modes a/b launched."""
    _need_cuda()
    from vk_raytrace_torch import graft_entry

    fn, args = graft_entry.entry()
    tf.reset_launches()
    img = fn(*args).cpu().numpy()
    assert tf.LAUNCHES["closest"] > 0 and tf.LAUNCHES["any"] > 0
    cfn, cargs = graft_entry.entry("cpu")
    cpu = cfn(*cargs).numpy()
    assert np.isfinite(img).all() and img.mean() > 0.0
    assert np.isclose(img, cpu, rtol=1e-3, atol=1e-4).all(-1).mean() >= 0.99
