"""The port's jax-free scene pipeline against the reference's.

Host tables (geometry, materials, atlas with mips, shade rows, tap rows,
planar BVH rows) are built by numpy and the same native host source
(``native.cpp``, bound by each package on its own) in both packages, so they must be byte-identical. The sun&sky bake runs float32
transcendentals in two frameworks: rtol 1e-5, loosened only in the sun's
glow ring (see ``_close_with_glow``). The alias table is compared through
the texel distribution it samples (see the test's docstring).
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_traverse import isolated_reference  # noqa: F401 (autouse)
from vk_raytrace_tpu import render as ref_render
from vk_raytrace_tpu.models import procedural as ref_proc
from vk_raytrace_tpu.ops import bvh8 as ref_bvh8
from vk_raytrace_torch import render as port_render
from vk_raytrace_torch.convert import from_reference
from vk_raytrace_torch.models import procedural as port_proc
from vk_raytrace_torch.models import schema as S
from vk_raytrace_torch.ops import bvh8 as port_bvh8

SMALL_ATRIUM = dict(bays_x=2, bays_z=2, column_segments=16, column_rows=12)


@pytest.fixture(scope="module")
def atrium_pair():
    ref = ref_proc.atrium_scene(**SMALL_ATRIUM)
    port = port_proc.atrium_scene(**SMALL_ATRIUM)
    return ref, port


def _fields_equal(ref_obj, port_obj):
    for f in dataclasses.fields(port_obj):
        r = getattr(ref_obj, f.name)
        p = getattr(port_obj, f.name)
        if r is None or p is None:
            assert r is None and p is None, f.name
            continue
        np.testing.assert_array_equal(np.asarray(p), np.asarray(r), err_msg=f.name)


@pytest.mark.parametrize("part", ["geometry", "materials", "lights", "camera", "atlas"])
def test_atrium_host_tables_identical(atrium_pair, part):
    ref, port = atrium_pair
    i = ["geometry", "materials", "lights", "camera", "atlas"].index(part)
    _fields_equal(ref[i], port[i])


def test_cornell_identical():
    ref = ref_proc.cornell_box()
    port = port_proc.cornell_box()
    for r, p in zip(ref, port):
        _fields_equal(r, p)


def test_shade_and_tap_rows_identical(atrium_pair):
    (g, m, l, c, a), (pg, pm, pl, pc, pa) = atrium_pair
    ref_scene = ref_render.build_scene(g, m, l, c, atlas=a)
    port_scene = port_render.build_scene(pg, pm, pl, pc, atlas=pa)
    np.testing.assert_array_equal(port_scene.shade_rows, np.asarray(ref_scene.shade_rows))
    np.testing.assert_array_equal(port_scene.tap_rows, np.asarray(ref_scene.tap_rows))
    assert port_scene.n_lights == int(ref_scene.n_lights)


@pytest.mark.parametrize("banners", [False, True])
def test_planar_rows_identical(banners):
    kw = dict(SMALL_ATRIUM, with_banners=banners)
    g = ref_proc.atrium_scene(**kw)[0]
    pg = port_proc.atrium_scene(**kw)[0]
    ref_b = ref_bvh8.build_accel_bundle(g)
    port_b = port_bvh8.build_accel_bundle(pg)
    np.testing.assert_array_equal(port_b.opaque_planar.rows, np.asarray(ref_b.opaque_planar.rows))
    assert port_b.opaque_planar.stack_depth == ref_b.opaque_planar.stack_depth
    if banners:
        np.testing.assert_array_equal(port_b.alpha_planar.rows, np.asarray(ref_b.alpha_planar.rows))
        assert port_b.alpha_planar.stack_depth == ref_b.alpha_planar.stack_depth
    else:
        assert port_b.alpha_planar is None and ref_b.alpha_planar is None


def _alias_distribution(q, alias):
    """Probability with which an alias table picks each texel."""
    q = np.asarray(q, np.float64)
    alias = np.asarray(alias, np.int64)
    p = q.copy()
    np.add.at(p, alias, 1.0 - q)
    return p / len(q)


@pytest.fixture(scope="module")
def sky_pair():
    from vk_raytrace_tpu.models.schema import default_sun_sky
    from vk_raytrace_tpu.models.hdr import build_environment as ref_build_env
    from vk_raytrace_tpu.ops.sunsky import bake_environment as ref_bake
    from vk_raytrace_torch.models.hdr import build_environment
    from vk_raytrace_torch.ops.sunsky import bake_environment

    ss = default_sun_sky()
    ref_env = ref_build_env(ref_bake(ss, disk=False))
    port_ss = S.default_sun_sky().to("cpu")
    port_env = build_environment(bake_environment(port_ss, disk=False))
    return ref_env, port_env


def _close_with_glow(actual, desired):
    """rtol 1e-5 on at least 99.9% of texels, rtol 1e-4 on all of them.

    The looser bound covers the sun's glow ring only: the glow is a power
    of the sun angle, an arccos of a dot product near 1, which magnifies a
    one-ulp difference in the dot ~1/sin(angle) times. The reference's
    values there are themselves within ~2e-4 of a float64 evaluation (XLA
    on the CPU contracts multiply-adds into FMAs; torch rounds each op).
    """
    actual, desired = np.asarray(actual), np.asarray(desired)
    rel = np.abs(actual - desired) / np.maximum(np.abs(desired), 1e-12)
    assert (rel <= 1e-5).mean() >= 0.999, (rel > 1e-5).mean()
    np.testing.assert_allclose(actual, desired, rtol=1e-4, atol=1e-12)


def test_sky_bake_allclose(sky_pair):
    ref_env, port_env = sky_pair
    _close_with_glow(port_env.image.numpy(), ref_env.image)
    np.testing.assert_allclose(float(port_env.integral), float(ref_env.integral), rtol=1e-5)
    # A float32 mean of 524,288 texels: the two frameworks sum in another
    # order, which moves the mean by ~1e-5 relative.
    np.testing.assert_allclose(float(port_env.average), float(ref_env.average), rtol=1e-4)
    _close_with_glow(port_env.accel.pdf.numpy(), ref_env.accel.pdf)


def _target(env):
    """Texel selection probability the alias table should realise."""
    pdf = np.asarray(env.accel.pdf, np.float64)
    h, w = env.image.shape[:2]
    ys = np.arange(h)
    area = (np.cos(ys * np.pi / h) - np.cos((ys + 1) * np.pi / h)) * (2 * np.pi / w)
    t = (pdf.reshape(h, w) * area[:, None]).ravel()
    return t / t.sum()


def test_alias_table_samples_same_distribution(sky_pair):
    """The cascade is chaotic under ulp changes of its prefix sums (a
    texel's deficit can land on a neighbouring alias), so the two tables
    are held to what they sample, in total variation: the port's is as
    close to its target as the reference's is to its own, and the two
    sampled distributions are as close as either is to its target."""
    ref_env, port_env = sky_pair
    p_ref = _alias_distribution(ref_env.accel.q, ref_env.accel.alias)
    p_port = _alias_distribution(port_env.accel.q.numpy(), port_env.accel.alias.numpy())
    tv = lambda a, b: 0.5 * np.abs(a - b).sum()
    tv_ref = tv(p_ref, _target(ref_env))
    assert tv_ref < 5e-3
    assert tv(p_port, _target(port_env)) <= tv_ref * 1.05
    assert tv(p_port, p_ref) <= 2.0 * tv_ref
    q = port_env.accel.q.numpy()
    assert np.isfinite(q).all() and q.min() >= 0.0


def test_packed_env_rows_allclose(sky_pair):
    ref_env, port_env = sky_pair
    rr, pr = np.asarray(ref_env.rows), port_env.rows.numpy()
    _close_with_glow(pr[:, :12], rr[:, :12])
    _close_with_glow(pr[:, 14], rr[:, 14])


def test_from_reference_round_trip(atrium_pair):
    g, m, l, c, a = atrium_pair[0]
    scene = ref_render.build_scene(g, m, l, c, atlas=a)
    packed = ref_bvh8.build_accel_bundle(g)
    port_scene, bundle = from_reference(scene, packed)
    _fields_equal(scene.geometry, port_scene.geometry)
    _fields_equal(scene.materials, port_scene.materials)
    _fields_equal(scene.atlas, port_scene.atlas)
    np.testing.assert_array_equal(port_scene.shade_rows, np.asarray(scene.shade_rows))
    np.testing.assert_array_equal(bundle.opaque_planar.rows, np.asarray(packed.opaque_planar.rows))
    assert bundle.opaque_planar.stack_depth == packed.opaque_planar.stack_depth
    # On to a device and back: the same values, in the port's dtypes.
    dev = port_scene.to("cpu")
    assert dev.geometry.positions.dtype == torch.float32
    assert dev.geometry.indices.dtype == torch.int64
    np.testing.assert_array_equal(dev.geometry.positions.numpy(), np.asarray(g.positions))
    np.testing.assert_array_equal(
        dev.tap_rows.numpy().view(np.uint32), np.asarray(scene.tap_rows)
    )
