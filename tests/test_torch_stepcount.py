"""``vk_raytrace_torch/utils/stepcount.py`` against the reference's
``vk_raytrace_tpu/utils/stepcount.py`` on identical planar rows (the
reference's tables carried over by ``convert.from_reference``, which are
also the rows the port's own builder makes): the closest-hit and any-hit
row counts and hit t, equal; the secondary rays, equal; the camera rays of
``primary_rays`` through the port's camera, within 1e-6 of the
reference's."""

import numpy as np
import pytest

from test_torch_traverse import atrium, isolated_reference, one_torch_thread  # noqa: F401
from vk_raytrace_tpu.utils import stepcount as ref_sc
from vk_raytrace_torch.convert import from_reference
from vk_raytrace_torch.ops.bvh8 import build_accel_bundle
from vk_raytrace_torch.utils import stepcount as sc

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_primary_rays_match_reference(atrium):
    scene, _, port_scene, _ = atrium
    o_ref, d_ref = ref_sc.primary_rays(scene, 160, 90, 16, 9)
    o, d = sc.primary_rays(port_scene, 160, 90, 16, 9)
    assert o.shape == d.shape == (144, 3) and o.dtype == d.dtype == np.float32
    np.testing.assert_allclose(o, o_ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(d, d_ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("table", ("opaque", "alpha"))
def test_counts_match_reference(atrium, table):
    scene, packed, port_scene, bundle = atrium
    ref_rows = np.asarray(getattr(packed, f"{table}_planar").rows)
    planar = getattr(bundle, f"{table}_planar")
    rows = planar.rows.numpy()
    width = planar.width
    # The port's own build of the same geometry makes the same rows.
    own = getattr(build_accel_bundle(from_reference(scene)[0].geometry), f"{table}_planar")
    assert np.array_equal(own.rows, ref_rows)
    o, d = ref_sc.primary_rays(scene, 160, 90, 8, 6)
    rng = np.random.default_rng(3)
    o = np.concatenate([o, o + rng.normal(0, 0.2, o.shape).astype(np.float32)])
    d = np.concatenate([d, -d[::-1]])
    c_ref, t_ref = ref_sc.count_rows(ref_rows, width, o, d, return_t=True)
    c, t = sc.count_rows(rows, width, o, d, return_t=True)
    assert np.array_equal(c, c_ref) and np.array_equal(t, t_ref)
    assert c.min() >= 1 and (t < 3.0e37).any()
    assert np.array_equal(sc.count_rows(rows, width, o, d), c_ref)
    a_ref, occ_ref = ref_sc.count_rows_anyhit(ref_rows, width, o, d)
    a, occ = sc.count_rows_anyhit(rows, width, o, d)
    assert np.array_equal(a, a_ref) and np.array_equal(occ, occ_ref)
    p_ref, n_ref = ref_sc.secondary_rays(ref_rows, width, o, d)
    p, n = sc.secondary_rays(rows, width, o, d)
    assert len(p) > 0 and np.array_equal(p, p_ref) and np.array_equal(n, n_ref)
    s_ref, _ = ref_sc.count_rows(ref_rows, width, p_ref, n_ref, return_t=True)
    assert np.array_equal(sc.count_rows(rows, width, p, n), s_ref)

