"""The two-level closest and any hits of the port against the reference's
``ops/tlas.py`` (Pallas in interpret mode, ``VKRT_FUSED=1``) on
``bistro_scene(detail=0.05)``, opaque and with the alpha test. Split by
subject from ``tests/test_torch_instancing.py``, whose helpers and
tolerances these tests use.
"""

import numpy as np
import pytest

from test_torch_instancing import (  # noqa: F401 (the autouse fixture)
    MASK_SHARE, N, _case, _check_closest, _fused_reference, _rays, _trace,
)
from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401 (fixtures)
from vk_raytrace_tpu.models import procedural as ref_proc

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def bistro():
    pool, inst, mats, _, _, atlas = ref_proc.bistro_scene(detail=0.05)
    return _case(pool, inst, mats, atlas)


@pytest.mark.parametrize("alpha", [False, True])
def test_bistro_closest_hit_matches_reference(bistro, alpha):
    o, d, s = _rays(1 + alpha, N, [-50, 0.5, -10], [50, 8, 10])
    rh, rs, ph, ps = _trace(bistro, o, d, s, alpha, any_hit=False)
    _check_closest(rh, ph)
    np.testing.assert_array_equal(ps, rs)


@pytest.mark.parametrize("alpha", [False, True])
def test_bistro_any_hit_matches_reference(bistro, alpha):
    o, d, s = _rays(3 + alpha, N, [-50, 0.5, -10], [50, 8, 10])
    t_max = np.random.default_rng(5).uniform(1.0, 25.0, N).astype(np.float32)
    rh, rs, ph, ps = _trace(bistro, o, d, s, alpha, any_hit=True, t_max=t_max)
    assert (np.asarray(rh) == ph.numpy()).mean() >= MASK_SHARE
    assert 0.1 < ph.numpy().mean() < 0.95
    np.testing.assert_array_equal(ps, rs)
