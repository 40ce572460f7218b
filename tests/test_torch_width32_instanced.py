"""Two-level scenes at width 32 against the reference's ``VKRT_WIDE=32``
builds: every planar and root table of ``build_instanced_accel(width=32)``,
the hits of a multi-mesh pool at both widths, and the small bistro's closest
hits through the opaque rounds and the alpha machine with the same seeds.
Tolerances of ``tests/test_torch_instancing.py``.
"""

import numpy as np
import pytest
import torch

from test_torch_instancing import _case, _check_closest, _port_pool, _sphere_box, _trace
from test_torch_instancing import _rays as _inst_rays
from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401 (fixtures)
from vk_raytrace_tpu.models import procedural as ref_proc
from vk_raytrace_tpu.ops import tlas as ref_tlas
from vk_raytrace_torch.convert import _conv
from vk_raytrace_torch.models.instances import InstanceTable
from vk_raytrace_torch.ops import tlas

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _ref_case32(pool, inst, mats, atlas):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VKRT_WIDE", "32")
        case = _case(pool, inst, mats, atlas)
    assert case.acc.blas_planar.width == 32
    return case


@pytest.mark.parametrize("name", ["sphere_box", "bistro"])
def test_instanced_w32_build_matches_reference(name):
    """``build_instanced_accel(width=32)``: every planar table and root
    table equals the reference's ``VKRT_WIDE=32`` build (leaf-ref fixup
    ``(width/2) * base``)."""
    if name == "bistro":
        pool, inst, *_ = ref_proc.bistro_scene(detail=0.05)
    else:
        pool, inst = _sphere_box()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VKRT_WIDE", "32")
        ref = ref_tlas.build_instanced_accel(pool, inst)
    acc = tlas.build_instanced_accel(_port_pool(pool), _conv(InstanceTable, inst), width=32)
    for f in ("blas_planar", "blas_planar_opq", "blas_planar_alp"):
        r, p = getattr(ref, f), getattr(acc, f)
        assert (r is None) == (p is None), f
        if p is not None:
            assert (p.width, p.stack_depth) == (32, r.stack_depth), f
            assert np.array_equal(p.rows, np.asarray(r.rows)), f
    for f in ("mesh_root_planar", "mesh_root_opq", "mesh_root_alp"):
        r, p = getattr(ref, f), getattr(acc, f)
        assert (r is None) == (p is None) and (p is None or np.array_equal(p, np.asarray(r))), f


def test_instanced_w32_hits_equal_w16():
    """The analog of the reference's width-32 instancing gate: a multi-mesh
    pool gives the same hits at both widths."""
    pool, inst = _sphere_box()
    pool, inst = _port_pool(pool), _conv(InstanceTable, inst)
    o, d, _ = _inst_rays(21, 1024, [-6, 2.5, -6], [6, 8, 6])
    target = np.random.default_rng(22).uniform([-4, 0, -3], [4, 1.5, 3], (1024, 3))
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hits = {}
    for w in (16, 32):
        acc = tlas.build_instanced_accel(pool, inst, width=w).to("cpu")
        assert acc.blas_planar.width == w
        hits[w], _ = tlas.closest_hit_instanced(acc, None, torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_array_equal(hits[16].tri.numpy(), hits[32].tri.numpy())
    np.testing.assert_array_equal(hits[16].inst.numpy(), hits[32].inst.numpy())
    np.testing.assert_allclose(hits[16].t.numpy(), hits[32].t.numpy(), rtol=1e-6)
    assert (hits[32].tri.numpy() >= 0).mean() > 0.3


@pytest.mark.parametrize("alpha", [False, True])
def test_bistro_w32_hits_match_reference(alpha):
    """The small bistro at width 32, closest hit through the opaque rounds
    and the alpha machine, against the reference's ``VKRT_WIDE=32`` path
    with the same seeds."""
    pool, inst, mats, _, _, atlas = ref_proc.bistro_scene(detail=0.05)
    case = _ref_case32(pool, inst, mats, atlas)
    o, d, s = _inst_rays(31 + alpha, 320, [-50, 0.5, -10], [50, 8, 10])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VKRT_FUSED", "1")
        rh, rs, ph, ps = _trace(case, o, d, s, alpha, any_hit=False)
    _check_closest(rh, ph)
    np.testing.assert_array_equal(ps, rs)
