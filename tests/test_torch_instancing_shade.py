"""Shading in a two-level scene: the port's instanced shade state and fused
shading stage (its plain version) against the reference's on the small
bistro, inputs made with numpy from a seed, under the tolerances of
``tests/test_torch_shade_fused.py``; the instanced prologue's layout. Split
by subject from ``tests/test_torch_instancing.py``.
"""

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_instancing import _fused_reference  # noqa: F401 (autouse)
from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401 (fixtures)
from vk_raytrace_tpu import render as ref_render
from vk_raytrace_tpu.integrator import shade as ref_shade
from vk_raytrace_tpu.integrator import shade_fused as ref_fused
from vk_raytrace_tpu.models import procedural as ref_proc
from vk_raytrace_tpu.models.schema import PBR_GLTF, RenderConfig as RefConfig
from vk_raytrace_torch.convert import from_reference
from vk_raytrace_torch.integrator import shade as port_shade
from vk_raytrace_torch.integrator import shade_fused as port_fused
from vk_raytrace_torch.ops.traverse_fused import Hit

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHADE_RTOL, SHADE_ATOL, SHADE_MASKS = 1e-4, 1e-5, 0.999
M = 2048


@pytest.fixture(scope="module")
def bistro_scene():
    """The small bistro's instanced SceneData with the reference's sky bake,
    and the port's copy of it."""
    pool, inst, mats, lights, cam, atlas = ref_proc.bistro_scene(detail=0.05)
    scene = ref_render.build_instanced_scene(pool, inst, mats, lights, cam, atlas=atlas)
    scene, _ = ref_render.prepare_sun_sky(scene, RefConfig(width=64, height=36, pbr_mode=PBR_GLTF,
                                                           use_sun_sky=True))
    port, _ = from_reference(scene)
    return scene, port.instances.to("cpu"), dataclasses.replace(port, instances=None).to("cpu")


def _shade_inputs(scene, seed):
    rng = np.random.default_rng(seed)
    tri = rng.integers(0, len(np.asarray(scene.geometry.indices)), M).astype(np.int32)
    tri[rng.random(M) < 0.1] = -1
    inst = rng.integers(0, len(np.asarray(scene.instances.inst.mesh_id)), M).astype(np.int32)
    w = rng.dirichlet(np.ones(3), M).astype(np.float32)
    d = rng.standard_normal((M, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    f32 = lambda *s, lo=0.0, hi=1.0: rng.uniform(lo, hi, s).astype(np.float32)  # noqa: E731
    return dict(
        tri=tri, inst=inst, u=w[:, 1], v=w[:, 2],
        t=np.where(tri >= 0, f32(M, lo=0.1, hi=20.0), 1e32).astype(np.float32),
        origin=f32(M, 3, lo=-5.0, hi=5.0), direction=d,
        seed=rng.integers(0, 2**32, M, dtype=np.uint64).astype(np.uint32),
        active=rng.random(M) < 0.9, radiance=f32(M, 3), throughput=f32(M, 3, lo=0.05),
        absorption=f32(M, 3, hi=0.2),
        bsdf_pdf=np.where(rng.random(M) < 0.3, 0.0, f32(M, lo=0.1, hi=4.0)).astype(np.float32),
        tdist=f32(M, lo=0.5, hi=30.0),
    )


@pytest.mark.parametrize(
    "key", ["position", "normal", "geom_normal", "tangent", "bitangent", "uv", "uv_density"]
)
def test_shade_state_instanced_matches_reference(bistro_scene, key):
    scene, acc, port = bistro_scene
    x = _shade_inputs(scene, 11)
    ref = ref_shade.get_shade_state(
        scene.geometry, jnp.asarray(x["tri"]), jnp.asarray(x["u"]), jnp.asarray(x["v"]),
        instances=jax.tree.map(jnp.asarray, scene.instances.inst), inst=jnp.asarray(x["inst"]),
        shade_rows=jnp.asarray(scene.shade_rows),
    )
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    out = port_shade.get_shade_state(port.shade_rows, t(x["tri"]).long(), t(x["u"]), t(x["v"]),
                                     acc.inst, t(x["inst"]).long())
    np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=SHADE_RTOL,
                               atol=SHADE_ATOL)


class _RefHit(NamedTuple):
    t: object
    tri: object
    u: object
    v: object
    inst: object


@pytest.mark.parametrize("full_mis,mip", [(False, True), (True, False)])
def test_shade_bounce_instanced_matches_reference(bistro_scene, full_mis, mip):
    scene, acc, port = bistro_scene
    x = _shade_inputs(scene, 12 + full_mis)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    feats = ref_shade.mat_features(scene.materials)
    ref = ref_fused.shade_bounce_fused(
        jax.tree.map(jnp.asarray, scene._replace(instances=None)), feats, full_mis, 0.5,
        jnp.float32(1.0), _RefHit(j["t"], j["tri"], j["u"], j["v"], j["inst"]), j["origin"],
        j["direction"], j["seed"], j["active"], j["radiance"], j["throughput"], j["absorption"],
        j["bsdf_pdf"], instances=jax.tree.map(jnp.asarray, scene.instances.inst), sun_disk=True,
        mip=(0.002, j["tdist"]) if mip else None,
    )
    t = {k: torch.from_numpy(np.array(v)) for k, v in x.items()}
    hit = Hit(t["t"], t["tri"].long(), t["u"], t["v"], torch.zeros(M, dtype=torch.int32),
              t["inst"].long())
    before = dict(port_fused.LAUNCHES)
    out = port_fused.shade_bounce_fused(
        port, port_shade.mat_features(port.materials), full_mis, 0.5, 1.0, hit, t["origin"],
        t["direction"], t["seed"].long() & 0xFFFFFFFF, t["active"], t["radiance"],
        t["throughput"], t["absorption"], t["bsdf_pdf"], instances=acc.inst, sun_disk=True,
        mip=(0.002, t["tdist"]) if mip else None,
    )
    assert port_fused.LAUNCHES == before  # the plain body is no launch
    np.testing.assert_array_equal(out["seed"].numpy().astype(np.uint32), np.asarray(ref["seed"]))
    agree = np.ones(M, bool)
    for k in ("alive", "visible"):
        same = out[k].numpy() == np.asarray(ref[k])
        assert same.mean() >= SHADE_MASKS, (k, same.mean())
        agree &= same
    for k in ("new_origin", "new_dir", "radiance", "throughput", "absorption", "nee",
              "light_dir", "light_dist", "rr_pcont", "pdf_b"):
        np.testing.assert_allclose(out[k].numpy().reshape(M, -1)[agree],
                                   np.asarray(ref[k]).reshape(M, -1)[agree],
                                   rtol=SHADE_RTOL, atol=SHADE_ATOL, err_msg=k)
    assert np.asarray(ref["alive"]).mean() > 0.3


def test_shade_inputs_instanced_layout(bistro_scene):
    """The instanced prologue: 72 aux lanes, the instance rows last."""
    scene, acc, port = bistro_scene
    x = _shade_inputs(scene, 13)
    t = {k: torch.from_numpy(np.array(v)) for k, v in x.items()}
    hit = Hit(t["t"], t["tri"].long(), t["u"], t["v"], torch.zeros(M, dtype=torch.int32),
              t["inst"].long())
    ins = port_fused.shade_inputs(
        port, port_shade.mat_features(port.materials), False, 0.5, 1.0, hit, t["origin"],
        t["direction"], t["seed"].long(), None, t["radiance"], t["throughput"], t["absorption"],
        t["bsdf_pdf"], instances=acc.inst, sun_disk=True,
    )
    assert ins.flags.instanced and ins.flags.bits() & 64
    assert ins.aux.shape == (M, port_fused.aux_width(True)) == (M, 72)
    o2w = acc.inst.object_to_world[t["inst"].long()].reshape(M, 12)
    w2o = acc.inst.world_to_object[t["inst"].long()].reshape(M, 12)
    assert torch.equal(ins.aux[:, 48:60], o2w) and torch.equal(ins.aux[:, 60:72], w2o)
