"""Carry the reference package's scene state into the port's containers.

``from_reference(scene, packed)`` takes the reference's ``SceneData`` and
``AccelBundle`` or ``InstancedAccel`` (arrays that ``numpy.asarray``
accepts) and returns the port's ``SceneData`` and ``AccelBundle`` or
``InstancedAccel`` holding the same bytes, so both packages can trace
identical tables. Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .models import schema as S
from .models.instances import InstanceTable
from .ops.bvh8 import WideScene
from .ops.tlas import InstancedAccel
from .ops.traverse_fused import PlanarScene
from .ops.traverse_wide import AccelBundle


def _conv(cls, src):
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(src, f.name, None)
        kw[f.name] = None if v is None else np.asarray(v)
    return cls(**kw)


def _planar(p):
    if p is None:
        return None
    return PlanarScene(rows=np.asarray(p.rows), stack_depth=int(p.stack_depth), width=int(p.width))


def _wide(w):
    if w is None:
        return None
    return WideScene(rows=np.asarray(w.rows), stack_depth=int(w.stack_depth))


def _instanced(acc):
    """The reference's InstancedAccel -> the port's: the planar tables,
    roots, masks, subset boxes and instance table, and the 8-wide table
    and its mesh roots (the wide back end's)."""
    arr = lambda x: None if x is None else np.asarray(x)  # noqa: E731
    out = InstancedAccel(
        blas_planar=_planar(acc.blas_planar),
        mesh_root_planar=arr(acc.mesh_root_planar),
        inst=_conv(InstanceTable, acc.inst),
        inst_alpha=arr(acc.inst_alpha),
        blas_planar_opq=_planar(acc.blas_planar_opq),
        mesh_root_opq=arr(acc.mesh_root_opq),
        blas_planar_alp=_planar(acc.blas_planar_alp),
        mesh_root_alp=arr(acc.mesh_root_alp),
        inst_opaque=arr(acc.inst_opaque),
        inst_aabb_opq_min=arr(acc.inst_aabb_opq_min),
        inst_aabb_opq_max=arr(acc.inst_aabb_opq_max),
        inst_aabb_alp_min=arr(acc.inst_aabb_alp_min),
        inst_aabb_alp_max=arr(acc.inst_aabb_alp_max),
        blas=_wide(acc.blas),
        mesh_root=arr(acc.mesh_root),
    )
    out.check_root_masks()
    return out


def _accel(packed):
    if packed is None:
        return None
    if hasattr(packed, "inst"):
        return _instanced(packed)
    return AccelBundle(_planar(packed.opaque_planar), _planar(packed.alpha_planar),
                       _wide(packed.opaque), _wide(packed.alpha))


def from_reference(scene, packed=None):
    """Reference (SceneData, AccelBundle or InstancedAccel) -> port
    (SceneData, AccelBundle or InstancedAccel, or None), with the planar
    tables of the fused back end and the 8-wide ones of the wide back end;
    a two-level scene's own ``instances`` come across too."""
    env = scene.env
    port_env = S.Environment(
        image=np.asarray(env.image),
        accel=_conv(S.EnvAccel, env.accel),
        integral=np.asarray(env.integral),
        average=np.asarray(env.average),
        rows=None if env.rows is None else np.asarray(env.rows),
    )
    atlas = _conv(S.TextureAtlas, scene.atlas)
    out = S.SceneData(
        geometry=_conv(S.Geometry, scene.geometry),
        materials=_conv(S.Materials, scene.materials),
        lights=_conv(S.Lights, scene.lights),
        n_lights=int(np.asarray(scene.n_lights)),
        atlas=atlas,
        env=port_env,
        camera=_conv(S.Camera, scene.camera),
        sun_sky=_conv(S.SunSky, scene.sun_sky),
        shade_rows=None if scene.shade_rows is None else np.asarray(scene.shade_rows),
        tap_rows=None if scene.tap_rows is None else np.asarray(scene.tap_rows),
        instances=_accel(getattr(scene, "instances", None)),
    )
    if port_env.rows is None:
        from .render import with_env_rows

        out = dataclasses.replace(out, env=with_env_rows(port_env))
    return out, _accel(packed)
