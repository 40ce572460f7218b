"""Carry the reference package's scene state into the port's containers.

``from_reference(scene, packed)`` takes the reference's ``SceneData`` and
``AccelBundle`` (arrays that ``numpy.asarray`` accepts) and returns the
port's ``SceneData`` and ``AccelBundle`` holding the same bytes, so both
packages can trace identical tables. Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .models import schema as S
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


def from_reference(scene, packed=None):
    """Reference (SceneData, AccelBundle) -> port (SceneData, AccelBundle or
    None). The port's accel bundle keeps only the planar trees."""
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
    )
    if port_env.rows is None:
        from .render import with_env_rows

        out = dataclasses.replace(out, env=with_env_rows(port_env))
    bundle = None
    if packed is not None:
        bundle = AccelBundle(_planar(packed.opaque_planar), _planar(packed.alpha_planar))
    return out, bundle
