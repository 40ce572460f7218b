"""Frozen scene generators of the benchmark's configurations.

A configuration file (``rtbench/configs/<name>.json``) names its generator
as ``<module>.<function>`` of this package, and its arguments, under
``scene``; :func:`generate` runs it, so a new scene is a new module here and
edits none. Numpy only: the reference (``rtbench/reference``) and the
harness read the same tables.
"""

from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass
class Scene:
    """One generated scene: a world-space ``geometry`` (single level), or a
    mesh ``pool`` and its ``instances`` (two levels, ``geometry`` then the
    pool's object-space geometry)."""

    geometry: object
    materials: object
    lights: object
    camera: object
    atlas: object
    pool: object = None
    instances: object = None

    @property
    def instanced(self) -> bool:
        return self.instances is not None


def generate(spec: dict) -> Scene:
    """The scene of a configuration's ``scene`` entry: ``{"generator":
    "<module>.<function>", "args": {...}}``."""
    module, function = spec["generator"].rsplit(".", 1)
    make = getattr(importlib.import_module(f"{__name__}.{module}"), function)
    out = make(**spec.get("args", {}))
    if len(out) == 6:
        pool, inst, mats, lights, cam, atlas = out
        return Scene(pool.geometry, mats, lights, cam, atlas, pool=pool, instances=inst)
    geom, mats, lights, cam, atlas = out
    return Scene(geom, mats, lights, cam, atlas)
