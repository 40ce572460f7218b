"""The scene tables' types and constructors, frozen for the benchmark.

A copy of what the frozen generators need of ``vk_raytrace_torch/models/
schema.py`` (numpy only): the dataclasses keep the port's field names, so
the harness hands the port the same arrays by name
(``rtbench/scenes/__init__.py::to_port``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

ALPHA_OPAQUE = 0


ALPHA_MASK = 1


ALPHA_BLEND = 2


LIGHT_DIRECTIONAL = 0


LIGHT_POINT = 1


LIGHT_SPOT = 2


@dataclasses.dataclass
class Geometry:
    """World-space triangle pool (flattened instances)."""

    positions: object          # (V, 3) f32
    normals: object            # (V,)   u32 oct-compressed
    tangents: object           # (V,)   u32 oct-compressed
    tangent_handedness: object # (V,)   f32
    uv: object                 # (V, 2) f32
    color: object              # (V,)   u32 packed RGBA8
    indices: object            # (T, 3) i32
    tri_material: object       # (T,)   i32
    tri_flags: object          # (T,)   i32: bit0 double-sided, bit1 alpha


@dataclasses.dataclass
class Materials:
    """SoA material table, one row per ``GltfShadeMaterial``."""

    base_color_factor: object
    base_color_texture: object
    metallic_factor: object
    roughness_factor: object
    metallic_roughness_texture: object
    emissive_factor: object
    emissive_texture: object
    alpha_mode: object
    alpha_cutoff: object
    double_sided: object
    normal_texture: object
    normal_texture_scale: object
    uv_transform: object
    unlit: object
    transmission_factor: object
    transmission_texture: object
    ior: object
    anisotropy_direction: object
    anisotropy: object
    attenuation_color: object
    thickness_factor: object
    thickness_texture: object
    attenuation_distance: object
    clearcoat_factor: object
    clearcoat_roughness: object
    clearcoat_texture: object
    clearcoat_roughness_texture: object
    sheen_color: object
    sheen_roughness: object


@dataclasses.dataclass
class Lights:
    """KHR_lights_punctual table."""

    direction: object
    range: object
    color: object
    intensity: object
    position: object
    inner_cone_cos: object
    outer_cone_cos: object
    type: object


@dataclasses.dataclass
class TextureAtlas:
    """All scene textures in one (H, W, 4) u8 array plus placement tables.
    Mip level l >= 1 of texture t lives at (mip_x[t] + w - (w >> (l-1)),
    mip_y[t]); -1 = no chain, None = no chains at all."""

    data: object
    x: object
    y: object
    width: object
    height: object
    wrap_s: object
    wrap_t: object
    mip_x: Optional[object] = None
    mip_y: Optional[object] = None


@dataclasses.dataclass
class Camera:
    view_inverse: object  # (4, 4)
    proj_inverse: object  # (4, 4)
    focal_dist: object    # ()
    aperture: object      # ()


@dataclasses.dataclass
class SunSky:
    """``SunAndSky`` parameters; every field a 0-d or (3,) array."""

    rgb_unit_conversion: object
    multiplier: object
    haze: object
    redblueshift: object
    saturation: object
    horizon_height: object
    ground_color: object
    horizon_blur: object
    night_color: object
    sun_disk_intensity: object
    sun_direction: object
    sun_disk_scale: object
    sun_glow_intensity: object
    y_is_up: object
    physically_scaled_sun: object
    in_use: object


def default_sun_sky(in_use: bool = False) -> SunSky:
    """Defaults from ``sample_example.hpp:175-192``."""
    f = lambda v: np.asarray(v, np.float32)
    i = lambda v: np.asarray(v, np.int32)
    return SunSky(
        rgb_unit_conversion=f([1.0, 1.0, 1.0]),
        multiplier=f(0.0000101320),
        haze=f(0.0),
        redblueshift=f(0.0),
        saturation=f(1.0),
        horizon_height=f(0.0),
        ground_color=f([0.4, 0.4, 0.4]),
        horizon_blur=f(0.1),
        night_color=f([0.0, 0.0, 0.01]),
        sun_disk_intensity=f(0.8),
        sun_direction=f([0.0, 0.78, 0.62]),
        sun_disk_scale=f(5.0),
        sun_glow_intensity=f(1.0),
        y_is_up=i(1),
        physically_scaled_sun=i(1),
        in_use=i(1 if in_use else 0),
    )


def _np(x, dtype):
    return np.asarray(np.asarray(x), dtype=dtype)


def make_materials(rows: list[dict]) -> Materials:
    """SoA material table from per-material dicts (glTF defaults)."""
    m = len(rows)

    def col(key, default, dtype, shape=()):
        is_f = dtype == np.float32
        out = np.empty((m,) + shape, dtype=np.float64 if is_f else np.int64)
        for i, r in enumerate(rows):
            out[i] = np.asarray(r.get(key, default))
        return _np(out, dtype)

    f32, i32 = np.float32, np.int32
    return Materials(
        base_color_factor=col("base_color_factor", [1, 1, 1, 1], f32, (4,)),
        base_color_texture=col("base_color_texture", -1, i32),
        metallic_factor=col("metallic_factor", 1.0, f32),
        roughness_factor=col("roughness_factor", 1.0, f32),
        metallic_roughness_texture=col("metallic_roughness_texture", -1, i32),
        emissive_factor=col("emissive_factor", [0, 0, 0], f32, (3,)),
        emissive_texture=col("emissive_texture", -1, i32),
        alpha_mode=col("alpha_mode", ALPHA_OPAQUE, i32),
        alpha_cutoff=col("alpha_cutoff", 0.5, f32),
        double_sided=col("double_sided", 0, i32),
        normal_texture=col("normal_texture", -1, i32),
        normal_texture_scale=col("normal_texture_scale", 1.0, f32),
        uv_transform=col("uv_transform", np.eye(3), f32, (3, 3)),
        unlit=col("unlit", 0, i32),
        transmission_factor=col("transmission_factor", 0.0, f32),
        transmission_texture=col("transmission_texture", -1, i32),
        ior=col("ior", 1.5, f32),
        anisotropy_direction=col("anisotropy_direction", [1, 0, 0], f32, (3,)),
        anisotropy=col("anisotropy", 0.0, f32),
        attenuation_color=col("attenuation_color", [1, 1, 1], f32, (3,)),
        thickness_factor=col("thickness_factor", 0.0, f32),
        thickness_texture=col("thickness_texture", -1, i32),
        attenuation_distance=col("attenuation_distance", 1e10, f32),
        clearcoat_factor=col("clearcoat_factor", 0.0, f32),
        clearcoat_roughness=col("clearcoat_roughness", 0.0, f32),
        clearcoat_texture=col("clearcoat_texture", -1, i32),
        clearcoat_roughness_texture=col("clearcoat_roughness_texture", -1, i32),
        sheen_color=col("sheen_color", [0, 0, 0], f32, (3,)),
        sheen_roughness=col("sheen_roughness", 0.0, f32),
    )


def make_lights(rows: list[dict]) -> Lights:
    """Punctual-light table; an empty list gets one zero-intensity row."""
    if not rows:
        rows = [dict(type=LIGHT_POINT, position=[0, 0, 0], intensity=0.0)]
    n = len(rows)

    def col(key, default, dtype, shape=()):
        out = np.empty((n,) + shape)
        for i, r in enumerate(rows):
            out[i] = np.asarray(r.get(key, default))
        return _np(out, dtype)

    f32, i32 = np.float32, np.int32
    return Lights(
        direction=col("direction", [0, 0, -1], f32, (3,)),
        range=col("range", 0.0, f32),
        color=col("color", [1, 1, 1], f32, (3,)),
        intensity=col("intensity", 1.0, f32),
        position=col("position", [0, 0, 0], f32, (3,)),
        inner_cone_cos=col("inner_cone_cos", 0.0, f32),
        outer_cone_cos=col("outer_cone_cos", 0.7071, f32),
        type=col("type", LIGHT_POINT, i32),
    )



@dataclasses.dataclass
class InstanceTable:
    """SoA instance rows; ``aabb_*`` is each instance's world box."""

    object_to_world: object  # (I, 3, 4) f32
    world_to_object: object  # (I, 3, 4) f32
    mesh_id: object          # (I,) i32
    aabb_min: object         # (I, 3) f32
    aabb_max: object         # (I, 3) f32


@dataclasses.dataclass
class MeshPool:
    """Object-space meshes concatenated into one Geometry; per-mesh triangle
    ranges and object-space bounds index it (host arrays)."""

    geometry: Geometry
    tri_start: np.ndarray  # (M,) first triangle of each mesh
    tri_count: np.ndarray  # (M,)
    aabb_min: np.ndarray   # (M, 3)
    aabb_max: np.ndarray   # (M, 3)
