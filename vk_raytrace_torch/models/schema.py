"""Scene containers — the torch counterpart of ``vk_raytrace_tpu/models/schema.py``.

Every table is a dataclass whose fields hold host numpy arrays while the
scene is built and torch tensors after ``.to(device)``. The builders emit the
same bytes as the reference, so the tables can be compared field by field.

Dtype mapping on ``.to``: float arrays stay float32, signed ints become
int64 (torch indexes with int64), and ``uint32`` arrays become ``int32``
tensors holding the same bit pattern (only consumers that mask bytes or
16-bit halves read them).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# Alpha modes (host_device.h:130-132)
ALPHA_OPAQUE = 0
ALPHA_MASK = 1
ALPHA_BLEND = 2

# Light types (host_device.h:211-213)
LIGHT_DIRECTIONAL = 0
LIGHT_POINT = 1
LIGHT_SPOT = 2

# Debug render modes (host_device.h:88-102): 1-8 show the first hit's
# state, 9 the radiance, 10 the last throughput, 11 the last ray direction,
# 12 the traversal steps as a heatmap.
DEBUG_NONE = 0
DEBUG_BASECOLOR = 1
DEBUG_NORMAL = 2
DEBUG_METALLIC = 3
DEBUG_EMISSIVE = 4
DEBUG_ALPHA = 5
DEBUG_ROUGHNESS = 6
DEBUG_TEXCOORD = 7
DEBUG_TANGENT = 8
DEBUG_RADIANCE = 9
DEBUG_WEIGHT = 10
DEBUG_RAYDIR = 11
DEBUG_HEATMAP = 12

# PBR models (RtxState.pbrMode, host_device.h:191)
PBR_DISNEY = 0
PBR_GLTF = 1


def to_tensor(a, device) -> torch.Tensor:
    """Host array (or tensor) -> tensor on ``device`` with the port's dtypes."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype.kind == "f":
        a = a.astype(np.float32)
    elif a.dtype.kind in "iu" and a.dtype != np.uint8:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a)).to(device)  # a fresh, writable copy


class Tables:
    """Mixin for dataclasses of arrays: ``.to(device)``."""

    def to(self, device):
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None or isinstance(v, (int, float, bool, str)):
                out[f.name] = v
            elif not isinstance(v, torch.Tensor) and hasattr(v, "to"):
                out[f.name] = v.to(device)  # nested tables
            else:
                out[f.name] = to_tensor(v, device)
        return dataclasses.replace(self, **out)


@dataclasses.dataclass
class Geometry(Tables):
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
class Materials(Tables):
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
class Lights(Tables):
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
class TextureAtlas(Tables):
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
class EnvAccel(Tables):
    """Walker alias table over env texels."""

    alias: object
    q: object
    pdf: object
    alias_pdf: object


@dataclasses.dataclass
class Environment(Tables):
    """Lat-long environment + importance-sampling table; ``rows`` packs the
    2x2 bilinear footprint and the alias data per texel (16 f32)."""

    image: object
    accel: EnvAccel
    integral: object
    average: object
    rows: Optional[object] = None


@dataclasses.dataclass
class Camera(Tables):
    view_inverse: object  # (4, 4)
    proj_inverse: object  # (4, 4)
    focal_dist: object    # ()
    aperture: object      # ()


@dataclasses.dataclass
class SunSky(Tables):
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


@dataclasses.dataclass
class SceneData(Tables):
    """Everything a render step reads. ``shade_rows`` (T, 128) f32 packs the
    per-triangle shade state and material row; ``tap_rows`` (H*W, 4) u32 the
    per-texel bilinear footprints. A two-level scene's ``geometry`` is the
    object-space mesh pool and ``instances`` its ``ops.tlas.InstancedAccel``,
    which the renderer takes over as its acceleration structure."""

    geometry: Geometry
    materials: Materials
    lights: Lights
    n_lights: int
    atlas: TextureAtlas
    env: Environment
    camera: Camera
    sun_sky: SunSky
    shade_rows: Optional[object] = None
    tap_rows: Optional[object] = None
    instances: Optional[object] = None


@dataclasses.dataclass
class Tonemapper(Tables):
    brightness: object
    contrast: object
    saturation: object
    vignette: object
    avg_lum: object
    zoom: object
    rendering_ratio: object
    auto_exposure: object
    ywhite: object
    key: object
    dither: object


def default_tonemapper() -> Tonemapper:
    f = lambda v: np.asarray(v, np.float32)
    i = lambda v: np.asarray(v, np.int32)
    return Tonemapper(
        brightness=f(1.0),
        contrast=f(1.0),
        saturation=f(1.0),
        vignette=f(0.0),
        avg_lum=f(1.0),
        zoom=f(1.0),
        rendering_ratio=f([1.0, 1.0]),
        auto_exposure=i(0),
        ywhite=f(0.5),
        key=f(0.5),
        dither=i(1),
    )


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render state (``RtxState`` minus the frame counter): the
    reference's fields and defaults, less ``render_scale`` (the CLI's).
    ``use_sun_sky`` is baked by ``render.prepare_sun_sky`` into the
    environment plus ``sun_disk``. A ``debug_mode`` other than
    ``DEBUG_NONE`` renders through the unrolled integrator
    (``integrator/path.py``); the heatmap maps the traversal kernels' node
    counts in [``min_heatmap``, ``max_heatmap``] onto the colour ramp."""

    width: int = 1280
    height: int = 720
    max_depth: int = 10
    max_samples: int = 1
    firefly_clamp: float = 1.0e20
    hdr_multiplier: float = 1.0
    debug_mode: int = DEBUG_NONE
    pbr_mode: int = PBR_DISNEY
    use_sun_sky: bool = False
    mip_sample: bool = True
    sun_disk: bool = False
    max_frames: int = 100000
    min_heatmap: float = 0.0
    max_heatmap: float = 256.0
    use_any_hit: bool = True
    rr: bool = True
    rr_depth: int = 0
    full_mis: bool = True


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


def dummy_atlas() -> TextureAtlas:
    """1x1 white atlas for scenes without textures."""
    return TextureAtlas(
        data=np.full((8, 128, 4), 255, np.uint8),
        x=np.zeros((1,), np.int32),
        y=np.zeros((1,), np.int32),
        width=np.ones((1,), np.int32),
        height=np.ones((1,), np.int32),
        wrap_s=np.zeros((1,), np.int32),
        wrap_t=np.zeros((1,), np.int32),
    )


def dummy_environment(color=(1.0, 1.0, 1.0)) -> Environment:
    """Constant-color 2x4 environment with a valid alias table."""
    img = np.ascontiguousarray(
        np.broadcast_to(np.asarray(color, np.float32), (2, 4, 3))
    )
    n = 8
    return Environment(
        image=img,
        accel=EnvAccel(
            alias=np.arange(n, dtype=np.int32),
            q=np.ones((n,), np.float32),
            pdf=np.full((n,), 1.0 / (4.0 * np.pi), np.float32),
            alias_pdf=np.full((n,), 1.0 / (4.0 * np.pi), np.float32),
        ),
        integral=np.float32(4.0 * np.pi * float(np.max(color))),
        average=np.float32(float(np.mean(color))),
    )
