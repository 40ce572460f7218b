"""Fused shading stage: one CUDA kernel for everything between the two
traversals of a pooled-wavefront bounce (counterpart of
``vk_raytrace_tpu/integrator/shade_fused.py``: its ``pallas_call`` body and
the XLA prologue around it).

On CUDA tensors :func:`shade_bounce_fused` is one launch of
``vkrt_shade_stage`` (``csrc/shade.cu``): the bounce's RNG draws, the shade
row and footprint tap reads, the uv transform and ray-cone LOD, the punctual
light and environment NEE samples, the miss radiance with its MIS weight,
then shade-state reconstruction, material resolve, NEE evaluation with MIS,
the glTF BSDF sample, absorption, the Russian-roulette continuation
probability and the next ray; it reads the scene's tables where they lie
(:class:`StageTables`, built once per renderer) and writes each epilogue
tensor. Its plain version, which CPU tensors take, is the prologue
:func:`shade_inputs` (everything that gathers, in torch) followed by
:func:`_shade_plain` (the body); the draws are taken up front in the order
the unfused stage consumes them, so every lane's random stream is
bit-identical either way. The epilogue (shadow ray, Russian roulette,
scatter) stays in ``integrator/wavefront.py``.

:func:`shade` runs the body alone on gathered inputs (``vkrt_shade`` on the
card), off the main path.

Supported statically (:func:`supported`): glTF PBR, a baked sky, merged
shade rows, footprint tap rows and no transmission or clearcoat textures,
in single-level and two-level (instanced) scenes. In an instanced scene the
rows are object space: the lane's instance rows (object-to-world, then
world-to-object) bring the hit to world space, and the light position and
ray-cone edges go through object-to-world too. :data:`LAUNCHES` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import cuda_build
from ..models.schema import PBR_GLTF
from ..ops import rng
from ..ops.env import env_radiance, environment_sample, sample_env_mixture
from ..ops.lights import sample_light
from ..ops.math import mat3_vec, mat3t_vec
from ..ops.sunsky import SunDisk, sun_disk_consts
from .path import env_bsdf_mis_weight, nee_strategy_pdf
from .shade import _OFFS, _PACK_LANES, _axis_base, _mip_lanes

M_PI = 3.14159265358979
_SROW_MAT0 = 40  # material row offset inside the merged shade row

# Narrow per-lane inputs ride in one (R, aux_width(instanced)) array, lanes:
#   0 gxy 8 (per-texture bilinear weights gx, gy x4) | 8 uv 2 |
#   10 geo 8 (dir3, hit_u, hit_v, hit_t, active, miss) | 18 origin 3 |
#   21 light 12 (ldir3, lcontrib3, ldist, lpdf, use_light, envmiss3) |
#   33 state 9 (radiance3, throughput3, absorption3) |
#   42 draws 6 (prob, r1, r2, u_trans, u_reflect, u_lobe) |
#   48 instance rows 24 (o2w then w2o, 3x4 row-major; instanced scenes only)
_AUX_INST = 48


def aux_width(instanced: bool) -> int:
    return _AUX_INST + 24 if instanced else _AUX_INST

OUT_W = 24  # new_origin3 new_dir3 radiance3 throughput3 absorption3 nee3 ldir3 ldist rr_pcont pdf_b
_TAPS = ("base", "mr", "normal", "emissive")

# Kernel launches, counted where the wrapper launches: the whole stage
# (vkrt_shade_stage) and the body alone (vkrt_shade).
LAUNCHES = {"shade_stage": 0, "shade_bounce": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class ShadeFlags(NamedTuple):
    """The kernel's static switches; branches on them are uniform per call.
    The body reads the first seven; the stage entry all (``csrc/shade.cu``
    enum Flag)."""

    base_tex: bool
    mr_tex: bool
    normal_tex: bool
    emissive_tex: bool
    anisotropy: bool
    full_mis: bool
    instanced: bool
    sun_disk: bool = False
    mip: bool = False

    def bits(self) -> int:
        return sum(int(bool(f)) << i for i, f in enumerate(self))


class StageTables(NamedTuple):
    """What the stage reads of the scene besides the hit and the lane state,
    on the scene's device (:func:`stage_tables`, once per renderer)."""

    shade_rows: torch.Tensor           # (T, 128) f32
    tap_rows: torch.Tensor             # (n_tap, 4) i32; one zero row without textures
    atlas_w: int
    env_rows: torch.Tensor             # (h * w, 16) f32
    env_h: int
    env_w: int
    lights: torch.Tensor               # (L, 16) f32, :func:`light_rows`
    n_lights: int
    sun_lanes: torch.Tensor            # (44,) f32, the sun disk's constants (:func:`sun_lanes`)
    o2w: Optional[torch.Tensor]        # (I, 12) f32 instance rows (instanced scenes)
    w2o: Optional[torch.Tensor]


def light_rows(lights) -> torch.Tensor:
    """The light table as (L, 16) f32 rows (``csrc/shade.cu`` enum
    LightLane): position, direction, color, intensity, range, inner and
    outer cone cosines, type."""
    col = lambda x: x.float().reshape(x.shape[0], -1)  # noqa: E731
    parts = [lights.position, lights.direction, lights.color, lights.intensity, lights.range,
             lights.inner_cone_cos, lights.outer_cone_cos, lights.type]
    rows = torch.cat([col(x) for x in parts], dim=1)
    return torch.nn.functional.pad(rows, (0, 16 - rows.shape[1])).contiguous()


SUN_LANES = 44


def sun_lanes(sd: SunDisk) -> torch.Tensor:
    """The disk's constants as (44,) f32 in ``SunDisk``'s field order
    (``csrc/shade.cu`` enum SunLane); booleans as 0 / 1."""
    out = torch.cat([x.float().reshape(-1) for x in sd]).contiguous()
    assert out.shape == (SUN_LANES,), out.shape
    return out


def stage_tables(scene, instances=None) -> StageTables:
    """The stage's tables of ``scene`` (and of its ``InstanceTable``), on
    the scene's device; what the kernel reads besides the lanes."""
    tap = scene.tap_rows
    if tap is None:
        tap = torch.zeros(1, 4, dtype=torch.int32, device=scene.shade_rows.device)
    o2w = w2o = None
    if instances is not None:
        o2w = instances.object_to_world.float().reshape(-1, 12).contiguous()
        w2o = instances.world_to_object.float().reshape(-1, 12).contiguous()
    return StageTables(
        shade_rows=scene.shade_rows.contiguous(), tap_rows=tap.contiguous(),
        atlas_w=int(scene.atlas.data.shape[1]), env_rows=scene.env.rows.contiguous(),
        env_h=int(scene.env.image.shape[0]), env_w=int(scene.env.image.shape[1]),
        lights=light_rows(scene.lights), n_lights=int(scene.n_lights),
        sun_lanes=sun_lanes(sun_disk_consts(scene.sun_sky)), o2w=o2w, w2o=w2o,
    )


def supported(fused_shade: bool, cfg, scene, features) -> bool:
    """Whether the fused stage serves this request: it was asked for
    (``fused_shade``) and the scene and config meet its static conditions,
    which are the reference's (``vk_raytrace_tpu/integrator/shade_fused.py::
    supported``): glTF PBR only (the Disney BSDF stays on the eager stage
    there too), a baked sky, no transmission or clearcoat textures, merged
    shade rows. Otherwise the eager stage runs; this is the reference's
    rule, not a fallback from a failed kernel."""
    if not fused_shade or cfg.pbr_mode != PBR_GLTF or cfg.use_sun_sky:
        return False
    if features is None or features.transmission_tex or features.clearcoat_tex:
        return False
    sr = scene.shade_rows
    if sr is None or sr.shape[1] < _SROW_MAT0 + _PACK_LANES:
        return False
    textured = features.base_tex or features.mr_tex or features.normal_tex or features.emissive_tex
    return scene.tap_rows is not None or not textured


# ---------------------------------------------------------------------------
# Prologue (torch): gathers, draws, light and environment samples
# ---------------------------------------------------------------------------


def _tex_index_weights(srow, name, uv, atlas_w, n_rows, lod=None):
    """Per-lane footprint row index and bilinear axis weights of one texture
    from the material placement lanes; with ``lod``, the nearest mip level's
    placement (``shade.py::_mip_lanes``)."""
    o = _SROW_MAT0 + _OFFS[f"{name}_tex"]
    if lod is not None:
        prow = srow[:, _SROW_MAT0:_SROW_MAT0 + _PACK_LANES]
        ox, oy, w, h = _mip_lanes(prow, _OFFS[f"{name}_tex"], lod)
    else:
        ox = srow[:, o + 1].long()
        oy = srow[:, o + 2].long()
        w = torch.clamp(srow[:, o + 3].long(), min=1)
        h = torch.clamp(srow[:, o + 4].long(), min=1)
    wrap = srow[:, o + 5].long()
    ws, wt = wrap // 3, wrap % 3
    px = uv[:, 0] * w.float() - 0.5
    py = uv[:, 1] * h.float() - 0.5
    bx, gx = _axis_base(px, w, ws)
    by, gy = _axis_base(py, h, wt)
    flat = torch.clamp((oy + by) * atlas_w + (ox + bx), 0, n_rows - 1)
    return flat, gx, gy


def _positioned_light(scene, light_index, srow, hit, o2w=None):
    """``sample_light`` at the hit position, from 9 lanes of the row (and
    the lane's object-to-world rows in an instanced scene)."""
    wb = 1.0 - hit.u - hit.v
    p = srow[:, 0:9].reshape(-1, 3, 3)
    position = wb[:, None] * p[:, 0] + hit.u[:, None] * p[:, 1] + hit.v[:, None] * p[:, 2]
    if o2w is not None:
        position = mat3_vec(o2w, position) + o2w[:, :, 3]
    return sample_light(scene.lights, light_index, position)


class ShadeInputs(NamedTuple):
    srow: torch.Tensor   # (R, 128) f32 gathered shade rows
    taps: torch.Tensor   # (R, 16) i32 footprint rows of the 4 textures
    aux: torch.Tensor    # (R, 48 or 72) f32, layout above aux_width
    flags: ShadeFlags
    seed: torch.Tensor   # (R,) stream state after the stage's draws
    miss: torch.Tensor   # (R,) bool


def shade_inputs(
    scene, features, full_mis: bool, p_select_light: float, hdr_mult: float, hit,
    st_origin, st_direction, seed, active, radiance, throughput, absorption, bsdf_pdf,
    instances=None, sun_disk: bool = False, mip=None,
) -> ShadeInputs:
    """The prologue of :func:`shade_bounce_fused`'s plain version: the
    body's inputs. ``active`` None means every lane is live; ``instances``
    is the ``InstanceTable`` of a two-level scene (``hit.inst`` then names
    each lane's instance); ``mip`` is ``(pixel_spread, tdist including this
    hit)`` for ray-cone mip selection, or None. Every sum over x, y, z runs
    in that order, as the kernel sums."""
    r = st_direction.shape[0]
    dev = st_direction.device
    if active is None:
        active = torch.ones(r, dtype=torch.bool, device=dev)
    miss = active & (hit.tri < 0)
    o2w = w2o = None
    if instances is not None:
        ii = torch.clamp(hit.inst, min=0)
        o2w = instances.object_to_world[ii]
        w2o = instances.world_to_object[ii]
    sun = sun_disk_consts(scene.sun_sky) if sun_disk else None

    # ---- RNG draws, in the unfused stage's order (env.py, bsdf_gltf.py) ---
    seed, u_sel = rng.rand(seed)
    seed, u_li = rng.rand(seed)
    if sun_disk:
        seed, u_mix = rng.rand(seed)  # the mixture's draw precedes xi
    seed, xi = rng.rand3(seed)
    seed, probability = rng.rand(seed)
    seed, r1 = rng.rand(seed)
    seed, r2 = rng.rand(seed)
    seed, u_trans = rng.rand(seed)
    seed, u_reflect = rng.rand(seed)
    seed, u_lobe = rng.rand(seed)

    # ---- the shade-row gather and the uv transform ------------------------
    srow = scene.shade_rows[torch.clamp(hit.tri, min=0)]
    wb = 1.0 - hit.u - hit.v
    uv3 = srow[:, 22:28].reshape(-1, 3, 2)
    uv_raw = wb[:, None] * uv3[:, 0] + hit.u[:, None] * uv3[:, 1] + hit.v[:, None] * uv3[:, 2]
    o_uvt = _SROW_MAT0 + _OFFS["uvT"]
    uvt = srow[:, o_uvt:o_uvt + 6]
    su, sv = uv_raw[:, 0], uv_raw[:, 1]
    uv = torch.stack(
        [su * uvt[:, 0] + sv * uvt[:, 2] + uvt[:, 4], su * uvt[:, 1] + sv * uvt[:, 3] + uvt[:, 5]],
        dim=-1,
    )

    # ---- ray-cone LOD (path.py::cone_lod from the gathered row) -----------
    lod = None
    if mip is not None:
        spread, tdist = mip
        p3 = srow[:, 0:9].reshape(-1, 3, 3)
        e1 = p3[:, 1] - p3[:, 0]
        e2 = p3[:, 2] - p3[:, 0]
        if o2w is not None:
            e1, e2 = mat3_vec(o2w, e1), mat3_vec(o2w, e2)
        c = _cross(e1, e2)
        area_w = torch.sqrt(_dot(c, c))[:, 0]
        u1 = uv3[:, 1] - uv3[:, 0]
        u2 = uv3[:, 2] - uv3[:, 0]
        area_uv = torch.abs(u1[:, 0] * u2[:, 1] - u1[:, 1] * u2[:, 0])
        uv_density = 0.5 * torch.log2(
            torch.clamp(area_uv, min=1e-20) / torch.clamp(area_w, min=1e-20)
        )
        lod = uv_density + torch.log2(torch.clamp(spread * tdist, min=1e-20))

    # ---- the four footprint tap gathers -----------------------------------
    tap_rows = scene.tap_rows
    n_tap = tap_rows.shape[0] if tap_rows is not None else 1
    atlas_w = scene.atlas.data.shape[1]
    taps, gxy = [], []
    zero_f = torch.zeros(r, device=dev)
    for name in _TAPS:
        if getattr(features, f"{name}_tex"):
            flat, gx, gy = _tex_index_weights(srow, name, uv, atlas_w, n_tap, lod=lod)
            taps.append(tap_rows[flat])
            gxy += [gx, gy]
        else:
            taps.append(torch.zeros(r, 4, dtype=torch.int32, device=dev))
            gxy += [zero_f, zero_f]
    taps = torch.cat(taps, dim=1).contiguous()
    gxy = torch.stack(gxy, dim=-1)

    # ---- light and environment NEE samples from the pre-drawn variates ----
    n_lights = int(scene.n_lights)
    use_light = (u_sel <= p_select_light) if n_lights > 0 else torch.zeros_like(miss)
    n_l = max(n_lights, 1)
    light_index = torch.clamp((u_li * float(n_l)).long(), max=n_l - 1)
    l_int, l_dir, l_dist = _positioned_light(scene, light_index, srow, hit, o2w)
    if sun_disk:
        e_rad, e_dir, e_pdf = sample_env_mixture(scene.env, sun, u_mix, xi)
    else:
        e_rad, e_dir, e_pdf = environment_sample(scene.env, xi)
    e_rad = e_rad * hdr_mult
    light_contrib = torch.where(use_light[..., None], l_int, e_rad)
    light_dir = torch.where(use_light[..., None], l_dir, e_dir)
    light_dist = torch.where(use_light, l_dist, 1e32)
    light_pdf = nee_strategy_pdf(full_mis, n_lights, use_light, e_pdf, p_select_light)

    # ---- environment miss radiance with its MIS weight --------------------
    env = env_radiance(scene.env, sun, hdr_mult, st_direction)
    if full_mis:
        w_env = env_bsdf_mis_weight(scene, bsdf_pdf, st_direction, p_select_light, sun)
        env = env * w_env[..., None]

    col = lambda x: x.float()[:, None]  # noqa: E731
    parts = [
        gxy, uv,
        st_direction, col(hit.u), col(hit.v), col(hit.t), col(active), col(miss),
        st_origin,
        light_dir, light_contrib, col(light_dist), col(light_pdf), col(use_light), env,
        radiance, throughput, absorption,
        torch.stack([probability, r1, r2, u_trans, u_reflect, u_lobe], dim=-1),
    ]
    if o2w is not None:
        parts += [o2w.reshape(r, 12), w2o.reshape(r, 12)]
    aux = torch.cat(parts, dim=1).contiguous()
    assert aux.shape[1] == aux_width(o2w is not None), aux.shape
    flags = ShadeFlags(
        features.base_tex, features.mr_tex, features.normal_tex, features.emissive_tex,
        features.anisotropy, full_mis, o2w is not None,
    )
    return ShadeInputs(srow.contiguous(), taps, aux, flags, seed, miss)


_VEC_OUT = ("new_origin", "new_dir", "radiance", "throughput", "absorption", "nee", "light_dir")
_COL_OUT = ("light_dist", "rr_pcont", "pdf_b")


def shade_bounce_fused(
    scene, features, full_mis: bool, p_select_light: float, hdr_mult: float, hit,
    st_origin, st_direction, seed, active, radiance, throughput, absorption, bsdf_pdf,
    instances=None, sun_disk: bool = False, mip=None, path_tdist=None,
    tables: Optional[StageTables] = None,
) -> dict:
    """Run the fused shading stage for one pooled bounce. Returns a dict with
    radiance, throughput, absorption, alive, visible, nee, light_dir,
    light_dist, new_origin, new_dir, rr_pcont, pdf_b, seed and miss: the
    epilogue inputs of ``wavefront.py::bounce``.

    The wavefront passes ``path_tdist`` (R,), the path length before this
    hit: the stage adds the hit's t (where it hit) and returns the sum as
    ``tdist``, and ``mip=(pixel_spread, None)`` takes the ray-cone LOD from
    that sum (``mip=None``: the base level). The reference's own form,
    ``mip=(pixel_spread, tdist)`` with tdist including this hit and no
    ``path_tdist``, only the plain version takes.

    CUDA tensors launch ``vkrt_shade_stage`` once, reading ``tables`` (the
    scene's :class:`StageTables`, built once per renderer), or raise; CPU
    tensors run the plain version, :func:`shade_inputs` then
    :func:`_shade_plain`, which reads the scene itself."""
    dev = st_direction.device
    args = (scene, features, full_mis, p_select_light, hdr_mult, hit, st_origin, st_direction,
            seed, active, radiance, throughput, absorption, bsdf_pdf, instances, sun_disk, mip,
            path_tdist)
    if dev.type == "cuda":
        return _stage_launch(*args, tables)
    if dev.type != "cpu":
        raise ValueError(f"no shading stage for device {dev}")
    return _stage_plain(*args)


def _stage_plain(scene, features, full_mis, p_select_light, hdr_mult, hit, st_origin,
                 st_direction, seed, active, radiance, throughput, absorption, bsdf_pdf,
                 instances, sun_disk, mip, path_tdist) -> dict:
    """The plain version of the stage (any device): :func:`shade_inputs`
    then :func:`_shade_plain`, arguments as :func:`shade_bounce_fused`'s."""
    extra = {}
    if path_tdist is not None:
        extra["tdist"] = path_tdist + torch.where(
            hit.tri >= 0, torch.clamp(hit.t, max=1e30), 0.0)
        if mip is not None:
            mip = (mip[0], extra["tdist"])
    x = shade_inputs(
        scene, features, full_mis, p_select_light, hdr_mult, hit, st_origin, st_direction,
        seed, active, radiance, throughput, absorption, bsdf_pdf, instances=instances,
        sun_disk=sun_disk, mip=mip,
    )
    out_vec, alive, visible = _shade_plain(x.srow, x.taps, x.aux, x.flags)
    col = lambda a, b: out_vec[:, a:b].contiguous()  # noqa: E731  (the traversals want dense rays)
    out = {k: col(3 * j, 3 * j + 3) for j, k in enumerate(_VEC_OUT)}
    out.update({k: out_vec[:, 21 + j].contiguous() for j, k in enumerate(_COL_OUT)})
    return dict(out, alive=alive, visible=visible, seed=x.seed, miss=x.miss, **extra)


def _stage_launch(scene, features, full_mis, p_select_light, hdr_mult, hit, st_origin,
                  st_direction, seed, active, radiance, throughput, absorption, bsdf_pdf,
                  instances, sun_disk, mip, path_tdist, tables) -> dict:
    """The stage kernel, arguments as :func:`_stage_plain`'s and the
    scene's :class:`StageTables`: the wavefront's form only."""
    if tables is None:
        raise ValueError("the stage kernel reads the scene's StageTables: pass tables")
    if path_tdist is None or (mip is not None and mip[1] is not None):
        raise ValueError("the stage kernel adds the hit's t to path_tdist: pass path_tdist, "
                         "and mip=(pixel_spread, None)")
    flags = ShadeFlags(
        features.base_tex, features.mr_tex, features.normal_tex, features.emissive_tex,
        features.anisotropy, full_mis, instances is not None, sun_disk, mip is not None,
    )
    return _stage_cuda(tables, flags, p_select_light, hdr_mult,
                       mip[0] if mip is not None else None, hit, st_origin, st_direction, seed,
                       active, radiance, throughput, absorption, bsdf_pdf, path_tdist)


def shade(srow, taps, aux, flags: ShadeFlags):
    """The stage's body: ``(out_vec (R, 24) f32, alive (R,) bool, visible
    (R,) bool)``. CPU tensors take :func:`_shade_plain`; CUDA tensors
    launch the kernel or raise."""
    if srow.device.type == "cuda":
        return _shade_cuda(srow, taps, aux, flags)
    if srow.device.type != "cpu":
        raise ValueError(f"no shading stage for device {srow.device}")
    return _shade_plain(srow, taps, aux, flags)


# ---------------------------------------------------------------------------
# The plain version: the kernel body clause for clause on (R, k) tensors.
# Vectors are (R, 3), scalars (R, 1); dot products add x, y, z in that
# order, as the kernel does.
# ---------------------------------------------------------------------------

_F04 = 0.04
_F096 = float(np.float32(1.0) - np.float32(0.04))


def _dot(a, b):
    return a[:, 0:1] * b[:, 0:1] + a[:, 1:2] * b[:, 1:2] + a[:, 2:3] * b[:, 2:3]


def _normalize(v):
    return v / torch.sqrt(_dot(v, v))


def _cross(a, b):
    ax, ay, az = a[:, 0:1], a[:, 1:2], a[:, 2:3]
    bx, by, bz = b[:, 0:1], b[:, 1:2], b[:, 2:3]
    return torch.cat([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=1)


def _mix(a, b, t):
    return a + (b - a) * t


def _pow5(x):
    x2 = x * x
    return x2 * x2 * x


def _srgb(c):
    """pow(max(c, 0), 2.2) as exp(2.2 log c), exact at 0."""
    c = torch.clamp(c, min=0.0)
    out = torch.exp(2.2 * torch.log(torch.clamp(c, min=1e-30)))
    return torch.where(c <= 0.0, 0.0, out)


def _oct_decode3(lo, hi):
    """Octahedral decode of 3 vertices' packed normals from their u16
    halves (R, 3); returns (x, y, z), each (R, 3), not normalised."""
    x = lo.int() - 32767
    y = hi.int() - 32767
    maskx = x >> 31
    masky = y >> 31
    tmp0 = 32767 + maskx + masky
    ymask = y ^ masky
    tmp1 = tmp0 - (x ^ maskx)
    z = tmp1 - ymask
    xf = (tmp0 - ymask) ^ maskx
    yf = tmp1 ^ masky
    neg = z < 0
    x = torch.where(neg, xf, x)
    y = torch.where(neg, yf, y)
    s = 1.0 / 32768.0
    return x.float() * s, y.float() * s, z.float() * s


def _bary3(w, u, v, a):
    """w*a0 + u*a1 + v*a2 over the 3 vertex columns of ``a`` (R, 3)."""
    return w * a[:, 0:1] + u * a[:, 1:2] + v * a[:, 2:3]


def _vertex_dir(w, u, v, x, y, z):
    """Per-vertex normalise, interpolate, normalise."""
    n = torch.sqrt(x * x + y * y + z * z)
    x, y, z = x / n, y / n, z / n
    return _normalize(torch.cat([_bary3(w, u, v, x), _bary3(w, u, v, y), _bary3(w, u, v, z)], dim=1))


def _unpack_texel(c):
    """RGBA8 words (R,) i32 -> (R, 4) in [0, 1]."""
    s = 1.0 / 255.0
    return torch.stack(
        [(c & 0xFF).float() * s, ((c >> 8) & 0xFF).float() * s,
         ((c >> 16) & 0xFF).float() * s, ((c >> 24) & 0xFF).float() * s],
        dim=1,
    )


def _tap_blend(trow, gx, gy, srgb):
    c00, c10 = _unpack_texel(trow[:, 0]), _unpack_texel(trow[:, 1])
    c01, c11 = _unpack_texel(trow[:, 2]), _unpack_texel(trow[:, 3])
    top = c00 + (c10 - c00) * gx
    bot = c01 + (c11 - c01) * gx
    out = top + (bot - top) * gy
    if srgb:
        out = torch.cat([_srgb(out[:, 0:3]), out[:, 3:4]], dim=1)
    return out


def _f_schlick(f0, f90_minus_f0, vdoth):
    return f0 + f90_minus_f0 * _pow5(torch.clamp(1.0 - vdoth, 0.0, 1.0))


def _v_ggx(ndotl, ndotv, alpha):
    a2 = alpha * alpha
    ggxv = ndotl * torch.sqrt(ndotv * ndotv * (1.0 - a2) + a2)
    ggxl = ndotv * torch.sqrt(ndotl * ndotl * (1.0 - a2) + a2)
    ggx = ggxv + ggxl
    return torch.where(ggx > 0.0, 0.5 / torch.clamp(ggx, min=1e-12), 0.0)


def _v_ggx_aniso(ndotl, ndotv, bdotv, tdotv, tdotl, bdotl, at, ab):
    a, b = at * tdotv, ab * bdotv
    ggxv = ndotl * torch.sqrt(a * a + b * b + ndotv * ndotv)
    a, b = at * tdotl, ab * bdotl
    ggxl = ndotv * torch.sqrt(a * a + b * b + ndotl * ndotl)
    return torch.clamp(0.5 / torch.clamp(ggxv + ggxl, min=1e-12), 0.0, 1.0)


def _d_ggx(ndoth, alpha):
    a2 = alpha * alpha
    f = ndoth * ndoth * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(M_PI * f * f, min=1e-12)


def _d_ggx_aniso(ndoth, tdoth, bdoth, at, ab):
    a2 = at * ab
    x, y, z = ab * tdoth, at * bdoth, a2 * ndoth
    w2 = a2 / torch.clamp(x * x + y * y + z * z, min=1e-20)
    return a2 * w2 * w2 * (1.0 / M_PI)


def _sdiv(num, den, eps=1e-9):
    safe = torch.where(torch.abs(den) < eps, torch.where(den < 0, -eps, eps), den)
    return num / safe


def _reflect(i, n):
    return i - 2.0 * _dot(n, i) * n


def _refract(i, n, eta):
    cosi = _dot(n, i)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    out = eta * i - (eta * cosi + torch.sqrt(torch.clamp(k, min=0.0))) * n
    return torch.where(k < 0.0, 0.0, out)


def _from_local(x, y, z, t, b, n):
    return x * t + y * b + z * n


def _offset_ray(p, n):
    """``ops/math.py::offset_ray`` (integer-ULP offset)."""
    of_i = (256.0 * n).to(torch.int32)
    p_i = (p.contiguous().view(torch.int32) + torch.where(p < 0.0, -of_i, of_i)).view(torch.float32)
    return torch.where(torch.abs(p) < (1.0 / 32.0), p + (1.0 / 65536.0) * n, p_i)


class _Mat(NamedTuple):
    albedo: torch.Tensor
    metallic: torch.Tensor
    roughness: torch.Tensor
    f0: torch.Tensor
    transmission: torch.Tensor
    ior: torch.Tensor
    anisotropy: torch.Tensor
    thinwalled: torch.Tensor
    clearcoat: torch.Tensor
    cc_rough: torch.Tensor


def _shade_plain(srow, taps, aux, flags: ShadeFlags):
    """Plain torch version of ``csrc/shade.cu`` (any device): the same float32
    operations in the same order."""
    gxy = aux[:, 0:8]
    d = aux[:, 10:13]
    hit_u, hit_v, hit_t = aux[:, 13:14], aux[:, 14:15], aux[:, 15:16]
    active = aux[:, 16:17] > 0.5
    miss = aux[:, 17:18] > 0.5
    st_origin = aux[:, 18:21]
    lrow = aux[:, 21:33]
    radiance, throughput, absorption = aux[:, 33:36], aux[:, 36:39], aux[:, 39:42]
    draws = aux[:, 42:48]

    def mrow(name, n=1):
        o = _SROW_MAT0 + _OFFS[name]
        return srow[:, o:o + n]

    # ---- shade state (shade_state.glsl:63-145) ----------------------------
    w_b = 1.0 - hit_u - hit_v
    p0, p1, p2 = srow[:, 0:3], srow[:, 3:6], srow[:, 6:9]
    position = w_b * p0 + hit_u * p1 + hit_v * p2
    normal = _vertex_dir(w_b, hit_u, hit_v, *_oct_decode3(srow[:, 9:12], srow[:, 12:15]))
    geom_normal = _normalize(_cross(p1 - p0, p2 - p0))
    tangent = _vertex_dir(w_b, hit_u, hit_v, *_oct_decode3(srow[:, 15:18], srow[:, 18:21]))
    if flags.instanced:
        o2w = aux[:, _AUX_INST:_AUX_INST + 12].reshape(-1, 3, 4)
        w2o = aux[:, _AUX_INST + 12:_AUX_INST + 24].reshape(-1, 3, 4)
        position = mat3_vec(o2w, position) + o2w[:, :, 3]
        normal = _normalize(mat3t_vec(w2o, normal))
        geom_normal = _normalize(mat3t_vec(w2o, geom_normal))
        tangent = _normalize(mat3_vec(o2w, tangent))
    handed = srow[:, 21:22]
    tangent = _normalize(tangent - _dot(tangent, normal) * normal)
    bitangent = _cross(normal, tangent) * handed
    lo, hi = srow[:, 28:31].int(), srow[:, 31:34].int()
    s255 = 1.0 / 255.0
    vcol = torch.cat(
        [_bary3(w_b, hit_u, hit_v, (lo & 0xFF).float() * s255),
         _bary3(w_b, hit_u, hit_v, (lo >> 8).float() * s255),
         _bary3(w_b, hit_u, hit_v, (hi & 0xFF).float() * s255)],
        dim=1,
    )
    flip = _dot(normal, geom_normal) <= 0.0
    normal = torch.where(flip, -normal, normal)

    # ---- material resolve (gltf_material.glsl:105-193) --------------------
    ffnormal = torch.where(_dot(normal, d) <= 0.0, normal, -normal)
    ones4 = torch.ones(srow.shape[0], 4, device=srow.device)

    def tap(name, srgb=False):
        i = _TAPS.index(name)
        out = _tap_blend(taps[:, 4 * i:4 * i + 4], gxy[:, 2 * i:2 * i + 1],
                         gxy[:, 2 * i + 1:2 * i + 2], srgb)
        return torch.where(mrow(f"{name}_tex") < 0.0, 1.0, out)

    if flags.normal_tex:
        nscale = mrow("normal_scale")
        nvec = _normalize(tap("normal")[:, 0:3] * 2.0 - 1.0)
        nvec = nvec * torch.cat([nscale, nscale, torch.ones_like(nscale)], dim=1)
        mapped = _normalize(nvec[:, 0:1] * tangent + nvec[:, 1:2] * bitangent + nvec[:, 2:3] * normal)
        has_nmap = mrow("normal_tex") >= 0.0
        normal = torch.where(has_nmap, mapped, normal)
        ffnormal = torch.where(_dot(normal, d) <= 0.0, normal, -normal)
        # make_coordinate_system(ffnormal) (common.glsl:80-92)
        fx, fy, fz = ffnormal[:, 0:1], ffnormal[:, 1:2], ffnormal[:, 2:3]
        t2 = torch.where(
            torch.abs(fz) > 0.99999,
            torch.cat([-fx * fy, 1.0 - fy * fy, -fy * fz], dim=1),
            torch.cat([-fx * fz, -fy * fz, 1.0 - fz * fz], dim=1),
        )
        t2 = _normalize(t2)
        b2 = _cross(t2, ffnormal)
        tangent = torch.where(has_nmap, t2, tangent)
        bitangent = torch.where(has_nmap, b2, bitangent)

    emission = mrow("emissive_factor", 3)
    if flags.emissive_tex:
        emission = emission * tap("emissive", srgb=True)[:, 0:3]
    ior = mrow("ior")
    ds = (ior - 1.0) / (ior + 1.0)
    dielectric_spec = ds * ds
    mr = tap("mr") if flags.mr_tex else ones4
    roughness = mr[:, 1:2] * mrow("rough_f")
    metallic = mr[:, 2:3] * mrow("metal_f")
    base = mrow("base_factor", 4) * (tap("base", srgb=True) if flags.base_tex else ones4)
    f0 = dielectric_spec * (1.0 - metallic) + base[:, 0:3] * metallic
    albedo = base[:, 0:3] * vcol
    roughness = torch.clamp(roughness, min=0.001)
    eta = torch.where(_dot(normal, ffnormal) > 0.0, 1.0 / ior, ior)
    unlit = mrow("unlit") == 1.0
    anisotropy = mrow("aniso")
    if flags.anisotropy:
        adir = mrow("aniso_dir", 3)
        t_rot = _normalize(adir[:, 0:1] * tangent + adir[:, 1:2] * bitangent + adir[:, 2:3] * normal)
        b_rot = _normalize(_cross(normal, t_rot))
        has_aniso = anisotropy > 0.0
        tangent = torch.where(has_aniso, t_rot, tangent)
        bitangent = torch.where(has_aniso, b_rot, bitangent)
    m = _Mat(
        albedo=albedo, metallic=metallic, roughness=roughness, f0=f0,
        transmission=mrow("transmission_f"), ior=ior, anisotropy=anisotropy,
        thinwalled=mrow("thickness") == 0.0, clearcoat=mrow("cc_f"),
        cc_rough=torch.clamp(mrow("cc_rough"), min=0.001),
    )

    # ---- integrator clauses (pathtrace.glsl:258-296) ----------------------
    alive = active & ~miss
    unlit_l = alive & unlit
    radiance = radiance + torch.where(unlit_l, albedo * throughput, 0.0)
    alive = alive & ~unlit_l
    exiting = _dot(normal, ffnormal) > 0.0
    absorption = torch.where(exiting, 0.0, absorption)
    radiance = radiance + torch.where(alive, emission * throughput, 0.0)
    throughput = throughput * torch.where(
        alive, torch.exp(-absorption * torch.clamp(hit_t, max=1e30)), 1.0
    )

    # ---- NEE eval (pathtrace.glsl:97-188) ---------------------------------
    v = -d
    ldir, lcontrib = lrow[:, 0:3], lrow[:, 3:6]
    ldist, lpdf = lrow[:, 6:7], lrow[:, 7:8]
    use_light = lrow[:, 8:9] > 0.5
    envmiss = lrow[:, 9:12]
    f_l, pdf_l = _pbr_eval_rows(flags, m, v, ffnormal, ldir, tangent, bitangent, eta)
    t2mis = lpdf * lpdf
    ph = t2mis / (pdf_l * pdf_l + t2mis)
    mis = torch.where(use_light, 1.0, torch.clamp(ph, min=0.0))
    nee = mis * f_l * torch.abs(_dot(ldir, ffnormal)) * lcontrib / torch.clamp(lpdf, min=1e-9)
    visible = alive & (_dot(ldir, ffnormal) > 0.0)
    nee = nee * throughput
    radiance = radiance + torch.where(miss, envmiss * throughput, 0.0)

    # ---- BSDF sample (pbr_gltf.glsl:439-554) ------------------------------
    f_b, l_b, pdf_b = _pbr_sample_rows(flags, m, v, ffnormal, normal, tangent, bitangent, eta, draws)
    entering = _dot(ffnormal, l_b) < 0.0
    new_abs = -torch.log(torch.clamp(mrow("atten_color", 3), 1e-6, 1.0)) / torch.clamp(
        mrow("atten_dist"), min=1e-9
    )
    absorption = torch.where(alive & entering, new_abs, absorption)
    pdf_ok = pdf_b > 0.0
    throughput = torch.where(
        alive & pdf_ok,
        throughput * f_b * torch.abs(_dot(ffnormal, l_b)) / torch.clamp(pdf_b, min=1e-20),
        throughput,
    )
    alive = alive & pdf_ok
    max_thr = torch.maximum(torch.maximum(throughput[:, 0:1], throughput[:, 1:2]), throughput[:, 2:3])
    rr_pcont = torch.clamp(max_thr * eta * eta + 0.001, max=0.95)
    going_out = _dot(l_b, ffnormal) > 0.0
    off_n = torch.where(going_out, ffnormal, -ffnormal)
    new_origin = torch.where(alive, _offset_ray(position, off_n), st_origin)
    new_dir = torch.where(alive, l_b, d)
    out_vec = torch.cat(
        [new_origin, new_dir, radiance, throughput, absorption, nee, ldir, ldist, rr_pcont, pdf_b],
        dim=1,
    )
    return out_vec, alive[:, 0], visible[:, 0]


def _spec_lobe(flags, m, f0, f90m, v, l, h, tangent, bitangent, ndotl_c, ndotv, ndoth_u,
               ldoth_u, vdoth_u):
    """Isotropic or anisotropic GGX (pdf, f) before the validity mask."""
    ndoth = torch.clamp(ndoth_u, 0.0, 1.0)
    ldoth = torch.clamp(ldoth_u, 0.0, 1.0)
    vdoth = torch.clamp(vdoth_u, 0.0, 1.0)
    pdf = _d_ggx(ndoth, m.roughness) * ndoth / torch.clamp(4.0 * ldoth, min=1e-9)
    fresnel = _f_schlick(f0, f90m, vdoth)
    f = (fresnel * _v_ggx(ndotl_c, ndotv, m.roughness)
         * _d_ggx(ndoth, torch.clamp(m.roughness, min=0.001)))
    if flags.anisotropy:
        tdotv = torch.clamp(_dot(tangent, v), 0.0, 1.0)
        bdotv = torch.clamp(_dot(bitangent, v), 0.0, 1.0)
        tdotl, bdotl = _dot(tangent, l), _dot(bitangent, l)
        tdoth, bdoth = _dot(tangent, h), _dot(bitangent, h)
        aniso = m.anisotropy
        at = torch.clamp(m.roughness * (1.0 + aniso), min=0.001)
        ab = torch.clamp(m.roughness * (1.0 - aniso), min=0.001)
        pdf_a = _sdiv(_d_ggx_aniso(ndoth_u, tdoth, bdoth, at, ab), 4.0 * ldoth_u)
        at2 = torch.clamp(m.roughness * (1.0 + aniso), min=0.00001)
        ab2 = torch.clamp(m.roughness * (1.0 - aniso), min=0.00001)
        f_a = (fresnel * _v_ggx_aniso(ndotl_c, ndotv, bdotv, tdotv, tdotl, bdotl, at2, ab2)
               * _d_ggx_aniso(ndoth_u, tdoth, bdoth, at2, ab2))
        use_a = aniso > 0.0
        pdf = torch.where(use_a, pdf_a, pdf)
        f = torch.where(use_a, f_a, f)
    return pdf, f


def _clearcoat_lobe(m, ndotl_c, ndotv, ndoth_u, ldoth_u, vdoth_u):
    """Clearcoat (pdf, f) before the validity mask; f is (R, 1)."""
    ccf = _f_schlick(_F04, _F096, vdoth_u)
    cca = m.cc_rough * m.cc_rough
    g_c = _v_ggx(ndotl_c, ndotv, cca)
    d_c = _d_ggx(ndoth_u, torch.clamp(cca, min=0.001))
    pdf = d_c * ndoth_u / torch.clamp(4.0 * ldoth_u, min=1e-9)
    return pdf, ccf * d_c * g_c * m.clearcoat


def _f90(f0):
    refl = torch.maximum(torch.maximum(f0[:, 0:1], f0[:, 1:2]), f0[:, 2:3])
    return torch.clamp(refl * 50.0, 0.0, 1.0)


def _pbr_eval_rows(flags, m, v, n, l, tangent, bitangent, eta):
    """``PbrEval`` (pbr_gltf.glsl:365-434): (f (R, 3), pdf (R, 1))."""
    ndotl = _dot(n, l)
    h = torch.where(ndotl < 0.0, _normalize(l * (1.0 / eta) + v), _normalize(l + v))
    h = torch.where(_dot(n, h) < 0.0, -h, h)
    diffuse_ratio = 0.5 * (1.0 - m.metallic)
    spec_ratio = 1.0 - diffuse_ratio
    primary_spec_ratio = 1.0 / (1.0 + m.clearcoat)
    trans_weight = (1.0 - m.metallic) * m.transmission
    bsdf, bsdf_pdf = m.albedo, torch.abs(ndotl)
    f0 = m.f0
    f90m = _f90(f0) - f0

    ndotv_r = _dot(n, v)
    valid_d = (ndotl >= 0.0) & (ndotv_r >= 0.0)
    ndotl_c = torch.clamp(ndotl, 0.001, 1.0)
    pd = torch.where(valid_d, ndotl_c * (1.0 / M_PI), 0.0)
    fd = torch.where(valid_d, (1.0 - m.metallic) * (m.albedo * (1.0 / M_PI)), 0.0)

    valid = ndotl >= 0.0
    ndotv = torch.clamp(torch.abs(ndotv_r), 0.001, 1.0)
    ndoth_u, vdoth_u, ldoth_u = _dot(n, h), _dot(v, h), _dot(l, h)
    pc, fc = _clearcoat_lobe(m, ndotl_c, ndotv, ndoth_u, ldoth_u, vdoth_u)
    pc = torch.where(valid, pc, 0.0)
    fc = torch.where(valid, fc, 0.0)
    ps, fs = _spec_lobe(flags, m, f0, f90m, v, l, h, tangent, bitangent, ndotl_c, ndotv,
                        ndoth_u, ldoth_u, vdoth_u)
    ps = torch.where(valid, ps, 0.0)
    fs = torch.where(valid, fs, 0.0)

    refl_side = ndotl > 0.0
    brdf = torch.where(refl_side, fd + fc + fs, 0.0)
    brdf_pdf = torch.where(
        refl_side,
        pd * diffuse_ratio + pc * (1.0 - primary_spec_ratio) * spec_ratio
        + ps * primary_spec_ratio * spec_ratio,
        0.0,
    )
    return _mix(brdf, bsdf, trans_weight), _mix(brdf_pdf, bsdf_pdf, trans_weight)


def _pbr_sample_rows(flags, m, v, n, normal, tangent, bitangent, eta, draws):
    """``PbrSample`` (pbr_gltf.glsl:439-554) from the pre-drawn variates:
    (f (R, 3), l (R, 3), pdf (R, 1))."""
    probability, r1, r2 = draws[:, 0:1], draws[:, 1:2], draws[:, 2:3]
    u_trans, u_reflect, u_lobe = draws[:, 3:4], draws[:, 4:5], draws[:, 5:6]
    diffuse_ratio = 0.5 * (1.0 - m.metallic)
    trans_weight = (1.0 - m.metallic) * m.transmission

    def ggx_dir(alpha):
        # ggx_sample in tangent space; both lobes use the same (r1, r2)
        a = torch.clamp(alpha, min=0.001)
        phi = r1 * (2.0 * M_PI)
        cos_t = torch.sqrt((1.0 - r2) / (1.0 + (a * a - 1.0) * r2))
        sin_t = torch.clamp(torch.sqrt(1.0 - cos_t * cos_t), 0.0, 1.0)
        return _from_local(sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t, tangent, bitangent, n)

    # transmission (pbr_gltf.glsl:452-498)
    n2 = m.ior
    r0 = (1.0 - n2) / (1.0 + n2)
    r0 = r0 * r0
    h_t = ggx_dir(m.roughness)
    vdoth = _dot(v, h_t)
    f_refl = _f_schlick(r0, 1.0 - r0, vdoth)
    discriminant = 1.0 - eta * eta * (1.0 - vdoth * vdoth)
    thin_in = m.thinwalled & (_dot(n, normal) < 0.0)
    f_refl = torch.where(thin_in, 0.0, f_refl)
    discriminant = torch.where(thin_in, 0.0, discriminant)
    eta_t = torch.where(m.thinwalled, 1.0, eta)
    do_reflect = (discriminant < 0.0) | (u_reflect < f_refl)
    l_refl = _normalize(_reflect(-v, h_t))
    l_refr = _normalize(_refract(-v, h_t, eta_t))
    l_refr = torch.where(_dot(l_refr, l_refr) < 0.5, -v, l_refr)
    l_trans = torch.where(do_reflect, l_refl, l_refr)
    pdf_trans = torch.abs(_dot(n, l_trans))

    # diffuse: cosine hemisphere
    rs = torch.sqrt(r1)
    phi_d = (2.0 * M_PI) * r2
    dx = rs * torch.cos(phi_d)
    dy = rs * torch.sin(phi_d)
    dz = torch.sqrt(torch.clamp(1.0 - dx * dx - dy * dy, min=0.0))
    l_diff = _from_local(dx, dy, dz, tangent, bitangent, n)
    ndotl_d = _dot(n, l_diff)
    ndotv_r = _dot(n, v)
    valid_d = (ndotl_d >= 0.0) & (ndotv_r >= 0.0)
    pdf_d = torch.where(valid_d, torch.clamp(ndotl_d, 0.001, 1.0) * (1.0 / M_PI), 0.0)
    f_d = torch.where(valid_d, (1.0 - m.metallic) * (m.albedo * (1.0 / M_PI)), 0.0)
    pdf_d = pdf_d * diffuse_ratio  # subsurface is 0 in glTF

    # specular / clearcoat
    primary_spec_ratio = 1.0 / (1.0 + m.clearcoat)
    spec_ratio = 1.0 - diffuse_ratio
    use_primary = u_lobe < primary_spec_ratio
    h_s = ggx_dir(torch.where(use_primary, m.roughness, m.cc_rough))
    l_spec = _reflect(-v, h_s)
    ndotl_s = _dot(n, l_spec)
    valid_s = ndotl_s >= 0.0
    ndotl_c = torch.clamp(ndotl_s, 0.001, 1.0)
    ndotv = torch.clamp(torch.abs(ndotv_r), 0.001, 1.0)
    ndoth_u, ldoth_u, vdoth_u = _dot(n, h_s), _dot(l_spec, h_s), _dot(v, h_s)
    f0 = m.f0
    pdf_su, f_su = _spec_lobe(flags, m, f0, _f90(f0) - f0, v, l_spec, h_s, tangent, bitangent,
                              ndotl_c, ndotv, ndoth_u, ldoth_u, vdoth_u)
    pdf_s = torch.where(valid_s, pdf_su, 0.0) * primary_spec_ratio * spec_ratio
    f_s = torch.where(valid_s, f_su, 0.0)
    pdf_cu, f_cu = _clearcoat_lobe(m, ndotl_c, ndotv, ndoth_u, ldoth_u, vdoth_u)
    pdf_c = torch.where(valid_s, pdf_cu, 0.0) * (1.0 - primary_spec_ratio) * spec_ratio
    f_c = torch.where(valid_s, f_cu, 0.0)
    f_sc = torch.where(use_primary, f_s, f_c)
    pdf_sc = torch.where(use_primary, pdf_s, pdf_c)

    pick_diffuse = probability < diffuse_ratio
    l_brdf = torch.where(pick_diffuse, l_diff, l_spec)
    f_brdf = torch.where(pick_diffuse, f_d, f_sc) * (1.0 - trans_weight)
    pdf_brdf = torch.where(pick_diffuse, pdf_d, pdf_sc) * (1.0 - trans_weight)

    pick_trans = u_trans < trans_weight
    l_out = torch.where(pick_trans, l_trans, l_brdf)
    f_out = torch.where(pick_trans, m.albedo, f_brdf)
    pdf_out = torch.where(pick_trans, pdf_trans, pdf_brdf)
    if flags.full_mis:
        f_out, pdf_out = _pbr_eval_rows(flags, m, v, n, l_out, tangent, bitangent, eta)
    return f_out, l_out, pdf_out


# ---------------------------------------------------------------------------
# CUDA kernel: build at first use, bind through ctypes, launch.
# ---------------------------------------------------------------------------

_lib = None


def build(verbose: bool = False) -> str:
    """Compile ``csrc/shade.cu`` into ``_build/libshade.so`` when the library
    is missing or older than the source. Returns the library path."""
    return cuda_build.build("shade", "shade.cu", verbose=verbose)


_P = ctypes.c_void_p
_IN_PTRS = ("t", "u", "v", "tri", "inst", "origin", "direction", "radiance", "throughput",
            "absorption", "seed", "bsdf_pdf", "tdist", "active", "shade_rows", "tap_rows",
            "env_rows", "lights", "sun", "o2w", "w2o")
# The output fields, named as the dict keys but for the three that share an
# input's name.
_OUT_PTRS = tuple(k + "_out" if k in _IN_PTRS else k for k in _VEC_OUT + _COL_OUT) + (
    "tdist_out", "alive", "visible", "miss", "seed_out")


class _StageArgs(ctypes.Structure):
    """``csrc/shade.cu``'s StageArgs, field for field."""

    _fields_ = (
        [(k, _P) for k in _IN_PTRS]
        + [(k, ctypes.c_int64) for k in ("n_tap", "atlas_w", "env_h", "env_w", "n_lights")]
        + [(k, ctypes.c_float) for k in ("spread", "hdr_mult", "p_select", "p_light_n", "p_env",
                                         "env_step")]
        + [("n", ctypes.c_int64), ("flags", ctypes.c_int)]
        + [(k, _P) for k in _OUT_PTRS]
    )


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p = ctypes.c_void_p
        lib.vkrt_shade.argtypes = [p, p, p, ctypes.c_int64, ctypes.c_int, p, p, p, p]
        lib.vkrt_shade.restype = ctypes.c_int
        lib.vkrt_shade_body_smem.argtypes = [ctypes.c_int]
        lib.vkrt_shade_body_occupancy.argtypes = [ctypes.c_int]
        lib.vkrt_shade_stage.argtypes = [ctypes.POINTER(_StageArgs), p]
        lib.vkrt_shade_stage.restype = ctypes.c_int
        lib.vkrt_shade_stage_args_size.restype = ctypes.c_int
        size = lib.vkrt_shade_stage_args_size()
        if size != ctypes.sizeof(_StageArgs):
            raise RuntimeError(f"StageArgs: {size} bytes in the library, "
                               f"{ctypes.sizeof(_StageArgs)} in the binding")
        _lib = lib
    return _lib


def _check(name, x, shape, dtype, dev):
    if (x.device != dev or x.dtype != dtype or tuple(x.shape) != tuple(shape)
            or not x.is_contiguous()):
        raise ValueError(f"{name}: want contiguous {dtype} {tuple(shape)} on {dev}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    return x.data_ptr()


def _stage_cuda(*args):
    """One launch of ``vkrt_shade_stage`` (arguments as :func:`stage_args`'s);
    returns the epilogue's dict."""
    a, out = stage_args(*args)
    launch_stage(a, args[6].device)
    return out


def launch_stage(a: "_StageArgs", dev) -> None:
    """Launch ``vkrt_shade_stage`` on prepared arguments (nothing when it has
    no lanes) and count it."""
    if a.n == 0:  # nothing to launch, and so nothing to count
        return
    err = _load().vkrt_shade_stage(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"shade stage kernel launch failed: cudaError {err}")
    LAUNCHES["shade_stage"] += 1


def stage_args(tables: StageTables, flags: ShadeFlags, p_select_light, hdr_mult, spread, hit,
               st_origin, st_direction, seed, active, radiance, throughput, absorption,
               bsdf_pdf, tdist):
    """The kernel's checked arguments and its freshly allocated outputs:
    ``(_StageArgs, dict)``. ``tdist`` is the path length before this hit."""
    _load()
    dev = st_direction.device
    r = st_direction.shape[0]
    f32, i64 = torch.float32, torch.int64
    a = _StageArgs()
    for name, x, shape, dt in (
        ("t", hit.t, (r,), f32), ("u", hit.u, (r,), f32), ("v", hit.v, (r,), f32),
        ("tri", hit.tri, (r,), i64), ("origin", st_origin, (r, 3), f32),
        ("direction", st_direction, (r, 3), f32), ("radiance", radiance, (r, 3), f32),
        ("throughput", throughput, (r, 3), f32), ("absorption", absorption, (r, 3), f32),
        ("seed", seed, (r,), i64), ("tdist", tdist, (r,), f32),
        ("shade_rows", tables.shade_rows, (tables.shade_rows.shape[0], 128), f32),
        ("tap_rows", tables.tap_rows, (tables.tap_rows.shape[0], 4), torch.int32),
        ("env_rows", tables.env_rows, (tables.env_h * tables.env_w, 16), f32),
        ("lights", tables.lights, (tables.lights.shape[0], 16), f32),
        ("sun", tables.sun_lanes, (SUN_LANES,), f32),
    ):
        setattr(a, name, _check(name, x, shape, dt, dev))
    if flags.full_mis:
        a.bsdf_pdf = _check("bsdf_pdf", bsdf_pdf, (r,), f32, dev)
    if active is not None:
        a.active = _check("active", active, (r,), torch.bool, dev)
    if flags.instanced:
        a.inst = _check("inst", hit.inst, (r,), i64, dev)
        n_inst = tables.o2w.shape[0]
        a.o2w = _check("o2w", tables.o2w, (n_inst, 12), f32, dev)
        a.w2o = _check("w2o", tables.w2o, (n_inst, 12), f32, dev)
    if tables.tap_rows.data_ptr() % 16:
        raise ValueError("tap_rows: the kernel reads 16-byte rows, want a 16-byte aligned table")
    a.n_tap, a.atlas_w = tables.tap_rows.shape[0], tables.atlas_w
    a.env_h, a.env_w, a.n_lights = tables.env_h, tables.env_w, tables.n_lights
    p_light_sel = p_select_light if tables.n_lights > 0 else 0.0
    a.spread = float(spread) if spread is not None else 0.0
    a.hdr_mult = float(hdr_mult)
    a.p_select = float(p_select_light)
    a.p_light_n = p_light_sel / float(max(tables.n_lights, 1))
    a.p_env = 1.0 - p_light_sel
    a.env_step = math.pi / tables.env_h  # ops/env.py's step_theta
    a.n, a.flags = r, flags.bits()
    out = {k: torch.empty(r, 3, dtype=f32, device=dev) for k in _VEC_OUT}
    out.update({k: torch.empty(r, dtype=f32, device=dev) for k in _COL_OUT})
    for k in ("alive", "visible", "miss"):
        out[k] = torch.empty(r, dtype=torch.bool, device=dev)
    out["seed"] = torch.empty(r, dtype=i64, device=dev)
    out["tdist"] = torch.empty(r, dtype=f32, device=dev)
    for field, k in zip(_OUT_PTRS, (*_VEC_OUT, *_COL_OUT, "tdist", "alive", "visible", "miss",
                                    "seed")):
        setattr(a, field, out[k].data_ptr())
    return a, out


def _shade_cuda(srow, taps, aux, flags: ShadeFlags):
    lib = _load()
    r = srow.shape[0]
    dev = srow.device
    for name, x, shape, dt in (
        ("srow", srow, (r, 128), torch.float32),
        ("taps", taps, (r, 16), torch.int32),
        ("aux", aux, (r, aux_width(flags.instanced)), torch.float32),
    ):
        if x.device != dev or x.dtype != dt or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"{name}: want contiguous {dt} {shape} on {dev}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}"
            )
        if x.data_ptr() % 16:  # the kernel copies its rows in 16-byte pieces
            raise ValueError(f"{name}: the kernel reads 16-byte pieces, want a 16-byte "
                             f"aligned tensor")
    out_vec = torch.empty(r, OUT_W, dtype=torch.float32, device=dev)
    alive = torch.empty(r, dtype=torch.bool, device=dev)
    visible = torch.empty(r, dtype=torch.bool, device=dev)
    if r == 0:  # nothing to launch, and so nothing to count
        return out_vec, alive, visible
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.vkrt_shade(
        srow.data_ptr(), taps.data_ptr(), aux.data_ptr(), r, flags.bits(),
        out_vec.data_ptr(), alive.data_ptr(), visible.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"shade kernel launch failed: cudaError {err}")
    LAUNCHES["shade_bounce"] += 1
    return out_vec, alive, visible
