"""Hit shading state + material resolve (counterpart of
``vk_raytrace_tpu/integrator/shade.py``).

Host side (numpy): the per-triangle shade rows, 128 f32 lanes that carry
the triangle's vertices, packed normals/tangents/colors, uvs and its
60-lane material row, and the scene's texture-feature flags. Device side
(torch): ``get_shade_state`` reconstructs the hit from ONE row gather and
``resolve_material`` resolves the glTF material with footprint-row texture
taps and ray-cone mip selection.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.math import (
    cross, dot, make_coordinate_system, mat3_vec, mat3t_vec, normalize, oct_decode, srgb_to_linear,
)
from ..ops.state import MatState, SurfState
from ..ops.texture import sample_atlas

# Packed material row layout: (name, lane count).
_TEX = ["base", "mr", "normal", "emissive"]
_LAYOUT = [
    ("uvT", 6),
    *[(f"{t}_tex", 8) for t in _TEX],  # id, ox, oy, w, h, ws*3+wt, mip_x, mip_y
    ("emissive_factor", 3),
    ("normal_scale", 1),
    ("ior", 1),
    ("rough_f", 1),
    ("metal_f", 1),
    ("base_factor", 4),
    ("transmission_f", 1),
    ("transmission_tid", 1),
    ("unlit", 1),
    ("aniso", 1),
    ("aniso_dir", 3),
    ("atten_color", 3),
    ("atten_dist", 1),
    ("thickness", 1),
    ("cc_f", 1),
    ("cc_tid", 1),
    ("cc_rough", 1),
    ("cc_rough_tid", 1),
    ("sheen_color", 3),
    ("sheen_rough", 1),
]
_OFFS = {}
_cursor = 0
for _name, _n in _LAYOUT:
    _OFFS[_name] = _cursor
    _cursor += _n
_PACK_LANES = _cursor  # 60


def pack_material_rows(m, atlas) -> np.ndarray:
    """(M, 60) f32 packed material rows (host numpy)."""
    x, y = np.asarray(atlas.x), np.asarray(atlas.y)
    w, h = np.asarray(atlas.width), np.asarray(atlas.height)
    ws, wt = np.asarray(atlas.wrap_s), np.asarray(atlas.wrap_t)

    def tex(tex_id):
        tex_id = np.asarray(tex_id)
        tid = np.clip(tex_id, 0, len(x) - 1)
        if atlas.mip_x is not None:
            mx = np.asarray(atlas.mip_x)[tid]
            my = np.asarray(atlas.mip_y)[tid]
        else:
            mx = my = np.full(tid.shape, -1.0)
        return [tex_id, x[tid], y[tid], w[tid], h[tid], ws[tid] * 3 + wt[tid], mx, my]

    t = np.asarray(m.uv_transform)
    a = lambda v: np.asarray(v)
    ef, bf = a(m.emissive_factor), a(m.base_color_factor)
    ad, ac, sc = a(m.anisotropy_direction), a(m.attenuation_color), a(m.sheen_color)
    cols = [
        t[:, 0, 0], t[:, 0, 1], t[:, 1, 0], t[:, 1, 1], t[:, 2, 0], t[:, 2, 1],
        *tex(m.base_color_texture),
        *tex(m.metallic_roughness_texture),
        *tex(m.normal_texture),
        *tex(m.emissive_texture),
        ef[:, 0], ef[:, 1], ef[:, 2],
        m.normal_texture_scale, m.ior, m.roughness_factor, m.metallic_factor,
        bf[:, 0], bf[:, 1], bf[:, 2], bf[:, 3],
        m.transmission_factor, m.transmission_texture, m.unlit, m.anisotropy,
        ad[:, 0], ad[:, 1], ad[:, 2],
        ac[:, 0], ac[:, 1], ac[:, 2],
        m.attenuation_distance, m.thickness_factor,
        m.clearcoat_factor, m.clearcoat_texture,
        m.clearcoat_roughness, m.clearcoat_roughness_texture,
        sc[:, 0], sc[:, 1], sc[:, 2],
        m.sheen_roughness,
    ]
    return np.stack([np.asarray(c).astype(np.float32) for c in cols], axis=1)


def build_shade_rows(geom, materials, atlas) -> np.ndarray:
    """(T, 128) f32 per-triangle rows. Lanes: [0:9] p0 p1 p2 | [9:12] n oct
    lo x3 | [12:15] n oct hi x3 | [15:18] t oct lo | [18:21] t oct hi |
    [21] handedness(v0) | [22:28] uv x3 | [28:31] color lo | [31:34] color
    hi | [34] mat_id | [35:40] pad | [40:100] material row | pad. The u32
    fields ride as exact-f32 16-bit halves."""
    idx = np.asarray(geom.indices).astype(np.int64)
    pos = np.asarray(geom.positions)
    nrm = np.asarray(geom.normals).astype(np.uint32)
    tan = np.asarray(geom.tangents).astype(np.uint32)
    uv = np.asarray(geom.uv)
    col = np.asarray(geom.color).astype(np.uint32)
    t = len(idx)
    rows = np.zeros((t, 40), np.float32)
    rows[:, 0:9] = pos[idx].reshape(t, 9)
    n3, t3, c3 = nrm[idx], tan[idx], col[idx]
    rows[:, 9:12] = (n3 & 0xFFFF).astype(np.float32)
    rows[:, 12:15] = (n3 >> 16).astype(np.float32)
    rows[:, 15:18] = (t3 & 0xFFFF).astype(np.float32)
    rows[:, 18:21] = (t3 >> 16).astype(np.float32)
    rows[:, 21] = np.asarray(geom.tangent_handedness)[idx[:, 0]]
    rows[:, 22:28] = uv[idx].reshape(t, 6)
    rows[:, 28:31] = (c3 & 0xFFFF).astype(np.float32)
    rows[:, 31:34] = (c3 >> 16).astype(np.float32)
    tri_mat = np.maximum(np.asarray(geom.tri_material), 0)
    rows[:, 34] = tri_mat
    mrows = pack_material_rows(materials, atlas)
    rows = np.concatenate([rows, mrows[np.minimum(tri_mat, len(mrows) - 1)]], axis=1)
    return np.pad(rows, ((0, 0), (0, 128 - rows.shape[1]))).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class MatFeatures:
    """Per-scene texture/feature presence; absent features are skipped."""

    base_tex: bool = True
    mr_tex: bool = True
    normal_tex: bool = True
    emissive_tex: bool = True
    transmission_tex: bool = True
    clearcoat_tex: bool = True
    anisotropy: bool = True


def mat_features(materials) -> MatFeatures:
    def anytex(a):
        return bool(np.any(np.asarray(a) >= 0))

    m = materials
    return MatFeatures(
        base_tex=anytex(m.base_color_texture),
        mr_tex=anytex(m.metallic_roughness_texture),
        normal_tex=anytex(m.normal_texture),
        emissive_tex=anytex(m.emissive_texture),
        transmission_tex=anytex(m.transmission_texture),
        clearcoat_tex=anytex(m.clearcoat_texture) or anytex(m.clearcoat_roughness_texture),
        anisotropy=bool(np.any(np.asarray(m.anisotropy) > 0.0)),
    )


def _unpack_rgba8(c):
    c = c.long()
    return torch.stack(
        [(c & 0xFF), (c >> 8) & 0xFF, (c >> 16) & 0xFF, (c >> 24) & 0xFF], dim=-1
    ).float() * (1.0 / 255.0)


def _join16(lo, hi):
    return lo.long() | (hi.long() << 16)


def _interp(bary, attr):
    """sum_k bary[:, k] * attr[:, k, :]"""
    return bary[:, 0:1] * attr[:, 0] + bary[:, 1:2] * attr[:, 1] + bary[:, 2:3] * attr[:, 2]


def get_shade_state(shade_rows, tri, u, v, instances=None, inst=None) -> dict:
    """Interpolated hit attributes (shade_state.glsl:63-145) from one shade
    row gather per lane; ``tri`` < 0 lanes read row 0 (callers mask). In a
    two-level scene the rows are object space: ``instances`` (the
    ``InstanceTable``) and the hits' ``inst`` bring position and tangent
    through object-to-world, the normals through world-to-object transposed,
    and the triangle's world area for the ray-cone footprint."""
    row = shade_rows[torch.clamp(tri, min=0)]
    w = 1.0 - u - v
    bary = torch.stack([w, u, v], dim=-1)
    p = row[:, 0:9].reshape(-1, 3, 3)
    n_pk = _join16(row[:, 9:12], row[:, 12:15])
    t_pk = _join16(row[:, 15:18], row[:, 18:21])
    handed = row[:, 21]
    uv3 = row[:, 22:28].reshape(-1, 3, 2)
    c_pk = _join16(row[:, 28:31], row[:, 31:34])

    position = _interp(bary, p)
    normal = normalize(_interp(bary, oct_decode(n_pk)))
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    geom_normal = normalize(cross(e1, e2))
    tangent = normalize(_interp(bary, oct_decode(t_pk)))
    if instances is not None:
        ii = torch.clamp(inst, min=0)
        o2w = instances.object_to_world[ii]
        w2o = instances.world_to_object[ii]
        position = mat3_vec(o2w, position) + o2w[:, :, 3]
        normal = normalize(mat3t_vec(w2o, normal))
        geom_normal = normalize(mat3t_vec(w2o, geom_normal))
        tangent = normalize(mat3_vec(o2w, tangent))
        e1, e2 = mat3_vec(o2w, e1), mat3_vec(o2w, e2)
    tangent = normalize(tangent - dot(tangent, normal, keepdim=True) * normal)
    bitangent = cross(normal, tangent) * handed[..., None]
    uv = _interp(bary, uv3)
    color = _interp(bary, _unpack_rgba8(c_pk))

    # Triangle uv density 0.5*log2(uv_area / world_area): the texture-
    # independent half of the ray-cone mip term.
    area_w = torch.linalg.norm(cross(e1, e2), dim=-1)
    u1 = uv3[:, 1] - uv3[:, 0]
    u2 = uv3[:, 2] - uv3[:, 0]
    area_uv = torch.abs(u1[:, 0] * u2[:, 1] - u1[:, 1] * u2[:, 0])
    uv_density = 0.5 * torch.log2(
        torch.clamp(area_uv, min=1e-20) / torch.clamp(area_w, min=1e-20)
    )
    flip = dot(normal, geom_normal) <= 0.0
    normal = torch.where(flip[..., None], -normal, normal)
    return dict(
        position=position, normal=normal, geom_normal=geom_normal,
        tangent=tangent, bitangent=bitangent, uv=uv, color=color[..., :3],
        uv_density=uv_density, prow=row[:, 40:40 + _PACK_LANES],
    )


def _col(prow, name, n=1):
    o = _OFFS[name]
    return prow[:, o] if n == 1 else prow[:, o:o + n]


def _mip_lanes(prow, o, lod):
    """Per-lane mip level (nearest) and its placement from the 8 packed
    texture lanes; level 0 is the base placement."""
    w0 = torch.clamp(prow[:, o + 3].long(), min=1)
    h0 = torch.clamp(prow[:, o + 4].long(), min=1)
    ox0 = prow[:, o + 1].long()
    oy0 = prow[:, o + 2].long()
    mx = prow[:, o + 6].long()
    my = prow[:, o + 7].long()
    wf, hf = w0.float(), h0.float()
    n_lvl = torch.floor(torch.log2(torch.clamp(torch.minimum(wf, hf), min=1.0)) + 1e-4).long()
    t00, t01 = prow[:, _OFFS["uvT"]], prow[:, _OFFS["uvT"] + 1]
    t10, t11 = prow[:, _OFFS["uvT"] + 2], prow[:, _OFFS["uvT"] + 3]
    det = torch.abs(t00 * t11 - t01 * t10)
    lam = lod + 0.5 * torch.log2(wf * hf) + 0.5 * torch.log2(torch.clamp(det, min=1e-20))
    lvl = torch.minimum(torch.clamp(torch.round(lam).long(), min=0), n_lvl)
    lvl = torch.where(mx >= 0, lvl, 0)
    oxl = mx + w0 - (w0 >> torch.clamp(lvl - 1, min=0))
    wl = torch.clamp(w0 >> lvl, min=1)
    hl = torch.clamp(h0 >> lvl, min=1)
    base = lvl == 0
    return (
        torch.where(base, ox0, oxl), torch.where(base, oy0, my),
        torch.where(base, w0, wl), torch.where(base, h0, hl),
    )


def _axis_base(p, size, mode):
    """One bilinear axis reduced to (base texel, weight) against the
    footprint rows, per wrap mode (REPEAT / CLAMP / MIRROR)."""
    sf = size.float()
    i0 = torch.floor(p).long()
    f = p - i0.float()
    b_rep = torch.remainder(i0, size)
    pc = torch.minimum(torch.clamp(p, min=0.0), sf - 1.0)
    b_clm = torch.minimum(torch.clamp(torch.floor(pc).long(), min=0), torch.clamp(size - 2, min=0))
    g_clm = pc - b_clm.float()
    m2 = torch.remainder(i0, 2 * size)
    asc = m2 < size
    xw = torch.where(asc, m2, 2 * size - 1 - m2)
    b_mir = torch.where(asc, xw, torch.clamp(xw - 1, min=0))
    g_mir = torch.where(asc, f, torch.where(xw > 0, 1.0 - f, 0.0))
    b = torch.where(mode == 0, b_rep, torch.where(mode == 1, b_clm, b_mir))
    g = torch.where(mode == 0, f, torch.where(mode == 1, g_clm, g_mir))
    return b, g


def _tap_footprint(atlas, tap_rows, prow, name, uv, srgb=False, lod=None):
    """Bilinear tap as ONE footprint-row gather."""
    o = _OFFS[name]
    tid = prow[:, o]
    if lod is not None:
        ox, oy, w, h = _mip_lanes(prow, o, lod)
    else:
        ox = prow[:, o + 1].long()
        oy = prow[:, o + 2].long()
        w = torch.clamp(prow[:, o + 3].long(), min=1)
        h = torch.clamp(prow[:, o + 4].long(), min=1)
    wrap = prow[:, o + 5].long()
    ws, wt = wrap // 3, wrap % 3
    px = uv[..., 0] * w.float() - 0.5
    py = uv[..., 1] * h.float() - 0.5
    bx, gx = _axis_base(px, w, ws)
    by, gy = _axis_base(py, h, wt)
    aw = atlas.data.shape[1]
    row = tap_rows[(oy + by) * aw + (ox + bx)]
    c00, c10 = _unpack_rgba8(row[:, 0]), _unpack_rgba8(row[:, 1])
    c01, c11 = _unpack_rgba8(row[:, 2]), _unpack_rgba8(row[:, 3])
    gx, gy = gx[..., None], gy[..., None]
    top = c00 + (c10 - c00) * gx
    bot = c01 + (c11 - c01) * gx
    out = top + (bot - top) * gy
    if srgb:
        out = torch.cat([srgb_to_linear(out[..., :3]), out[..., 3:4]], dim=-1)
    return torch.where((tid < 0.0)[..., None], torch.ones_like(out), out)


def resolve_material(ss, atlas, ray_dir, features=None, tap_rows=None, lod=None) -> SurfState:
    """``GetMaterialsAndTextures`` (gltf_material.glsl:105-193)."""
    if features is None:
        features = MatFeatures()
    prow = ss["prow"]

    def tap(name, uv, srgb=False):
        if tap_rows is None:
            raise ValueError("textured materials need the scene's tap rows")
        return _tap_footprint(atlas, tap_rows, prow, name, uv, srgb=srgb, lod=lod)

    ones4 = torch.ones(prow.shape[:1] + (4,), device=prow.device)
    uvt = _col(prow, "uvT", 6)
    su, sv = ss["uv"][..., 0], ss["uv"][..., 1]
    uv = torch.stack(
        [su * uvt[:, 0] + sv * uvt[:, 2] + uvt[:, 4], su * uvt[:, 1] + sv * uvt[:, 3] + uvt[:, 5]],
        dim=-1,
    )
    normal, tangent, bitangent = ss["normal"], ss["tangent"], ss["bitangent"]
    ffnormal = torch.where(dot(normal, ray_dir, keepdim=True) <= 0.0, normal, -normal)

    if features.normal_tex:
        nscale = _col(prow, "normal_scale")
        nvec = normalize(tap("normal_tex", uv)[..., :3] * 2.0 - 1.0)
        nvec = nvec * torch.stack([nscale, nscale, torch.ones_like(nscale)], dim=-1)
        mapped = normalize(
            nvec[..., 0:1] * tangent + nvec[..., 1:2] * bitangent + nvec[..., 2:3] * normal
        )
        has_nmap = (_col(prow, "normal_tex") >= 0.0)[..., None]
        normal = torch.where(has_nmap, mapped, normal)
        ffnormal = torch.where(dot(normal, ray_dir, keepdim=True) <= 0.0, normal, -normal)
        t2, b2 = make_coordinate_system(ffnormal)
        tangent = torch.where(has_nmap, t2, tangent)
        bitangent = torch.where(has_nmap, b2, bitangent)

    emission = _col(prow, "emissive_factor", 3)
    if features.emissive_tex:
        emission = emission * tap("emissive_tex", uv, srgb=True)[..., :3]

    ior = _col(prow, "ior")
    dielectric_spec = ((ior - 1.0) / (ior + 1.0)) ** 2
    mr = tap("mr_tex", uv) if features.mr_tex else ones4
    roughness = mr[..., 1] * _col(prow, "rough_f")
    metallic = mr[..., 2] * _col(prow, "metal_f")
    base = _col(prow, "base_factor", 4) * (
        tap("base_tex", uv, srgb=True) if features.base_tex else ones4
    )
    f0 = (
        dielectric_spec[..., None] * (1.0 - metallic[..., None])
        + base[..., :3] * metallic[..., None]
    )
    albedo = base[..., :3]
    roughness = torch.clamp(roughness, min=0.001)

    transmission = _col(prow, "transmission_f")
    if features.transmission_tex:
        # The cold textures read the atlas itself, not the tap rows
        # (gltf_material.glsl:144-149).
        ttid = _col(prow, "transmission_tid").long()
        transmission = transmission * torch.where(
            ttid >= 0, sample_atlas(atlas, ttid, uv)[..., 0], 1.0
        )
    eta = torch.where(dot(normal, ffnormal) > 0.0, 1.0 / ior, ior)
    unlit = _col(prow, "unlit") == 1.0

    anisotropy = _col(prow, "aniso")
    aspect = torch.sqrt(1.0 - anisotropy * 0.9)
    ax = torch.clamp(roughness / aspect, min=0.001)
    ay = torch.clamp(roughness * aspect, min=0.001)
    if features.anisotropy:
        adir = _col(prow, "aniso_dir", 3)
        t_rot = normalize(
            adir[..., 0:1] * tangent + adir[..., 1:2] * bitangent + adir[..., 2:3] * normal
        )
        b_rot = normalize(cross(normal, t_rot))
        has_aniso = (anisotropy > 0.0)[..., None]
        tangent = torch.where(has_aniso, t_rot, tangent)
        bitangent = torch.where(has_aniso, b_rot, bitangent)

    clearcoat = _col(prow, "cc_f")
    ccr = _col(prow, "cc_rough")
    if features.clearcoat_tex:  # gltf_material.glsl:176-188
        cctid = _col(prow, "cc_tid").long()
        clearcoat = clearcoat * torch.where(
            cctid >= 0, sample_atlas(atlas, cctid, uv)[..., 0], 1.0
        )
        ccrtid = _col(prow, "cc_rough_tid").long()
        ccr = ccr * torch.where(ccrtid >= 0, sample_atlas(atlas, ccrtid, uv)[..., 1], 1.0)
    ccr = torch.clamp(ccr, min=0.001)

    mat = MatState(
        albedo=albedo * ss["color"],
        metallic=metallic,
        roughness=roughness,
        f0=f0,
        alpha=base[..., 3],
        emission=emission,
        transmission=transmission,
        ior=ior,
        unlit=unlit,
        anisotropy=anisotropy,
        ax=ax,
        ay=ay,
        attenuation_color=_col(prow, "atten_color", 3),
        attenuation_distance=_col(prow, "atten_dist"),
        thinwalled=_col(prow, "thickness") == 0.0,
        clearcoat=clearcoat,
        clearcoat_roughness=ccr,
        sheen_color=_col(prow, "sheen_color", 3),
        sheen_roughness=_col(prow, "sheen_rough"),
        specular=torch.full_like(metallic, 0.5),
        specular_tint=torch.ones_like(metallic),
        subsurface=torch.zeros_like(metallic),
    )
    return SurfState(
        position=ss["position"], normal=normal, geom_normal=ss["geom_normal"],
        ffnormal=ffnormal, tangent=tangent, bitangent=bitangent, tex_coord=uv,
        eta=eta, mat=mat,
    )
