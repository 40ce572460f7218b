"""glTF metallic-roughness BSDF, eval + sample (counterpart of
``vk_raytrace_tpu/ops/bsdf_gltf.py``; ``PbrEval`` / ``PbrSample`` of
``shaders/pbr_gltf.glsl``). Branchless: every lobe is evaluated and the
choice is a ``torch.where`` mask, so every lane consumes the same draws."""

from __future__ import annotations

import math

import torch

from . import rng
from .math import dot, from_local, mix, normalize, reflect, refract
from .sampling import cosine_sample_hemisphere, ggx_sample

M_PI = math.pi
_1_PI = 1.0 / math.pi


def _sdiv(num, den, eps=1e-9):
    """Sign-preserving safe division."""
    safe = torch.where(torch.abs(den) < eps, torch.where(den < 0, -eps, eps), den)
    return num / safe


def _f_schlick(f0, f90, vdoth):
    return f0 + (f90 - f0) * torch.pow(torch.clamp(1.0 - vdoth, 0.0, 1.0), 5.0)


def _v_ggx(ndotl, ndotv, alpha):
    """Height-correlated Smith visibility (pbr_gltf.glsl:54-67)."""
    a2 = alpha * alpha
    ggxv = ndotl * torch.sqrt(ndotv * ndotv * (1.0 - a2) + a2)
    ggxl = ndotv * torch.sqrt(ndotl * ndotl * (1.0 - a2) + a2)
    ggx = ggxv + ggxl
    return torch.where(ggx > 0.0, 0.5 / torch.clamp(ggx, min=1e-12), 0.0)


def _v_ggx_aniso(ndotl, ndotv, bdotv, tdotv, tdotl, bdotl, at, ab):
    ggxv = ndotl * torch.sqrt((at * tdotv) ** 2 + (ab * bdotv) ** 2 + ndotv ** 2)
    ggxl = ndotv * torch.sqrt((at * tdotl) ** 2 + (ab * bdotl) ** 2 + ndotl ** 2)
    return torch.clamp(0.5 / torch.clamp(ggxv + ggxl, min=1e-12), 0.0, 1.0)


def _d_ggx(ndoth, alpha):
    a2 = alpha * alpha
    f = ndoth * ndoth * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(M_PI * f * f, min=1e-12)


def _d_ggx_aniso(ndoth, tdoth, bdoth, at, ab):
    a2 = at * ab
    f2 = (ab * tdoth) ** 2 + (at * bdoth) ** 2 + (a2 * ndoth) ** 2
    w2 = a2 / torch.clamp(f2, min=1e-20)
    return a2 * w2 * w2 / M_PI


def _spec_colors(state):
    f0 = state.mat.f0
    reflectance = torch.amax(f0, dim=-1)
    f90 = torch.clamp(reflectance * 50.0, 0.0, 1.0)[..., None] * torch.ones_like(f0)
    return f0, f90


def _eval_diffuse(state, f0, f90, v, n, l, h):
    ndotv = dot(n, v)
    ndotl = dot(n, l)
    valid = (ndotl >= 0.0) & (ndotv >= 0.0)
    pdf = torch.clamp(ndotl, 0.001, 1.0) * _1_PI
    f = (1.0 - state.mat.metallic)[..., None] * (state.mat.albedo * _1_PI)
    return torch.where(valid[..., None], f, 0.0), torch.where(valid, pdf, 0.0)


def _eval_specular(state, f0, f90, v, n, l, h):
    """Isotropic or anisotropic GGX lobe (pbr_gltf.glsl:225-284)."""
    ndotl = dot(n, l)
    valid = ndotl >= 0.0
    ndotl_c = torch.clamp(ndotl, 0.001, 1.0)
    ndotv = torch.clamp(torch.abs(dot(n, v)), 0.001, 1.0)
    ndoth = torch.clamp(dot(n, h), 0.0, 1.0)
    ldoth = torch.clamp(dot(l, h), 0.0, 1.0)
    vdoth = torch.clamp(dot(v, h), 0.0, 1.0)
    rough = state.mat.roughness

    pdf_iso = _d_ggx(ndoth, rough) * ndoth / torch.clamp(4.0 * ldoth, min=1e-9)
    f_iso = (
        _f_schlick(f0, f90, vdoth[..., None])
        * _v_ggx(ndotl_c, ndotv, rough)[..., None]
        * _d_ggx(ndoth, torch.clamp(rough, min=0.001))[..., None]
    )

    t, b = state.tangent, state.bitangent
    tdotv = torch.clamp(dot(t, v), 0.0, 1.0)
    bdotv = torch.clamp(dot(b, v), 0.0, 1.0)
    tdotl, bdotl = dot(t, l), dot(b, l)
    tdoth, bdoth = dot(t, h), dot(b, h)
    ndoth_u, ldoth_u = dot(n, h), dot(l, h)
    aniso = state.mat.anisotropy
    at = torch.clamp(rough * (1.0 + aniso), min=0.001)
    ab = torch.clamp(rough * (1.0 - aniso), min=0.001)
    pdf_a = _sdiv(_d_ggx_aniso(ndoth_u, tdoth, bdoth, at, ab), 4.0 * ldoth_u)
    at2 = torch.clamp(rough * (1.0 + aniso), min=0.00001)
    ab2 = torch.clamp(rough * (1.0 - aniso), min=0.00001)
    f_a = (
        _f_schlick(f0, f90, vdoth[..., None])
        * _v_ggx_aniso(ndotl_c, ndotv, bdotv, tdotv, tdotl, bdotl, at2, ab2)[..., None]
        * _d_ggx_aniso(ndoth_u, tdoth, bdoth, at2, ab2)[..., None]
    )
    use_aniso = aniso > 0.0
    pdf = torch.where(use_aniso, pdf_a, pdf_iso)
    f = torch.where(use_aniso[..., None], f_a, f_iso)
    return torch.where(valid[..., None], f, 0.0), torch.where(valid, pdf, 0.0)


def _eval_clearcoat(state, v, n, l, h):
    ndotl = dot(n, l)
    valid = ndotl >= 0.0
    ndotl_c = torch.clamp(ndotl, 0.001, 1.0)
    ndotv = torch.clamp(torch.abs(dot(n, v)), 0.001, 1.0)
    ndoth, vdoth, ldoth = dot(n, h), dot(v, h), dot(l, h)
    ccf = _f_schlick(0.04, 1.0, vdoth)
    cca = state.mat.clearcoat_roughness * state.mat.clearcoat_roughness
    g = _v_ggx(ndotl_c, ndotv, cca)
    d = _d_ggx(ndoth, torch.clamp(cca, min=0.001))
    pdf = d * ndoth / torch.clamp(4.0 * ldoth, min=1e-9)
    f = (ccf * d * g * state.mat.clearcoat)[..., None] * torch.ones(3, device=ndotl.device)
    return torch.where(valid[..., None], f, 0.0), torch.where(valid, pdf, 0.0)


def _eval_dielectric_refraction(state, v, n, l, h):
    """Simplified transmission: f = albedo, pdf = |NdotL|."""
    return state.mat.albedo, torch.abs(dot(n, l))


def pbr_eval(state, v, n, l):
    """``PbrEval`` (pbr_gltf.glsl:365-434): (f (R,3), pdf (R,))."""
    ndotl = dot(n, l)
    h = torch.where(
        (ndotl < 0.0)[..., None],
        normalize(l * (1.0 / state.eta)[..., None] + v),
        normalize(l + v),
    )
    h = torch.where(dot(n, h)[..., None] < 0.0, -h, h)
    m = state.mat
    diffuse_ratio = 0.5 * (1.0 - m.metallic)
    spec_ratio = 1.0 - diffuse_ratio
    primary_spec_ratio = 1.0 / (1.0 + m.clearcoat)
    trans_weight = (1.0 - m.metallic) * m.transmission

    bsdf, bsdf_pdf = _eval_dielectric_refraction(state, v, n, l, h)
    f0, f90 = _spec_colors(state)
    fd, pd = _eval_diffuse(state, f0, f90, v, n, l, h)
    fc, pc = _eval_clearcoat(state, v, n, l, h)
    fs, ps = _eval_specular(state, f0, f90, v, n, l, h)
    refl_side = ndotl > 0.0
    brdf = torch.where(refl_side[..., None], fd + fc + fs, 0.0)
    brdf_pdf = torch.where(
        refl_side,
        pd * diffuse_ratio
        + pc * (1.0 - primary_spec_ratio) * spec_ratio
        + ps * primary_spec_ratio * spec_ratio,
        0.0,
    )
    return mix(brdf, bsdf, trans_weight[..., None]), mix(brdf_pdf, bsdf_pdf, trans_weight)


def pbr_sample(state, v, n, seed, combined: bool = False):
    """``PbrSample`` (pbr_gltf.glsl:439-554): (f, L, pdf, seed'). Draws, in
    order: lobe probability, r1, r2, transmission, Fresnel, clearcoat.
    ``combined`` returns ``pbr_eval`` at the sampled direction (the
    full-MIS estimator)."""
    m = state.mat
    seed, probability = rng.rand(seed)
    diffuse_ratio = 0.5 * (1.0 - m.metallic)
    spec_ratio = 1.0 - diffuse_ratio
    trans_weight = (1.0 - m.metallic) * m.transmission
    seed, r1 = rng.rand(seed)
    seed, r2 = rng.rand(seed)
    seed, u_trans = rng.rand(seed)
    seed, u_reflect = rng.rand(seed)
    seed, u_lobe = rng.rand(seed)
    t, b = state.tangent, state.bitangent

    # transmission branch (pbr_gltf.glsl:452-498)
    eta = state.eta
    n2 = m.ior
    r0 = ((1.0 - n2) / (1.0 + n2)) ** 2
    h_t = from_local(ggx_sample(m.roughness, r1, r2), t, b, n)
    vdoth = dot(v, h_t)
    f_refl = _f_schlick(r0, torch.ones_like(r0), vdoth)
    discriminant = 1.0 - eta * eta * (1.0 - vdoth * vdoth)
    inside = dot(state.ffnormal, state.normal) < 0.0
    thin_in = m.thinwalled & inside
    f_refl = torch.where(thin_in, 0.0, f_refl)
    discriminant = torch.where(thin_in, 0.0, discriminant)
    eta_t = torch.where(m.thinwalled, 1.0, eta)
    do_reflect = (discriminant < 0.0) | (u_reflect < f_refl)
    l_refl = normalize(reflect(-v, h_t))
    l_refr = normalize(refract(-v, h_t, eta_t))
    bad = torch.sum(l_refr * l_refr, dim=-1) < 0.5
    l_refr = torch.where(bad[..., None], -v, l_refr)
    l_trans = torch.where(do_reflect[..., None], l_refl, l_refr)
    f_trans, pdf_trans = _eval_dielectric_refraction(state, v, n, l_trans, h_t)

    # reflection branch (pbr_gltf.glsl:499-551)
    f0, f90 = _spec_colors(state)
    l_diff = from_local(cosine_sample_hemisphere(r1, r2), t, b, n)
    h_diff = normalize(l_diff + v)
    f_d, pdf_d = _eval_diffuse(state, f0, f90, v, n, l_diff, h_diff)
    pdf_d = pdf_d * (1.0 - m.subsurface) * diffuse_ratio

    primary_spec_ratio = 1.0 / (1.0 + m.clearcoat)
    use_primary = u_lobe < primary_spec_ratio
    rough = torch.where(use_primary, m.roughness, m.clearcoat_roughness)
    h_s = from_local(ggx_sample(rough, r1, r2), t, b, n)
    l_spec = reflect(-v, h_s)
    f_s, pdf_s = _eval_specular(state, f0, f90, v, n, l_spec, h_s)
    pdf_s = pdf_s * primary_spec_ratio * spec_ratio
    f_c, pdf_c = _eval_clearcoat(state, v, n, l_spec, h_s)
    pdf_c = pdf_c * (1.0 - primary_spec_ratio) * spec_ratio
    f_sc = torch.where(use_primary[..., None], f_s, f_c)
    pdf_sc = torch.where(use_primary, pdf_s, pdf_c)

    pick_diffuse = probability < diffuse_ratio
    l_brdf = torch.where(pick_diffuse[..., None], l_diff, l_spec)
    f_brdf = torch.where(pick_diffuse[..., None], f_d, f_sc) * (1.0 - trans_weight)[..., None]
    pdf_brdf = torch.where(pick_diffuse, pdf_d, pdf_sc) * (1.0 - trans_weight)

    pick_trans = u_trans < trans_weight
    l_out = torch.where(pick_trans[..., None], l_trans, l_brdf)
    f_out = torch.where(pick_trans[..., None], f_trans, f_brdf)
    pdf_out = torch.where(pick_trans, pdf_trans, pdf_brdf)
    if combined:
        f_out, pdf_out = pbr_eval(state, v, n, l_out)
    return f_out, l_out, pdf_out, seed
