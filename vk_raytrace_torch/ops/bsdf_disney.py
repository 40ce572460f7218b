"""Disney 2015 principled BSDF, eval + sample (counterpart of
``vk_raytrace_tpu/ops/bsdf_disney.py``; ``DisneyEval`` / ``DisneySample`` of
``shaders/pbr_disney.glsl``).

Lobes: dielectric reflection and refraction (GTR2, dielectric Fresnel)
weighted by ``(1 - metallic) * transmission``; Burley diffuse with sheen;
the subsurface approximation (uniform hemisphere into the surface); the
anisotropic primary specular (GTR2 aniso, Smith GGX aniso); clearcoat (GTR1,
fixed 0.25 Smith roughness).

Branchless: every lane computes every lobe and the choice is a
``torch.where`` mask, so every lane consumes the same seven draws, in the
reference's order. Plain torch on the tensors' device; the reference keeps
Disney off its fused shading kernel, and so does the port.
"""

from __future__ import annotations

import math

import torch

from . import rng
from .math import dot, from_local, mix, normalize, reflect, refract
from .sampling import (
    cosine_sample_hemisphere,
    ggx_sample,
    gtr1_sample,
    gtr2_aniso_sample,
    uniform_sample_hemisphere,
)

PI = math.pi
_1_PI = 1.0 / math.pi
_1_2PI = 1.0 / (2.0 * math.pi)


def _sdiv(num, den, eps=1e-12):
    """Sign-preserving safe division: only the magnitude is guarded."""
    safe = torch.where(torch.abs(den) < eps, torch.where(den < 0, -eps, eps), den)
    return num / safe


def _schlick_weight(u):
    m = torch.clamp(1.0 - u, 0.0, 1.0)
    m2 = m * m
    return m2 * m2 * m


def _dielectric_fresnel(cos_i, eta):
    """(pbr_disney.glsl:123-137); 1 under total internal reflection."""
    sin2_t = eta * eta * (1.0 - cos_i * cos_i)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    rs = (eta * cos_t - cos_i) / torch.clamp(eta * cos_t + cos_i, min=1e-12)
    rp = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=1e-12)
    f = 0.5 * (rs * rs + rp * rp)
    return torch.where(sin2_t > 1.0, 1.0, f)


def _gtr1(ndoth, a):
    a_c = torch.clamp(a, 1e-4, 0.9999)
    a2 = a_c * a_c
    t = 1.0 + (a2 - 1.0) * ndoth * ndoth
    val = _sdiv(a2 - 1.0, PI * torch.log(a2) * t)
    return torch.where(a >= 1.0, _1_PI, val)


def _gtr2(ndoth, a):
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndoth * ndoth
    return a2 / torch.clamp(PI * t * t, min=1e-12)


def _gtr2_aniso(ndoth, hdotx, hdoty, ax, ay):
    a = hdotx / ax
    b = hdoty / ay
    c = a * a + b * b + ndoth * ndoth
    return 1.0 / torch.clamp(PI * ax * ay * c * c, min=1e-12)


def _smith_g(ndotv, alpha):
    a = alpha * alpha
    b = ndotv * ndotv
    return 1.0 / torch.clamp(ndotv + torch.sqrt(a + b - a * b), min=1e-12)


def _smith_g_aniso(ndotv, vdotx, vdoty, ax, ay):
    a = vdotx * ax
    b = vdoty * ay
    c = ndotv
    return 1.0 / torch.clamp(ndotv + torch.sqrt(a * a + b * b + c * c), min=1e-12)


def _tint_colors(state):
    """Cspec0 / Csheen (pbr_disney.glsl:426-431)."""
    cdlin = state.mat.albedo
    cdlum = 0.3 * cdlin[..., 0] + 0.6 * cdlin[..., 1] + 0.1 * cdlin[..., 2]
    ctint = torch.where(
        (cdlum > 0.0)[..., None], cdlin / torch.clamp(cdlum, min=1e-12)[..., None], 1.0
    )
    spec = state.mat.specular[..., None]
    tint = state.mat.specular_tint[..., None]
    cspec0 = mix(
        spec * 0.08 * mix(torch.ones_like(ctint), ctint, tint),
        cdlin,
        state.mat.metallic[..., None],
    )
    return cspec0, state.mat.sheen_color  # the reference uses sheenTint directly (:431)


def _eval_dielectric_reflection(state, v, n, l, h):
    """(pbr_disney.glsl:320-332)"""
    valid = dot(n, l) > 0.0
    rough = state.mat.roughness
    f = _dielectric_fresnel(dot(v, h), state.eta)
    d = _gtr2(dot(n, h), rough)
    pdf = _sdiv(d * dot(n, h) * f, 4.0 * dot(v, h))
    g = _smith_g(torch.abs(dot(n, l)), rough) * _smith_g(torch.abs(dot(n, v)), rough)
    fr = state.mat.albedo * (f * d * g)[..., None]
    return torch.where(valid[..., None], fr, 0.0), torch.where(valid, pdf, 0.0)


def _eval_dielectric_refraction(state, v, n, l, h):
    """(pbr_disney.glsl:336-347)"""
    rough = state.mat.roughness
    f = _dielectric_fresnel(torch.abs(dot(v, h)), state.eta)
    d = _gtr2(dot(n, h), rough)
    denom = dot(l, h) * state.eta + dot(v, h)
    denom2 = torch.clamp(denom * denom, min=1e-12)
    pdf = d * dot(n, h) * (1.0 - f) * torch.abs(dot(l, h)) / denom2
    g = _smith_g(torch.abs(dot(n, l)), rough) * _smith_g(torch.abs(dot(n, v)), rough)
    fr = state.mat.albedo * (
        (1.0 - f) * d * g * torch.abs(dot(v, h)) * torch.abs(dot(l, h))
        * 4.0 * state.eta * state.eta / denom2
    )[..., None]
    return fr, pdf


def _eval_specular(state, cspec0, v, n, l, h):
    """Anisotropic GTR2 lobe (pbr_disney.glsl:351-364)."""
    valid = dot(n, l) > 0.0
    t, b = state.tangent, state.bitangent
    ax, ay = state.mat.ax, state.mat.ay
    d = _gtr2_aniso(dot(n, h), dot(h, t), dot(h, b), ax, ay)
    pdf = _sdiv(d * dot(n, h), 4.0 * dot(v, h))
    fh = _schlick_weight(dot(l, h))
    f = mix(cspec0, torch.ones_like(cspec0), fh[..., None])
    g = _smith_g_aniso(dot(n, l), dot(l, t), dot(l, b), ax, ay)
    g = g * _smith_g_aniso(dot(n, v), dot(v, t), dot(v, b), ax, ay)
    fr = f * (d * g)[..., None]
    return torch.where(valid[..., None], fr, 0.0), torch.where(valid, pdf, 0.0)


def _eval_clearcoat(state, v, n, l, h):
    """(pbr_disney.glsl:368-380)"""
    valid = dot(n, l) > 0.0
    d = _gtr1(dot(n, h), state.mat.clearcoat_roughness)
    pdf = _sdiv(d * dot(n, h), 4.0 * dot(v, h))
    fh = _schlick_weight(dot(l, h))
    f = mix(0.04, 1.0, fh)
    quarter = torch.full_like(fh, 0.25)
    g = _smith_g(dot(n, l), quarter) * _smith_g(dot(n, v), quarter)
    fr = (0.25 * state.mat.clearcoat * f * d * g)[..., None] * torch.ones(3, device=fh.device)
    return torch.where(valid[..., None], fr, 0.0), torch.where(valid, pdf, 0.0)


def _eval_diffuse(state, csheen, v, n, l, h):
    """Burley diffuse + sheen (pbr_disney.glsl:384-398)."""
    m = state.mat
    valid = dot(n, l) > 0.0
    pdf = dot(n, l) * _1_PI
    fl = _schlick_weight(dot(n, l))
    fv = _schlick_weight(dot(n, v))
    fh = _schlick_weight(dot(l, h))
    ldoth = dot(l, h)
    fd90 = 0.5 + 2.0 * (ldoth * ldoth) * m.roughness
    fd = mix(1.0, fd90, fl) * mix(1.0, fd90, fv)
    fsheen = fh[..., None] * m.sheen_roughness[..., None] * csheen
    fr = (
        _1_PI * (fd * (1.0 - m.subsurface))[..., None] * m.albedo + fsheen
    ) * (1.0 - m.metallic)[..., None]
    return torch.where(valid[..., None], fr, 0.0), torch.where(valid, pdf, 0.0)


def _eval_subsurface(state, v, n, l):
    """Hanrahan-Krueger-style approximation (pbr_disney.glsl:402-410)."""
    m = state.mat
    pdf = torch.full_like(state.eta, _1_2PI)
    fl = _schlick_weight(torch.abs(dot(n, l)))
    fv = _schlick_weight(dot(n, v))
    fd = (1.0 - 0.5 * fl) * (1.0 - 0.5 * fv)
    fr = torch.sqrt(torch.clamp(m.albedo, min=0.0)) * (
        m.subsurface * _1_PI * fd * (1.0 - m.metallic) * (1.0 - m.transmission)
    )[..., None]
    return fr, pdf


def disney_eval(state, v, n, l):
    """``DisneyEval`` (pbr_disney.glsl:524-599): (f (R, 3), pdf (R,))."""
    ndotl = dot(n, l)
    h = torch.where(
        (ndotl < 0.0)[..., None],
        normalize(l * (1.0 / state.eta)[..., None] + v),
        normalize(l + v),
    )
    h = torch.where(dot(n, h)[..., None] < 0.0, -h, h)

    m = state.mat
    diffuse_ratio = 0.5 * (1.0 - m.metallic)
    primary_spec_ratio = 1.0 / (1.0 + m.clearcoat)
    trans_weight = (1.0 - m.metallic) * m.transmission

    # BSDF side
    f_refl, p_refl = _eval_dielectric_reflection(state, v, n, l, h)
    f_refr, p_refr = _eval_dielectric_refraction(state, v, n, l, h)
    below = ndotl < 0.0
    bsdf = torch.where(below[..., None], f_refr, f_refl)
    bsdf_pdf = torch.where(below, p_refr, p_refl)
    has_trans = trans_weight > 0.0
    bsdf = torch.where(has_trans[..., None], bsdf, 0.0)
    bsdf_pdf = torch.where(has_trans, bsdf_pdf, 0.0)

    # BRDF side
    cspec0, csheen = _tint_colors(state)
    f_ss, p_ss = _eval_subsurface(state, v, n, l)
    below_ss = below & (m.subsurface > 0.0)
    brdf_below = torch.where(below_ss[..., None], f_ss, 0.0)
    brdf_below_pdf = torch.where(below_ss, p_ss * m.subsurface * diffuse_ratio, 0.0)

    f_d, p_d = _eval_diffuse(state, csheen, v, n, l, h)
    f_s, p_s = _eval_specular(state, cspec0, v, n, l, h)
    f_c, p_c = _eval_clearcoat(state, v, n, l, h)
    brdf_above = f_d + f_s + f_c
    brdf_above_pdf = (
        p_d * (1.0 - m.subsurface) * diffuse_ratio
        + p_s * primary_spec_ratio * (1.0 - diffuse_ratio)
        + p_c * (1.0 - primary_spec_ratio) * (1.0 - diffuse_ratio)
    )

    brdf = torch.where(below[..., None], brdf_below, brdf_above)
    brdf_pdf = torch.where(below, brdf_below_pdf, brdf_above_pdf)
    has_brdf = trans_weight < 1.0
    brdf = torch.where(has_brdf[..., None], brdf, 0.0)
    brdf_pdf = torch.where(has_brdf, brdf_pdf, 0.0)

    return mix(brdf, bsdf, trans_weight[..., None]), mix(brdf_pdf, bsdf_pdf, trans_weight)


def disney_sample(state, v, n, seed, combined: bool = False):
    """``DisneySample`` (pbr_disney.glsl:414-520): ``(f (R, 3), L (R, 3),
    pdf (R,), is_subsurface (R,) bool, seed')``. Draws, in order: r1, r2,
    transmission, Fresnel, diffuse vs specular, subsurface, primary specular
    vs clearcoat. ``combined`` returns :func:`disney_eval` at the sampled
    direction (the full-MIS estimator)."""
    m = state.mat
    seed, r1 = rng.rand(seed)
    seed, r2 = rng.rand(seed)
    seed, u_trans = rng.rand(seed)
    seed, u_refl = rng.rand(seed)
    seed, u_diff = rng.rand(seed)
    seed, u_ss = rng.rand(seed)
    seed, u_lobe = rng.rand(seed)

    diffuse_ratio = 0.5 * (1.0 - m.metallic)
    trans_weight = (1.0 - m.metallic) * m.transmission
    cspec0, csheen = _tint_colors(state)
    t, b = state.tangent, state.bitangent

    # Transmission branch (pbr_disney.glsl:434-463)
    h_t = from_local(ggx_sample(m.roughness, r1, r2), t, b, n)
    r_dir = reflect(-v, h_t)
    f_fres = _dielectric_fresnel(torch.abs(dot(r_dir, h_t)), state.eta)
    inside = dot(state.ffnormal, state.normal) < 0.0
    f_fres = torch.where(m.thinwalled & inside, 0.0, f_fres)
    eta_eff = torch.where(m.thinwalled, 1.001, state.eta)
    state_t = state._replace(eta=eta_eff)

    do_reflect = u_refl < f_fres
    l_refl = normalize(r_dir)
    l_refr = normalize(refract(-v, h_t, eta_eff))
    bad = torch.sum(l_refr * l_refr, dim=-1) < 0.5  # TIR: refract() gave 0
    l_refr = torch.where(bad[..., None], l_refl, l_refr)
    fr_refl, pdf_refl = _eval_dielectric_reflection(state_t, v, n, l_refl, h_t)
    fr_refr, pdf_refr = _eval_dielectric_refraction(state_t, v, n, l_refr, h_t)
    l_bsdf = torch.where(do_reflect[..., None], l_refl, l_refr)
    f_bsdf = torch.where(do_reflect[..., None], fr_refl, fr_refr) * trans_weight[..., None]
    pdf_bsdf = torch.where(do_reflect, pdf_refl, pdf_refr) * trans_weight

    # Subsurface: diffuse transmission (:468-478)
    l_ss_loc = uniform_sample_hemisphere(r1, r2)
    l_ss = l_ss_loc[..., 0:1] * t + l_ss_loc[..., 1:2] * b - l_ss_loc[..., 2:3] * n
    f_ss, pdf_ss = _eval_subsurface(state, v, n, l_ss)
    pdf_ss = pdf_ss * m.subsurface * diffuse_ratio

    # Diffuse (:479-488)
    l_d = from_local(cosine_sample_hemisphere(r1, r2), t, b, n)
    h_d = normalize(l_d + v)
    f_d, pdf_d = _eval_diffuse(state, csheen, v, n, l_d, h_d)
    pdf_d = pdf_d * (1.0 - m.subsurface) * diffuse_ratio

    pick_ss = u_ss < m.subsurface
    l_diffuse = torch.where(pick_ss[..., None], l_ss, l_d)
    f_diffuse = torch.where(pick_ss[..., None], f_ss, f_d)
    pdf_diffuse = torch.where(pick_ss, pdf_ss, pdf_d)

    # Primary specular (:495-504)
    primary_spec_ratio = 1.0 / (1.0 + m.clearcoat)
    h_s = normalize(from_local(gtr2_aniso_sample(m.ax, m.ay, r1, r2), t, b, n))
    l_s = normalize(reflect(-v, h_s))
    f_s, pdf_s = _eval_specular(state, cspec0, v, n, l_s, h_s)
    pdf_s = pdf_s * primary_spec_ratio * (1.0 - diffuse_ratio)

    # Clearcoat (:505-513)
    h_c = from_local(gtr1_sample(m.clearcoat_roughness, r1, r2), t, b, n)
    l_c = normalize(reflect(-v, h_c))
    f_c, pdf_c = _eval_clearcoat(state, v, n, l_c, h_c)
    pdf_c = pdf_c * (1.0 - primary_spec_ratio) * (1.0 - diffuse_ratio)

    pick_primary = u_lobe < primary_spec_ratio
    l_spec = torch.where(pick_primary[..., None], l_s, l_c)
    f_spec = torch.where(pick_primary[..., None], f_s, f_c)
    pdf_spec = torch.where(pick_primary, pdf_s, pdf_c)

    pick_diffuse = u_diff < diffuse_ratio
    l_brdf = torch.where(pick_diffuse[..., None], l_diffuse, l_spec)
    f_brdf = torch.where(pick_diffuse[..., None], f_diffuse, f_spec) * (1.0 - trans_weight)[..., None]
    pdf_brdf = torch.where(pick_diffuse, pdf_diffuse, pdf_spec) * (1.0 - trans_weight)

    pick_trans = u_trans < trans_weight
    l_out = torch.where(pick_trans[..., None], l_bsdf, l_brdf)
    f_out = torch.where(pick_trans[..., None], f_bsdf, f_brdf)
    pdf_out = torch.where(pick_trans, pdf_bsdf, pdf_brdf)
    is_subsurface = ~pick_trans & pick_diffuse & pick_ss
    if combined:
        f_out, pdf_out = disney_eval(state, v, n, l_out)
    return f_out, l_out, pdf_out, is_subsurface, seed
