"""The port's Disney BSDF (``ops/bsdf_disney.py``) and the samplers and math
it adds (``ops/sampling.py``, ``ops/math.py``) against the reference, lane
for lane, on seeded states that reach every lobe: metal, glass (thick and
thin-walled, total internal reflection), clearcoat, sheen, subsurface and
anisotropy; then ``tests/test_bsdf.py``'s Disney properties on the port.

Tolerances. XLA on the CPU contracts multiply-adds into FMAs and torch
rounds each operation, and torch's CPU pow, sqrt and trigonometry are not
XLA's, so the two differ by float32 ulps, which the GTR1/GTR2 peaks and the
refraction denominator magnify. Both sides give NaN on the same lanes (a
thin-walled refraction that degenerates; the reference does so too), and
those lanes must match as NaN.

- The samplers and ``temperature``: rtol 1e-5 / atol 1e-5 (unit vectors;
  GTR1's pow moved one component of one lane of 4,096 by 2.1e-6).
- ``disney_eval``: f and pdf within rtol 1e-4 / atol 1e-6 on every lane.
- ``disney_sample``: the seeds exact; the lobe choice (is_subsurface, and
  the direction within rtol 1e-4) on every lane whose selector draws lie
  farther than 1e-5 from the thresholds the state fixes; f and pdf within
  rtol 1e-4 on 99.9% of those lanes and 1e-3 on all. The 1e-3: a
  thin-walled glass lane (eta 1.001) whose refraction denominator
  (l.h eta + v.h)^2 nearly vanishes, with pdf 8.8e5, differs by 4.9e-4.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401
from vk_raytrace_tpu.ops import bsdf_disney as ref_disney
from vk_raytrace_tpu.ops import math as ref_math
from vk_raytrace_tpu.ops import sampling as ref_sampling
from vk_raytrace_tpu.ops.state import MatState as RefMat, SurfState as RefSurf
from vk_raytrace_torch.ops import bsdf_disney as port_disney
from vk_raytrace_torch.ops import math as port_math
from vk_raytrace_torch.ops import rng as port_rng
from vk_raytrace_torch.ops import sampling as port_sampling
from vk_raytrace_torch.ops.state import MatState, SurfState

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 4096
RTOL, ATOL = 1e-4, 1e-6
SAMPLER_RTOL, SAMPLER_ATOL = 1e-5, 1e-5


def _unit(r, n):
    v = r.standard_normal((n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _state_arrays(seed=3, n=N):
    """Seeded surface states as numpy arrays: random frames, and materials
    from four families (plastic with sheen and subsurface, metal with
    anisotropy, glass thick and thin-walled, clearcoat over a partly
    metallic base), every continuous parameter random within its family."""
    r = np.random.default_rng(seed)
    kind = np.arange(n) % 4
    u = lambda lo, hi: r.uniform(lo, hi, n)  # noqa: E731
    normal = _unit(r, n)
    t = _unit(r, n)
    t = t - (t * normal).sum(1, keepdims=True) * normal
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    b = np.cross(normal, t)
    inside = r.random(n) < 0.25  # the ray arrives from inside the surface
    ffnormal = np.where(inside[:, None], -normal, normal)
    ior = u(1.2, 2.0)
    rough = np.maximum(u(0.0, 1.0), 0.001)
    aniso = np.where(kind == 1, u(0.0, 0.9), 0.0)
    aspect = np.sqrt(1.0 - aniso * 0.9)
    metallic = np.select([kind == 1, kind == 3], [np.ones(n), u(0.0, 0.6)], 0.0)
    arr = dict(
        albedo=r.uniform(0.05, 1.0, (n, 3)),
        metallic=metallic,
        roughness=rough,
        transmission=np.where(kind == 2, u(0.5, 1.0), 0.0),
        ior=ior,
        anisotropy=aniso,
        ax=np.maximum(rough / aspect, 0.001),
        ay=np.maximum(rough * aspect, 0.001),
        thinwalled=(kind == 2) & (r.random(n) < 0.3),
        clearcoat=np.where(kind == 3, u(0.2, 1.0), 0.0),
        clearcoat_roughness=np.maximum(u(0.0, 1.0), 0.001),
        sheen_color=np.where((kind == 0)[:, None], r.uniform(0.0, 1.0, (n, 3)), 0.0),
        sheen_roughness=np.where(kind == 0, u(0.0, 1.0), 0.0),
        specular=np.full(n, 0.5),
        specular_tint=u(0.0, 1.0),
        subsurface=np.where(kind == 0, u(0.0, 1.0), 0.0),
        normal=normal, ffnormal=ffnormal, tangent=t, bitangent=b,
        eta=np.where(inside, ior, 1.0 / ior),
    )
    return {k: (v if v.dtype == bool else v.astype(np.float32)) for k, v in arr.items()}


def _mat_fields(a):
    n = a["metallic"].shape[0]
    zeros3 = np.zeros((n, 3), np.float32)
    return dict(
        albedo=a["albedo"], metallic=a["metallic"], roughness=a["roughness"], f0=zeros3,
        alpha=np.ones(n, np.float32), emission=zeros3, transmission=a["transmission"],
        ior=a["ior"], unlit=np.zeros(n, bool), anisotropy=a["anisotropy"], ax=a["ax"],
        ay=a["ay"], attenuation_color=np.ones((n, 3), np.float32),
        attenuation_distance=np.ones(n, np.float32), thinwalled=a["thinwalled"],
        clearcoat=a["clearcoat"], clearcoat_roughness=a["clearcoat_roughness"],
        sheen_color=a["sheen_color"], sheen_roughness=a["sheen_roughness"],
        specular=a["specular"], specular_tint=a["specular_tint"], subsurface=a["subsurface"],
    )


def _surf_fields(a):
    n = a["metallic"].shape[0]
    return dict(
        position=np.zeros((n, 3), np.float32), normal=a["normal"], geom_normal=a["normal"],
        ffnormal=a["ffnormal"], tangent=a["tangent"], bitangent=a["bitangent"],
        tex_coord=np.zeros((n, 2), np.float32), eta=a["eta"],
    )


def ref_state(a):
    return RefSurf(**{k: jnp.asarray(v) for k, v in _surf_fields(a).items()},
                   mat=RefMat(**{k: jnp.asarray(v) for k, v in _mat_fields(a).items()}))


def port_state(a):
    return SurfState(**{k: torch.from_numpy(v) for k, v in _surf_fields(a).items()},
                     mat=MatState(**{k: torch.from_numpy(v) for k, v in _mat_fields(a).items()}))


@pytest.fixture(scope="module")
def lanes():
    """States, view directions (in the ffnormal hemisphere), light
    directions (over the sphere) and seeds."""
    a = _state_arrays()
    r = np.random.default_rng(9)
    v = _unit(r, N)
    v = np.where(((v * a["ffnormal"]).sum(1) < 0)[:, None], -v, v).astype(np.float32)
    l = _unit(r, N).astype(np.float32)
    seed = r.integers(0, 2**32, N, dtype=np.uint64)
    return a, v, l, seed


def _close(out, ref, rtol=RTOL, atol=ATOL, share=1.0, rtol_all=None):
    """Non-finite lanes equal; the rest within ``rtol`` on ``share`` of the
    lanes and within ``rtol_all`` (default ``rtol``) on all."""
    out, ref = np.asarray(out), np.asarray(ref)
    np.testing.assert_array_equal(np.isfinite(out), np.isfinite(ref))
    np.testing.assert_allclose(out, ref, rtol=rtol_all or rtol, atol=atol)
    close = np.isclose(out, ref, rtol=rtol, atol=atol, equal_nan=True)
    assert close.reshape(len(close), -1).all(-1).mean() >= share


# --- samplers and math ----------------------------------------------------


@pytest.mark.parametrize("name", [
    "uniform_sample_hemisphere", "uniform_sample_sphere", "gtr1_sample", "gtr2_aniso_sample",
])
def test_sampler_matches_reference(name):
    r = np.random.default_rng(5)
    r1, r2 = r.random(N, np.float32), r.random(N, np.float32)
    ax, ay = (np.maximum(r.random(N), 0.001).astype(np.float32) for _ in range(2))
    args = {"gtr1_sample": (ax,), "gtr2_aniso_sample": (ax, ay)}.get(name, ())
    ref = getattr(ref_sampling, name)(*map(jnp.asarray, args + (r1, r2)))
    out = getattr(port_sampling, name)(*map(torch.from_numpy, args + (r1, r2)))
    _close(out.numpy(), ref, SAMPLER_RTOL, SAMPLER_ATOL)


def test_to_local_and_temperature_match_reference(lanes):
    a, v, _, _ = lanes
    basis = [a[k] for k in ("tangent", "bitangent", "normal")]
    ref = ref_math.to_local(*map(jnp.asarray, [v] + basis))
    out = port_math.to_local(*map(torch.from_numpy, [v] + basis))
    _close(out.numpy(), ref, SAMPLER_RTOL, SAMPLER_ATOL)
    x = np.linspace(-0.2, 1.2, 1001, dtype=np.float32)
    _close(port_math.temperature(torch.from_numpy(x)).numpy(),
           ref_math.temperature(jnp.asarray(x)), SAMPLER_RTOL, SAMPLER_ATOL)


# --- disney_eval / disney_sample against the reference ---------------------


def test_states_reach_every_lobe(lanes):
    """The seeded states cover every lobe the eval and the sampler pick."""
    a, v, _, seed = lanes
    st = port_state(a)
    _, l, _, is_ss, _ = port_disney.disney_sample(st, torch.from_numpy(v),
                                                  torch.from_numpy(a["ffnormal"]),
                                                  port_rng.u32(torch.from_numpy(seed.astype(np.int64))))
    below = (l * torch.from_numpy(a["ffnormal"])).sum(-1) < 0.0
    kind = np.arange(N) % 4
    assert is_ss.any() and not is_ss[torch.from_numpy(kind != 0)].any()
    assert below[torch.from_numpy(kind == 2)].float().mean() > 0.2  # refraction
    assert a["thinwalled"].any() and (a["anisotropy"] > 0.5).any()


def test_disney_eval_matches_reference(lanes):
    a, v, l, _ = lanes
    n = a["ffnormal"]
    f_r, pdf_r = ref_disney.disney_eval(ref_state(a), *map(jnp.asarray, (v, n, l)))
    f_p, pdf_p = port_disney.disney_eval(port_state(a), *map(torch.from_numpy, (v, n, l)))
    assert float((np.asarray(pdf_r) > 0).mean()) > 0.5
    _close(f_p.numpy(), f_r)
    _close(pdf_p.numpy(), pdf_r)


def _selectors(a, seed):
    """The sampler's five selector draws and the thresholds they meet that
    the state alone fixes (the Fresnel threshold depends on the sampled
    half vector and is held by the direction comparison)."""
    s = port_rng.u32(torch.from_numpy(seed.astype(np.int64)))
    draws = []
    for _ in range(7):
        s, x = port_rng.rand(s)
        draws.append(x.numpy())
    _, _, u_trans, _, u_diff, u_ss, u_lobe = draws
    m = a["metallic"]
    return [
        (u_trans, (1.0 - m) * a["transmission"]),
        (u_diff, 0.5 * (1.0 - m)),
        (u_ss, a["subsurface"]),
        (u_lobe, 1.0 / (1.0 + a["clearcoat"])),
    ]


@pytest.mark.parametrize("combined", [False, True])
def test_disney_sample_matches_reference(lanes, combined):
    a, v, _, seed = lanes
    n = a["ffnormal"]
    f_r, l_r, pdf_r, ss_r, seed_r = ref_disney.disney_sample(
        ref_state(a), jnp.asarray(v), jnp.asarray(n), jnp.asarray(seed.astype(np.uint32)),
        combined=combined)
    f_p, l_p, pdf_p, ss_p, seed_p = port_disney.disney_sample(
        port_state(a), torch.from_numpy(v), torch.from_numpy(n),
        port_rng.u32(torch.from_numpy(seed.astype(np.int64))), combined=combined)
    np.testing.assert_array_equal(seed_p.numpy(), np.asarray(seed_r).astype(np.int64))
    near = np.zeros(N, bool)
    for x, thr in _selectors(a, seed):
        near |= np.abs(x - thr) <= 1e-5
    far = ~near
    assert far.mean() > 0.99
    np.testing.assert_array_equal(ss_p.numpy()[far], np.asarray(ss_r)[far])
    _close(l_p.numpy()[far], np.asarray(l_r)[far])
    _close(f_p.numpy()[far], np.asarray(f_r)[far], share=0.999, rtol_all=1e-3)
    _close(pdf_p.numpy()[far], np.asarray(pdf_r)[far], share=0.999, rtol_all=1e-3)


# --- tests/test_bsdf.py's Disney properties on the port ---------------------


def make_state(n, albedo=(0.8, 0.8, 0.8), metallic=0.0, roughness=0.5,
               transmission=0.0, clearcoat=0.0, sheen=0.0, anisotropy=0.0, ior=1.5):
    """Upward-facing surface (+z normal) replicated n times (the port's
    copy of ``tests/test_bsdf.py::make_state``)."""
    ones = torch.ones(n)
    alb = torch.tensor(albedo, dtype=torch.float32).expand(n, 3)
    rough = torch.clamp(ones * roughness, min=0.001)
    aspect = math.sqrt(1.0 - anisotropy * 0.9)
    mat = MatState(
        albedo=alb, metallic=ones * metallic, roughness=rough,
        f0=(0.04 * (1.0 - metallic) + alb * metallic) * torch.ones(n, 3), alpha=ones,
        emission=torch.zeros(n, 3), transmission=ones * transmission, ior=ones * ior,
        unlit=torch.zeros(n, dtype=torch.bool), anisotropy=ones * anisotropy,
        ax=torch.clamp(rough / aspect, min=0.001), ay=torch.clamp(rough * aspect, min=0.001),
        attenuation_color=torch.ones(n, 3), attenuation_distance=ones * 1e10,
        thinwalled=torch.zeros(n, dtype=torch.bool), clearcoat=ones * clearcoat,
        clearcoat_roughness=torch.clamp(ones * 0.3, min=0.001),
        sheen_color=torch.ones(n, 3) * sheen, sheen_roughness=ones * sheen,
        specular=ones * 0.5, specular_tint=ones, subsurface=torch.zeros(n),
    )
    up = torch.tensor([0.0, 0.0, 1.0]).expand(n, 3)
    return SurfState(
        position=torch.zeros(n, 3), normal=up, geom_normal=up, ffnormal=up,
        tangent=torch.tensor([1.0, 0.0, 0.0]).expand(n, 3),
        bitangent=torch.tensor([0.0, 1.0, 0.0]).expand(n, 3),
        tex_coord=torch.zeros(n, 2), eta=ones / ior, mat=mat,
    )


def view_dirs(n, seed=0, theta_max=1.2):
    r = np.random.default_rng(seed)
    th = r.uniform(0.05, theta_max, n)
    ph = r.uniform(0, 2 * np.pi, n)
    return torch.tensor(
        np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)], -1),
        dtype=torch.float32,
    )


def _seeds(n, key):
    return port_rng.tea(torch.arange(n), key)


def test_single_lobe_metal_matches():
    """Pure metal has the specular lobe alone: the sample's (f, pdf) equal
    eval's mixture at the sampled direction."""
    n = 4096
    state = make_state(n, metallic=1.0, roughness=0.4)
    v, nrm = view_dirs(n, seed=1), state.normal
    f_s, l, pdf_s, _, _ = port_disney.disney_sample(state, v, nrm, _seeds(n, 7))
    f_e, pdf_e = port_disney.disney_eval(state, v, nrm, l)
    m = ((pdf_s > 1e-3) & ((l * nrm).sum(-1) > 1e-3)).numpy()
    assert m.mean() > 0.5
    ps, pe = pdf_s.numpy()[m], pdf_e.numpy()[m]
    assert np.median(np.abs(ps - pe) / np.maximum(pe, 1e-3)) < 0.02
    fs, fe = f_s.numpy()[m], f_e.numpy()[m]
    assert np.median(np.abs(fs - fe).max(-1) / np.maximum(fe.max(-1), 1e-3)) < 0.02


@pytest.mark.parametrize("combined", [False, True])
def test_eval_pdf_covers_sampled_lobe(combined):
    """The mixture pdf at a sampled direction is at least the sampled lobe's
    (equal to it with ``combined``)."""
    n = 4096
    state = make_state(n, metallic=0.3, roughness=0.4, clearcoat=0.4)
    v, nrm = view_dirs(n, seed=1), state.normal
    _, l, pdf_s, _, _ = port_disney.disney_sample(state, v, nrm, _seeds(n, 7), combined=combined)
    _, pdf_e = port_disney.disney_eval(state, v, nrm, l)
    m = ((pdf_s > 1e-3) & ((l * nrm).sum(-1) > 1e-3)).numpy()
    ps, pe = pdf_s.numpy()[m], pdf_e.numpy()[m]
    assert (pe >= ps * 0.95).mean() > 0.98


def test_pdf_positive_when_f_positive():
    n = 2048
    state = make_state(n, metallic=0.0, roughness=0.3)
    f, pdf = port_disney.disney_eval(state, view_dirs(n, seed=2), state.normal, view_dirs(n, seed=3))
    f, pdf = f.numpy(), pdf.numpy()
    assert np.all(pdf[f.max(-1) > 1e-6] > 0.0)
    assert np.all(np.isfinite(f)) and np.all(np.isfinite(pdf))


@pytest.mark.parametrize("combined", [False, True])
@pytest.mark.parametrize("metallic,roughness", [(0.0, 0.8), (1.0, 0.3), (0.5, 0.5)])
def test_white_furnace_bound(metallic, roughness, combined):
    """Directional albedo of an albedo-1 material: finite and <= ~1."""
    n = 1 << 15
    state = make_state(n, albedo=(1.0, 1.0, 1.0), metallic=metallic, roughness=roughness)
    v = torch.tensor([0.3, 0.0, math.sqrt(1 - 0.09)]).expand(n, 3)
    f, l, pdf, _, _ = port_disney.disney_sample(state, v, state.normal, _seeds(n, 11),
                                                combined=combined)
    cos = torch.abs((l * state.normal).sum(-1))
    w = torch.where(pdf > 1e-6, f.amax(-1) * cos / torch.clamp(pdf, min=1e-6), 0.0)
    est = float(w.mean())
    assert np.isfinite(est) and est <= 1.35, est


def test_diffuse_furnace_close_to_albedo():
    n = 1 << 16
    state = make_state(n, albedo=(1.0, 1.0, 1.0), metallic=0.0, roughness=1.0)
    v = torch.tensor([0.0, 0.0, 1.0]).expand(n, 3)
    f, l, pdf, _, _ = port_disney.disney_sample(state, v, state.normal, _seeds(n, 13))
    cos = torch.abs((l * state.normal).sum(-1))
    est = float(torch.where(pdf > 1e-6, f[:, 0] * cos / torch.clamp(pdf, min=1e-6), 0.0).mean())
    assert 0.5 < est < 1.35, est


def test_glass_refracts():
    n = 1 << 14
    state = make_state(n, albedo=(1.0, 1.0, 1.0), metallic=0.0, roughness=0.05, transmission=1.0)
    v = torch.tensor([0.2, 0.0, math.sqrt(1 - 0.04)]).expand(n, 3)
    f, l, _, _, _ = port_disney.disney_sample(state, v, state.normal, _seeds(n, 17))
    assert float(((l * state.normal).sum(-1) < 0).float().mean()) > 0.5
    assert torch.isfinite(f).all()


def test_anisotropy_changes_lobe():
    n = 4096
    state_i = make_state(n, metallic=1.0, roughness=0.3, anisotropy=0.0)
    state_a = make_state(n, metallic=1.0, roughness=0.3, anisotropy=0.9)
    v = torch.tensor([0.5, 0.0, math.sqrt(0.75)]).expand(n, 3)
    l = view_dirs(n, seed=5)
    fi, _ = port_disney.disney_eval(state_i, v, state_i.normal, l)
    fa, _ = port_disney.disney_eval(state_a, v, state_a.normal, l)
    assert not np.allclose(fi.numpy(), fa.numpy(), rtol=1e-2)


# --- the transmission and clearcoat texture taps ---------------------------


def test_cold_texture_taps_match_reference():
    """``resolve_material`` with transmission, clearcoat and clearcoat-
    roughness textures (read from the atlas, not the tap rows) on the
    material grid, against the reference, at random hits; the shading
    tolerance of ``tests/test_torch_shade.py`` (rtol 1e-4 / atol 1e-5, a
    discrete texel choice on 99% of lanes)."""
    from vk_raytrace_tpu import render as ref_render
    from vk_raytrace_tpu.integrator import shade as ref_shade
    from vk_raytrace_tpu.models import procedural as ref_proc
    from vk_raytrace_tpu.models.schema import make_materials
    from vk_raytrace_tpu.models.textures import AtlasBuilder
    from vk_raytrace_torch.convert import from_reference
    from vk_raytrace_torch.integrator import shade as port_shade

    g, _, l, c = ref_proc.material_test_grid(n=2)
    r = np.random.default_rng(4)
    atlas = AtlasBuilder()
    t0 = atlas.add(r.integers(0, 256, (16, 16, 4), dtype=np.uint8), {})
    t1 = atlas.add(r.integers(0, 256, (8, 32, 4), dtype=np.uint8), {"wrapS": 33071})
    rows = [dict(base_color_factor=[0.8, 0.5, 0.4, 1.0], transmission_factor=0.9,
                 transmission_texture=t0 if k % 2 else -1, clearcoat_factor=0.8,
                 clearcoat_texture=t1, clearcoat_roughness=0.6,
                 clearcoat_roughness_texture=t0 if k < 3 else -1, roughness_factor=0.4)
            for k in range(5)]
    scene = ref_render.build_scene(g, make_materials(rows), l, c, atlas=atlas.build())
    port, _ = from_reference(scene)
    port = port.to("cpu")
    feats = ref_shade.mat_features(scene.materials)
    assert feats.transmission_tex and feats.clearcoat_tex
    n = 2048
    tri = r.integers(0, len(np.asarray(scene.geometry.indices)), n)
    w = r.dirichlet(np.ones(3), n).astype(np.float32)
    d = _unit(r, n).astype(np.float32)
    ss_r = ref_shade.get_shade_state(scene.geometry, jnp.asarray(tri, jnp.int32),
                                     jnp.asarray(w[:, 1]), jnp.asarray(w[:, 2]),
                                     shade_rows=jnp.asarray(scene.shade_rows))
    ss_p = port_shade.get_shade_state(port.shade_rows, torch.from_numpy(tri),
                                      torch.from_numpy(w[:, 1]), torch.from_numpy(w[:, 2]))
    st_r = ref_shade.resolve_material(ss_r, scene.materials, scene.atlas, jnp.asarray(d),
                                      features=feats, tap_rows=jnp.asarray(scene.tap_rows))
    st_p = port_shade.resolve_material(ss_p, port.atlas, torch.from_numpy(d),
                                       features=port_shade.mat_features(port.materials),
                                       tap_rows=port.tap_rows)
    for name in ("transmission", "clearcoat", "clearcoat_roughness"):
        out, ref = getattr(st_p.mat, name).numpy(), np.asarray(getattr(st_r.mat, name))
        assert np.isclose(out, ref, rtol=1e-4, atol=1e-5).mean() >= 0.99, name
        assert ref.std() > 0.01, name  # the textures were sampled
