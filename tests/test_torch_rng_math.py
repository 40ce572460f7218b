"""RNG, vector math and samplers of the port against the reference.

RNG: integer arithmetic, so bit-exact. Math: float32 on both sides,
rtol 1e-6 / atol 1e-6 (a few ulp: XLA on the CPU contracts multiply-adds
into FMAs, torch rounds every operation). Samplers chain sqrt, cos and sin
over those ulp differences: rtol 1e-5 / atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vk_raytrace_tpu.ops import math as rmath
from vk_raytrace_tpu.ops import rng as rrng
from vk_raytrace_tpu.ops import sampling as rsamp
from vk_raytrace_torch.ops import math as pmath
from vk_raytrace_torch.ops import rng as prng
from vk_raytrace_torch.ops import sampling as psamp

RTOL = ATOL = 1e-6


def _u32(n, seed):
    return np.random.default_rng(seed).integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x)


def test_tea_bit_exact():
    a, b = _u32(4096, 0), _u32(4096, 1)
    ref = _np(rrng.tea(jnp.asarray(a), jnp.asarray(b)))
    out = prng.tea(_t(a.astype(np.int64)), _t(b.astype(np.int64))).numpy()
    np.testing.assert_array_equal(out.astype(np.uint32), ref)
    assert out.min() >= 0 and out.max() < 2**32


def test_pcg_and_rand_bit_exact():
    s = _u32(4096, 2)
    ref_state, ref_bits = rrng.pcg(jnp.asarray(s))
    st, bits = prng.pcg(_t(s.astype(np.int64)))
    np.testing.assert_array_equal(st.numpy().astype(np.uint32), _np(ref_state))
    np.testing.assert_array_equal(bits.numpy().astype(np.uint32), _np(ref_bits))
    rs, ps = jnp.asarray(s), _t(s.astype(np.int64))
    for draw in (rrng.rand, rrng.rand2, rrng.rand3):
        rs, ru = draw(rs)
        ps, pu = getattr(prng, draw.__name__)(ps)
        np.testing.assert_array_equal(pu.numpy(), _np(ru))
        np.testing.assert_array_equal(ps.numpy().astype(np.uint32), _np(rs))


@pytest.mark.parametrize("dim", [2, 3])
def test_pcg_hashes_bit_exact(dim):
    v = _u32(2048 * dim, 3 + dim).reshape(-1, dim)
    ref = (rrng.pcg2d if dim == 2 else rrng.pcg3d)(jnp.asarray(v))
    out = (prng.pcg2d if dim == 2 else prng.pcg3d)(_t(v.astype(np.int64)))
    np.testing.assert_array_equal(out.numpy().astype(np.uint32), _np(ref))


def test_bits_to_unit_float_exact():
    b = _u32(4096, 9)
    np.testing.assert_array_equal(
        prng.bits_to_unit_float(_t(b.astype(np.int64))).numpy(),
        _np(rrng.bits_to_unit_float(jnp.asarray(b))),
    )


def _unit_vectors(n, seed):
    v = np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_oct_decode_matches_and_round_trips():
    from vk_raytrace_torch import runtime

    v = _unit_vectors(4096, 4)
    packed = runtime.oct_encode(v)  # the port's host encoder
    np.testing.assert_array_equal(packed, _np(rmath.oct_encode(jnp.asarray(v))))
    ref = _np(rmath.oct_decode(jnp.asarray(packed)))
    out = pmath.oct_decode(_t(packed.view(np.int32))).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, v, atol=1e-4)  # 16-bit octahedral precision


def test_vector_helpers():
    a, b = _unit_vectors(1024, 5), _unit_vectors(1024, 6)
    ra, rb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = _t(a), _t(b)
    pairs = [
        (pmath.spherical_uv(ta), rmath.spherical_uv(ra)),
        (pmath.make_coordinate_system(ta)[0], rmath.make_coordinate_system(ra)[0]),
        (pmath.make_coordinate_system(ta)[1], rmath.make_coordinate_system(ra)[1]),
        (pmath.reflect(ta, tb), rmath.reflect(ra, rb)),
        (pmath.refract(ta, tb, torch.full((1024,), 0.7)), rmath.refract(ra, rb, jnp.full((1024,), 0.7))),
        (pmath.power_heuristic(ta[:, 0].abs(), tb[:, 0].abs()), rmath.power_heuristic(jnp.abs(ra[:, 0]), jnp.abs(rb[:, 0]))),
        (pmath.firefly_luminance(ta), rmath.firefly_luminance(ra)),
    ]
    for out, ref in pairs:
        np.testing.assert_allclose(out.numpy(), _np(ref), rtol=RTOL, atol=ATOL)
    p = np.random.default_rng(7).uniform(-3, 3, (1024, 3)).astype(np.float32)
    p[:8] *= 1e-3  # the near-origin branch
    np.testing.assert_array_equal(
        pmath.offset_ray(_t(p), ta).numpy(), _np(rmath.offset_ray(jnp.asarray(p), ra))
    )


def test_samplers():
    r = np.random.default_rng(8).random((3, 4096)).astype(np.float32)
    r1, r2, al = (_t(x) for x in r)
    j1, j2, ja = (jnp.asarray(x) for x in r)
    pairs = [
        (psamp.cosine_sample_hemisphere(r1, r2), rsamp.cosine_sample_hemisphere(j1, j2)),
        (psamp.ggx_sample(al, r1, r2), rsamp.ggx_sample(ja, j1, j2)),
    ]
    for out, ref in pairs:
        np.testing.assert_allclose(out.numpy(), _np(ref), rtol=1e-5, atol=1e-5)
