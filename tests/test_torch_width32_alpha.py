"""The single-level alpha rounds at width 32 (``closest_hit_bundle``: the
opaque hit, then the alpha candidate rounds in front of it) against the
reference's ``VKRT_WIDE=32`` path, on the scenes of
``tests/test_torch_width32.py``. Seeds and accept masks exact; hits with the
tie-aware compare of ``tests/test_torch_traverse.py`` (t rtol 1e-5 / atol
1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_traverse import N_RAYS, _banner_rays, _check_hits, _t
from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401 (fixtures)
from test_torch_width32 import scene32  # noqa: F401 (fixture)
from vk_raytrace_tpu.ops import traverse_wide as ref_tw
from vk_raytrace_tpu.ops.traverse import AlphaCtx as RefAlphaCtx
from vk_raytrace_torch.ops import traverse_wide as port_tw
from vk_raytrace_torch.ops.traverse_wide import make_alpha_pack

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_alpha_rounds_w32_match_reference(scene32):
    """Opaque hit, then the alpha rounds in front of it (``closest_hit_bundle``),
    with the same seeds: accept masks and seeds exact."""
    name, scene, packed, port_scene, bundle = scene32
    o, d = _banner_rays(14, scene.geometry)
    seed = np.random.default_rng(15).integers(0, 2**32, N_RAYS, dtype=np.uint64).astype(np.uint32)
    ctx = RefAlphaCtx(materials=scene.materials, atlas=scene.atlas)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VKRT_FUSED", "1")
        ref, ref_seed = ref_tw.closest_hit_bundle(
            packed, jnp.asarray(scene.geometry.tri_material), jnp.asarray(o), jnp.asarray(d),
            seed=jnp.asarray(seed), alpha_ctx=ctx,
        )
    pack = make_alpha_pack(port_scene.materials, port_scene.atlas, port_scene.geometry.tri_material)
    hit, out_seed = port_tw.closest_hit_bundle(bundle, pack, _t(o), _t(d),
                                               _t(seed.astype(np.int64)))
    np.testing.assert_array_equal(out_seed.numpy().astype(np.uint32), np.asarray(ref_seed))
    _check_hits(hit.tri.numpy(), hit.t.numpy(), hit.u.numpy(), hit.v.numpy(),
                ref.tri, ref.t, ref.u, ref.v)
    alpha = (np.asarray(scene.geometry.tri_flags) & 2) != 0
    on_alpha = alpha[np.maximum(hit.tri.numpy(), 0)] & (hit.tri.numpy() >= 0)
    assert on_alpha.any() and (out_seed.numpy().astype(np.uint32) != seed).any()
