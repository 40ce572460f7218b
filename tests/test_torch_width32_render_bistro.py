"""The render slice of the small bistro at width 32: the port (CPU, the
reference's tables and width-32 trees) against the reference's
``VKRT_WIDE=32`` renderer, held as ``tests/test_torch_width32_render.py``
holds the atrium's (its helpers).
"""

import pytest

from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401 (fixtures)
from test_torch_width32_render import RENDER_CFG, _check_render, _render_both
from vk_raytrace_tpu import render as ref_render
from vk_raytrace_tpu.models import procedural as ref_proc
from vk_raytrace_tpu.models.schema import RenderConfig as RefConfig

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_render_w32_bistro_matches_reference(monkeypatch):
    """From frame 1 (jittered), as ``tests/test_torch_bistro.py`` does."""
    monkeypatch.setenv("VKRT_WIDE", "32")
    monkeypatch.setenv("VKRT_FUSED", "1")
    pool, inst, mats, lights, cam, atlas = ref_proc.bistro_scene(detail=0.05)
    cfg = dict(width=64, height=36, hdr_multiplier=1.0, full_mis=False, **RENDER_CFG)
    ref = ref_render.Renderer(
        ref_render.build_instanced_scene(pool, inst, mats, lights, cam, atlas=atlas),
        RefConfig(**cfg),
    )
    assert ref.packed.blas_planar.width == 32
    _check_render(*_render_both(ref, ref.packed, cfg, first_frame=1), 64, 36)
