"""The frozen generators against today's port (``models/procedural.py``) at a
small size, array for array; and their numpy host builders against the
port's native ones."""

import dataclasses

import numpy as np
import pytest

from rtbench.scenes import builder as fb
from rtbench.scenes import procedural as fp


def _equal(a, b, path):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _equal(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif a is None or b is None:
        assert a is None and b is None, path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path


@pytest.mark.parametrize("gen,kw", [
    ("atrium_scene", dict(bays_x=2, bays_z=2, column_segments=16, column_rows=12)),
    ("atrium_scene", dict(bays_x=3, bays_z=2, column_segments=12, column_rows=10,
                          with_banners=False)),
    ("bistro_scene", dict(detail=0.05, seed=9)),
    ("bistro_scene", dict(detail=0.05, seed=9, instanced=False)),
])
def test_frozen_generators_equal_the_port(gen, kw):
    from vk_raytrace_torch.models import procedural as pp

    for i, (x, y) in enumerate(zip(getattr(fp, gen)(**kw), getattr(pp, gen)(**kw))):
        _equal(x, y, f"{gen}[{i}]")


def test_host_builders_equal_the_native_ones():
    from vk_raytrace_torch import runtime

    rng = np.random.default_rng(3)
    v = rng.normal(size=(4000, 3))
    v[:8] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0], [0.5, -0.5, -0.7071],
             [-1e-8, 1, 0], [0.3, 0.3, -0.9], [-0.6, -0.8, 0]]
    v = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    assert np.array_equal(fb.oct_encode(v), runtime.oct_encode(v))
    c = rng.uniform(-0.2, 1.2, size=(4000, 4)).astype(np.float32)
    c[:4] = [[0.5 / 255, 1.5 / 255, 2.5 / 255, 1.0], [0, 1, 0.5, 0.25], [1, 1, 1, 1], [0, 0, 0, 0]]
    assert np.array_equal(fb.pack_rgba8(c), runtime.pack_rgba8(c))
    pos = rng.normal(size=(500, 3))
    idx = rng.integers(0, 500, size=(900, 3))
    idx[:3] = [[0, 0, 0], [1, 2, 3], [3, 2, 1]]
    assert np.array_equal(fb.smooth_normals(pos, idx), runtime.smooth_normals(pos, idx))
