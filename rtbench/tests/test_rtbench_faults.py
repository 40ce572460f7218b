"""The check against a broken timed path: a run on the CPU (the harness's
look for a card skipped; the port's plain versions under the window) with
each fault a cell can have planted underneath comes out not correct, and
the sound run correct. One chip only: no exchange between chips to leave
out."""

import numpy as np
import pytest
import torch

from rtbench import bench
from rtbench_cells import small_cell


def _run(config, seed=2**31 + 5):
    return bench.run_cell(small_cell(config), seed, 0.5, False, "cpu", 0.0,
                          log=lambda *a, **k: None)


@pytest.mark.parametrize("config", ["atrium", "bistro"])
def test_sound_run_is_correct(config):
    out = _run(config)
    assert out["correct"], out["compared"]
    assert out["compared"]["image_gap"]["value"] < 1e-5
    assert out["compared"]["pixel_gap_median"]["value"] < 1e-6


def test_pixel_gap_median_sees_a_weight_and_not_one_pixel():
    """A running mean weighed ``1 / frame`` at frame ``K`` scales every
    pixel by about ``1 + 1 / K``: the median pixel reads that at any frame,
    where one pixel's path gone another way leaves it at 0."""
    ref = np.random.default_rng(3).uniform(0.05, 2.0, (64, 3)).astype(np.float32)
    k = 5000.0
    assert bench.pixel_gap_median(ref * np.float32(1 + 1 / k), ref) == pytest.approx(1 / k, rel=1e-3)
    one = ref.copy()
    one[7] *= 3.0
    assert bench.pixel_gap_median(one, ref) == 0.0 and bench.image_gap(one, ref) > 1e-3


def _state_unchanged(monkeypatch):
    """Each step returns its state unchanged: the accumulation never moves."""
    from vk_raytrace_torch import render

    monkeypatch.setattr(render, "progressive_update", lambda accum, new, frame: accum)


def _weight_off_by_one(monkeypatch):
    """The running mean weighs each new frame ``1 / frame`` in place of
    ``1 / (frame + 1)``."""
    from vk_raytrace_torch import render

    monkeypatch.setattr(render, "progressive_update",
                        lambda accum, new, frame: accum + (new - accum) * (1.0 / frame))


def _half_left_out(monkeypatch):
    """Half of each frame's paths left out, their pixels given the mean of
    the rest."""
    from vk_raytrace_torch import render

    real = render.Renderer.render_frame

    def half(self, frame):
        img = real(self, frame)
        flat = img.reshape(-1, 3).clone()
        flat[1::2] = flat[0::2].mean(dim=0)
        return flat.reshape(img.shape)

    monkeypatch.setattr(render.Renderer, "render_frame", half)


def _answer_altered(monkeypatch):
    """Each path's radiance altered where the loop retires it (its red and
    blue swapped)."""
    from vk_raytrace_torch.integrator import pool

    real = pool._retire_plain

    def altered(st, b, ctrl, out, steps, sl):
        b = dict(b, radiance=b["radiance"][:, [2, 1, 0]], nee=b["nee"][:, [2, 1, 0]])
        real(st, b, ctrl, out, steps, sl)

    monkeypatch.setattr(pool, "_retire_plain", altered)


@pytest.mark.parametrize("config", ["atrium", "bistro"])
@pytest.mark.parametrize("fault", [_state_unchanged, _weight_off_by_one, _half_left_out,
                                   _answer_altered])
def test_fault_is_not_correct(monkeypatch, config, fault):
    fault(monkeypatch)
    out = _run(config)
    assert not out["correct"], (fault.__name__, out["compared"])
