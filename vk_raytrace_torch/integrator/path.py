"""Integrator helpers shared by the wavefront loop (counterpart of
``vk_raytrace_tpu/integrator/path.py:106-197``): one-sample NEE strategy
density, BSDF-side env MIS weight, and the ray-cone texture LOD."""

from __future__ import annotations

import torch

from ..ops.env import environment_pdf
from ..ops.math import power_heuristic


def nee_strategy_pdf(full_mis: bool, n_lights: int, use_light, e_pdf, p_select_light: float):
    """Effective pdf of the NEE strategy: with full MIS, P(pick lights)/n for
    punctual lights and P(pick env)*alias_pdf for the environment."""
    if not full_mis:
        return torch.where(use_light, 1.0, e_pdf)
    n_lf = float(max(n_lights, 1))
    p_light_sel = p_select_light if n_lights > 0 else 0.0
    return torch.where(use_light, p_light_sel / n_lf, (1.0 - p_light_sel) * e_pdf)


def env_bsdf_mis_weight(scene, bsdf_pdf, direction, p_select_light: float, sun_disk: bool = False):
    """Power-heuristic weight of a BSDF-sampled ray that escaped to the
    environment; camera rays (bsdf_pdf == 0) get weight 1."""
    p_light_sel = p_select_light if scene.n_lights > 0 else 0.0
    pdf_env = environment_pdf(scene.env, direction, scene.sun_sky, sun_disk) * (1.0 - p_light_sel)
    return torch.where(
        bsdf_pdf > 0.0, torch.clamp(power_heuristic(bsdf_pdf, pdf_env), min=0.0), 1.0
    )


def mip_lod_enabled(scene, cfg) -> bool:
    """Ray-cone mip sampling: on when the atlas carries mip chains and
    ``cfg.mip_sample`` is set."""
    return scene.atlas.mip_x is not None and cfg.mip_sample


def pixel_spread(scene, height: int) -> float:
    """Angular radius of one pixel's ray cone: 2 tan(fov/2) / height."""
    tan_half = abs(float(scene.camera.proj_inverse[1, 1]))
    return float(torch.tensor(2.0 * tan_half, dtype=torch.float32) / max(height, 1))


def cone_lod(ss, spread, tdist):
    """Texture-size-independent LOD: uv density + log2(cone width at hit)."""
    return ss["uv_density"] + torch.log2(torch.clamp(spread * tdist, min=1e-20))
