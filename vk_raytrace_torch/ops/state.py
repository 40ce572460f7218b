"""Shading state (counterpart of ``vk_raytrace_tpu/ops/state.py``): the SoA
analog of the reference's ``State`` / ``State.mat``; every field a batch
tensor over the wavefront."""

from __future__ import annotations

from typing import NamedTuple

import torch


class MatState(NamedTuple):
    """Resolved material at a hit point."""

    albedo: torch.Tensor               # (R, 3)
    metallic: torch.Tensor             # (R,)
    roughness: torch.Tensor            # (R,)
    f0: torch.Tensor                   # (R, 3)
    alpha: torch.Tensor                # (R,)
    emission: torch.Tensor             # (R, 3)
    transmission: torch.Tensor         # (R,)
    ior: torch.Tensor                  # (R,)
    unlit: torch.Tensor                # (R,) bool
    anisotropy: torch.Tensor           # (R,)
    ax: torch.Tensor                   # (R,)
    ay: torch.Tensor                   # (R,)
    attenuation_color: torch.Tensor    # (R, 3)
    attenuation_distance: torch.Tensor # (R,)
    thinwalled: torch.Tensor           # (R,) bool
    clearcoat: torch.Tensor            # (R,)
    clearcoat_roughness: torch.Tensor  # (R,)
    sheen_color: torch.Tensor          # (R, 3)
    sheen_roughness: torch.Tensor      # (R,)
    specular: torch.Tensor             # (R,) = 0.5
    specular_tint: torch.Tensor        # (R,) = 1.0
    subsurface: torch.Tensor           # (R,) = 0.0


class SurfState(NamedTuple):
    """Geometric + material state at a hit."""

    position: torch.Tensor     # (R, 3)
    normal: torch.Tensor       # (R, 3) shading normal (post normal map)
    geom_normal: torch.Tensor  # (R, 3)
    ffnormal: torch.Tensor     # (R, 3) forward-facing normal
    tangent: torch.Tensor      # (R, 3)
    bitangent: torch.Tensor    # (R, 3)
    tex_coord: torch.Tensor    # (R, 2)
    eta: torch.Tensor          # (R,)
    mat: MatState
