"""Frozen copy of ``vk_raytrace_torch/ops/rng.py`` for the benchmark's reference.

Counter-based TEA/PCG streams, bit-exact with ``vk_raytrace_tpu/ops/rng.py``.

A stream state is a uint32 per lane. torch's uint32 support is partial, so
states live in int64 tensors holding values in [0, 2**32): every add and
multiply is masked back to 32 bits (int64 products wrap mod 2**64, whose
low 32 bits are the uint32 product), and right shifts of non-negative
values are logical.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF


def u32(x, device=None) -> torch.Tensor:
    """Tensor of uint32 values held in int64."""
    if isinstance(x, torch.Tensor):
        return x.long() & MASK
    return torch.as_tensor(x, dtype=torch.int64, device=device) & MASK


def tea(val0, val1, rounds: int = 16) -> torch.Tensor:
    """Tiny Encryption Algorithm hash of two uint32s (random.glsl:34-48)."""
    v0 = u32(val0)
    v1 = u32(val1, v0.device)
    s0 = 0
    for _ in range(rounds):
        s0 = (s0 + 0x9E3779B9) & MASK
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) ^ (v1 + s0)) ^ ((v1 >> 5) + 0xC8013EA4))) & MASK
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) ^ (v0 + s0)) ^ ((v0 >> 5) + 0x7E95761E))) & MASK
    return v0


def pcg(state: torch.Tensor):
    """One PCG-RXS-M-XS step (random.glsl:59-65): ``(new_state, bits)``."""
    prev = (u32(state) * 747796405 + 2891336453) & MASK
    shift = (prev >> 28) + 4
    word = (((prev >> shift) ^ prev) * 277803737) & MASK
    return prev, (word >> 22) ^ word


def bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 in [0, 1): ``(r >> 9) * 2**-23`` (exact)."""
    return (bits >> 9).to(torch.float32) * (1.0 / 8388608.0)


def rand(seed: torch.Tensor):
    """One uniform per lane: ``(seed', u)``."""
    seed, bits = pcg(seed)
    return seed, bits_to_unit_float(bits)


def rand3(seed: torch.Tensor):
    seed, a = rand(seed)
    seed, b = rand(seed)
    seed, c = rand(seed)
    return seed, torch.stack([a, b, c], dim=-1)
