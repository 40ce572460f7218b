"""PyTorch/CUDA port of the ``vk_raytrace_tpu`` path tracer.

The package mirrors the reference's layout (``models/``, ``ops/``,
``integrator/``, ``render.py``). Host-side scene construction is numpy plus
the native host builders (:mod:`.runtime`, which compiles the reference's
``native.cpp`` and binds it through ctypes); everything a frame runs is
torch on an explicit device. The traversal kernel is hand-written CUDA
(``csrc/traverse.cu``) with a plain torch twin for CPU tensors.

This package never imports ``jax`` or the ``vk_raytrace_tpu`` package.
"""
