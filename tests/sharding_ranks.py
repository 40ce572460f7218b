"""Rank bodies for ``tests/test_torch_sharding.py``: module-level functions
that ``parallel.sharding.spawn_ranks`` runs in fresh gloo CPU processes.
They import the port only (no JAX): each rank renders, and rank 0 writes
what the test compares to a file."""

import numpy as np
import torch

from vk_raytrace_torch import render as R
from vk_raytrace_torch.models.schema import PBR_GLTF, RenderConfig
from vk_raytrace_torch.parallel import sharding


def cfg_of(w, h, samples=1):
    """``tests/test_sharding.py``'s configuration."""
    return RenderConfig(width=w, height=h, max_depth=2, max_samples=samples, hdr_multiplier=0.0,
                        pbr_mode=PBR_GLTF, firefly_clamp=1e4)


def sharded_frames(mesh, scene, packed, cfg, frames, pool=None):
    """``frames`` sharded frames from a zero image over ``mesh``: (the whole
    image after each frame (frames, H, W, 3), the rays of each frame)."""
    r = R.Renderer(scene, cfg, device="cpu", packed=packed)
    sharding.replicate(mesh, (r.scene, r.packed, r.alpha_pack, r._shade_tables))
    step = sharding.sharded_render_step(mesh, r.scene, r.packed, r._run_cfg,
                                        alpha_pack=r.alpha_pack, features=r.features, pool=pool)
    accum = sharding.shard_accum(mesh, torch.zeros(cfg.height, cfg.width, 3))
    imgs, rays = [], []
    for f in range(frames):
        accum, n = step(accum, f)
        imgs.append(sharding.gather_accum(mesh, accum))
        rays.append(n)
    return torch.stack(imgs), rays


def render_cases(rank, world, scene_path, out_path, cases):
    """Each case ``(name, (tile, sample), (w, h), frames, pool)`` rendered
    through ``sharded_render_step`` on the scene saved at ``scene_path``;
    rank 0 writes ``<name>`` (the image after each frame) and
    ``<name>_rays`` to ``out_path``."""
    scene, packed = torch.load(scene_path, weights_only=False)
    out = {}
    # The mesh's default shape and the shapes one axis implies.
    for key, kw in (("default", {}), ("sample2", dict(sample=2)), ("tile1", dict(tile=1))):
        shape = sharding.mesh_shape(sharding.make_mesh("cpu", **kw))
        out[f"shape_{key}"] = np.asarray([shape["tile"], shape["sample"]])
    for name, (tile, sample), (w, h), frames, pool in cases:
        mesh = sharding.make_mesh("cpu", tile=tile, sample=sample)
        img, rays = sharded_frames(mesh, scene, packed, cfg_of(w, h), frames, pool)
        out[name] = img.numpy()
        out[f"{name}_rays"] = np.asarray(rays)
    if rank == 0:
        np.savez(out_path, **out)


def cli_rank(rank, world, argv):
    """``cli.main(argv)`` in a rank of a launch (the ``torchrun``
    variables are set)."""
    from vk_raytrace_torch import cli

    assert cli.main(list(argv)) == 0
