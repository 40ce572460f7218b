"""Entry points of the port for an external caller (counterpart of the repository's
root ``__graft_entry__.py``, which stays the reference's).

``entry(device="cuda")`` returns ``(fn, (accum, frame))``: ``fn(accum,
frame)`` renders one progressive frame of the Cornell box (64x64, depth 2,
1 spp, glTF PBR) through the pooled wavefront and returns the new running
mean. ``dryrun_multichip(n)`` runs the full sharded render step
(``parallel/sharding.py``) on ``n`` gloo CPU ranks, each a fresh process:
a tile x sample mesh (sample 2 when ``n`` is even), 64 x 32·tile pixels,
a pool of 1024 lanes against 2,048 pixels a rank so that the pool refills,
and checks that the image is lit and rays were traced.

    python -m vk_raytrace_torch.graft_entry            # entry() on the card
    python -m vk_raytrace_torch.graft_entry multichip 4
"""

from __future__ import annotations

import sys


def _cornell_cfg(width, height):
    from .models.schema import PBR_GLTF, RenderConfig

    return RenderConfig(width=width, height=height, max_depth=2, max_samples=1,
                        hdr_multiplier=0.0, pbr_mode=PBR_GLTF, firefly_clamp=1e3)


def entry(device="cuda"):
    """``(fn, (accum, frame))`` for one Cornell frame on ``device``."""
    import torch

    from . import render as R
    from .models import procedural

    geom, mats, lights, cam = procedural.cornell_box()
    cfg = _cornell_cfg(64, 64)
    r = R.Renderer(R.build_scene(geom, mats, lights, cam), cfg, device=device)

    def fn(accum, frame):
        frame = int(frame)
        return R.progressive_update(accum, r.render_frame(frame), frame)

    accum = torch.zeros((cfg.height, cfg.width, 3), device=r.device)
    return fn, (accum, 0)


def _dryrun_rank(rank, world_size):
    """One rank of :func:`dryrun_multichip`."""
    import torch

    from . import render as R
    from .models import procedural
    from .parallel import sharding

    sample = 2 if world_size % 2 == 0 else 1
    mesh = sharding.make_mesh("cpu", tile=world_size // sample, sample=sample)
    tile = sharding.mesh_shape(mesh)["tile"]
    cfg = _cornell_cfg(64, 32 * tile)
    geom, mats, lights, cam = procedural.cornell_box()
    r = R.Renderer(R.build_scene(geom, mats, lights, cam), cfg, device="cpu")
    sharding.replicate(mesh, (r.scene, r.packed))
    step = sharding.sharded_render_step(mesh, r.scene, r.packed, r._run_cfg,
                                        alpha_pack=r.alpha_pack, features=r.features, pool=1024)
    accum, rays = step(sharding.shard_accum(mesh, torch.zeros(cfg.height, cfg.width, 3)), 0)
    img = sharding.gather_accum(mesh, accum)
    mean = float(img.mean())
    if not (mean > 0.0 and torch.isfinite(img).all()):
        raise RuntimeError(f"rank {rank}: the sharded render produced an empty image")
    if rays <= 0:
        raise RuntimeError(f"rank {rank}: the sharded render traced no rays")
    if rank == 0:
        print(f"dryrun_multichip({world_size}): mesh={sharding.mesh_shape(mesh)} "
              f"mean={mean:.5f} rays={rays} OK", flush=True)


def dryrun_multichip(n_devices: int, timeout_s: float = 600.0) -> None:
    """The sharded render step on ``n_devices`` gloo CPU ranks (fresh
    processes that see no card); raises when a rank fails or the ranks do
    not finish within ``timeout_s``."""
    from .parallel import sharding

    sharding.spawn_ranks(_dryrun_rank, n_devices, timeout_s=timeout_s,
                         env={"CUDA_VISIBLE_DEVICES": ""})


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "multichip":
        dryrun_multichip(int(argv[1]) if len(argv) > 1 else 8)
        return 0
    fn, args = entry()
    out = fn(*args)
    print("entry() ran:", tuple(out.shape), float(out.mean()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
