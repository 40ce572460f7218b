"""Tile x sample sharding of the progressive render over ranks
(counterpart of ``vk_raytrace_tpu/parallel/sharding.py``, on
``torch.distributed``).

One process per rank, each on its own device (rank r on ``cuda:r %
device_count()`` unless the caller names another), in a ``DeviceMesh`` of
dims ``("tile", "sample")``:

* ``tile`` splits the image rows: rank (t, s) traces the pixels of rows
  ``[t * H / tile, (t + 1) * H / tile)`` and keeps only those rows of the
  accumulation; no communication on that axis in a frame;
* ``sample`` splits the samples of a frame: each rank traces its own
  independent samples of the same rows, and one all-reduce (a sum over the
  ``sample`` group, then a division) averages them. For two ranks that is
  ``(a + b) / 2`` in either order, the reference's ``pmean``; for more, the
  sum runs in the backend's order (a ring under NCCL), so the mean agrees
  with a fixed-order one to rounding, not bit for bit;
* one more all-reduce sums the frame's traced rays over every rank.

Each rank runs the port's pooled wavefront (``render_units_pooled``) over
its slice, split into dispatches as a frame is (``render.dispatch_split``).
A path's random stream is keyed on its global pixel id and the
stream ``frame * n_sample + sample_idx``, while the frame index still
drives the jitter gate: at ``sample = 1`` the tiles together are the
one-device render bit for bit.

The backend is never picked behind the caller's back: NCCL for ``cuda``
and gloo for ``cpu`` by default; any other pairing (gloo over CUDA
tensors, which copies through the host) only when asked for by name.
:func:`replicate` broadcasts rank 0's tables so the ranks cannot disagree;
:func:`shard_accum` and :func:`gather_accum` split and join the image.
:func:`spawn_ranks` starts ranks in fresh processes on one host: gloo CPU
ranks (the tests and ``graft_entry.dryrun_multichip``), or ranks on the
card under the backend named.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
DIMS = ("tile", "sample")


def backend_for(device_type: str, backend=None) -> str:
    """The backend of a mesh on ``device_type``: ``backend`` when named,
    else NCCL for ``cuda`` and gloo for ``cpu``."""
    if backend is not None:
        return backend
    if device_type not in BACKENDS:
        raise ValueError(f"no default backend for device type {device_type!r}; name one")
    return BACKENDS[device_type]


def init_process_group(device_type: str, rank=None, world_size=None, init_method="env://",
                       backend=None, timeout_s: float = 300.0) -> str:
    """Join the default process group with :func:`backend_for`'s backend:
    ``init_method`` ``env://`` (the variables ``torchrun`` sets) or
    ``tcp://host:port`` with ``rank`` and ``world_size``. A rendezvous or a
    collective that waits longer than ``timeout_s`` raises. Returns the
    backend."""
    be = backend_for(device_type, backend)
    kw = {} if rank is None else dict(rank=rank, world_size=world_size)
    dist.init_process_group(be, init_method=init_method,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return be


def make_mesh(device_type: str, tile=None, sample=None, backend=None, device=None):
    """The ``(tile, sample)`` DeviceMesh of every rank of the default
    process group (joined first from the environment, ``env://``, when it
    is not). Defaults as in the reference: every rank on ``tile``, ``sample
    = 1``; ``tile * sample`` must be the world size. On ``cuda`` the rank's
    device becomes ``device``, or ``cuda:rank % device_count()``. Raises
    when the group's backend is not :func:`backend_for`'s."""
    from torch.distributed.device_mesh import DeviceMesh

    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs CUDA; use device_type='cpu' to shard on the CPU")
    want = backend_for(device_type, backend)
    if not dist.is_initialized():
        init_process_group(device_type, backend=want)
    if dist.get_backend() != want:
        raise ValueError(f"the process group runs {dist.get_backend()}, the {device_type} mesh "
                         f"asks for {want}")
    n = dist.get_world_size()
    if tile is None and sample is None:
        tile, sample = n, 1
    elif tile is None:
        tile = n // sample
    elif sample is None:
        sample = n // tile
    if tile < 1 or sample < 1 or tile * sample != n:
        raise ValueError(f"mesh {tile}x{sample} != {n} ranks")
    if device_type == "cuda":
        torch.cuda.set_device(torch.device(device) if device is not None
                              else torch.device("cuda", dist.get_rank() % torch.cuda.device_count()))
    return DeviceMesh(device_type, torch.arange(n).reshape(tile, sample), mesh_dim_names=DIMS)


def mesh_device(mesh) -> torch.device:
    """The device of this rank's tensors in ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_shape(mesh) -> dict:
    """``{"tile": n_tile, "sample": n_sample}``."""
    return {d: mesh.size(i) for i, d in enumerate(DIMS)}


def _leaves(tree):
    """The tensors of a tree of dataclasses, named tuples, tuples and lists,
    in field order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _leaves(x)


def replicate(mesh, tree):
    """Overwrite every tensor of ``tree`` (scene tables, accel, alpha pack,
    stage tables; built alike on every rank) with rank 0's, in place, so the
    ranks trace identical bytes. Raises when the ranks' trees differ in
    shape or dtype. Returns ``tree``."""
    leaves = list(_leaves(tree))
    sig = [(tuple(t.shape), str(t.dtype)) for t in leaves]
    theirs = [sig]
    dist.broadcast_object_list(theirs, src=0)
    if theirs[0] != sig:
        raise ValueError(f"rank {dist.get_rank()}'s tables differ from rank 0's in shape or dtype")
    dev = mesh_device(mesh)
    for t in leaves:
        if not t.numel():
            continue
        if t.device == dev or dist.get_backend() != "nccl":
            dist.broadcast(t, src=0)
        else:  # NCCL moves device tensors only: a host table goes through the card
            on_dev = t.to(dev)
            dist.broadcast(on_dev, src=0)
            t.copy_(on_dev)
    return tree


def shard_accum(mesh, accum: torch.Tensor) -> torch.Tensor:
    """This rank's rows of an (H, W, 3) accumulation image (a copy)."""
    n_tile = mesh_shape(mesh)["tile"]
    h = accum.shape[0]
    if h % n_tile:
        raise ValueError(f"height {h} not divisible by the tile axis {n_tile}")
    rows = h // n_tile
    t = mesh.get_local_rank("tile")
    return accum[t * rows:(t + 1) * rows].clone()


def gather_accum(mesh, accum_rows: torch.Tensor) -> torch.Tensor:
    """The whole (H, W, 3) image from every rank's rows, on every rank."""
    parts = [torch.empty_like(accum_rows) for _ in range(mesh_shape(mesh)["tile"])]
    dist.all_gather(parts, accum_rows.contiguous(), group=mesh.get_group("tile"))
    return torch.cat(parts, dim=0)


def _slice(mesh, cfg):
    shape = mesh_shape(mesh)
    if cfg.height % shape["tile"]:
        raise ValueError(f"height {cfg.height} not divisible by the tile axis {shape['tile']}")
    rows = cfg.height // shape["tile"]
    return shape, rows, mesh.get_local_rank("tile"), mesh.get_local_rank("sample")


def _mean_and_rays(mesh, new, rays, n_sample, dev):
    """The frame's only collectives: the mean over ``sample`` and the sum
    of rays over every rank."""
    if n_sample > 1:
        dist.all_reduce(new, op=dist.ReduceOp.SUM, group=mesh.get_group("sample"))
        new = new / float(n_sample)
    rays = torch.as_tensor(rays, dtype=torch.int64, device=dev).reshape(1).clone()
    dist.all_reduce(rays, op=dist.ReduceOp.SUM)
    return new, int(rays.item())


def rank_frame(scene, packed, cfg, frame: int, tile_idx: int, n_tile: int, sample_idx: int,
               n_sample: int, alpha_pack=None, features=None, fused_shade: bool = False,
               shade_tables=None, pool=None, backend="fused"):
    """What rank (``tile_idx``, ``sample_idx``) of a ``n_tile`` x
    ``n_sample`` mesh traces of frame ``frame``, before any collective:
    ``(its rows' new radiance (H / n_tile, W, 3), its rays (0-d))``."""
    from ..integrator.wavefront import render_units_pooled
    from ..render import dispatch_split

    rows = cfg.height // n_tile
    n, n_pix, pool = dispatch_split(rows * cfg.width, cfg.max_samples, pool)
    pix0 = tile_idx * rows * cfg.width
    stream = frame * n_sample + sample_idx
    parts, rays = [], 0
    for i in range(n):
        img, r = render_units_pooled(
            scene, packed, cfg, frame, pix0 + i * n_pix, n_pix, pool, alpha_pack=alpha_pack,
            features=features, fused_shade=fused_shade, shade_tables=shade_tables, stream=stream,
            backend=backend,
        )
        parts.append(img)
        rays = rays + r
    return torch.cat(parts, dim=0).reshape(rows, cfg.width, 3), rays


def sharded_render_step(mesh, scene, packed, cfg, alpha_pack=None, features=None,
                        fused_shade: bool = False, shade_tables=None, pool=None, backend="fused"):
    """The progressive frame over ``mesh`` through the pooled wavefront.

    ``scene``, ``packed`` (an ``AccelBundle``, or an ``InstancedAccel`` for
    a two-level scene), ``alpha_pack``, ``features``, ``fused_shade`` and
    ``shade_tables`` are what ``render_units_pooled`` takes (a
    ``Renderer``'s ``scene``, ``packed``, ``alpha_pack``, ``features``,
    ``fused_shade`` and ``_shade_tables``, with its run configuration
    ``_run_cfg`` as ``cfg``: the sun&sky baked), on this rank's device.
    ``pool``: lanes per dispatch (default as ``Renderer``). ``backend``:
    the traversal back end (a ``Renderer``'s ``renderer``).

    Returns ``step(accum_rows, frame) -> (accum_rows, rays)``: this rank's
    rows of the running mean, updated as ``Renderer.step`` updates the
    image, and the frame's rays over every rank. Samples per frame are
    ``cfg.max_samples * n_sample``."""
    from ..render import progressive_update

    shape, _, tile_idx, sample_idx = _slice(mesh, cfg)
    dev = mesh_device(mesh)

    def step(accum_rows, frame: int):
        frame = int(frame)
        new, rays = rank_frame(scene, packed, cfg, frame, tile_idx, shape["tile"], sample_idx,
                               shape["sample"], alpha_pack, features, fused_shade, shade_tables,
                               pool, backend)
        new, rays = _mean_and_rays(mesh, new, rays, shape["sample"], dev)
        return progressive_update(accum_rows, new, frame), rays

    return step


def sharded_render_step_unrolled(mesh, scene, packed, cfg, alpha_pack=None, features=None,
                                 backend="fused"):
    """The unrolled per-depth integrator over the same mesh (the debug
    render modes; ``Renderer._frame_strips``): ``render.render_strip_impl``
    over strips of ``render.strip_rows_for`` rows of this rank's slice, on
    the stream ``frame * n_sample + sample_idx``. Returns
    ``step(accum_rows, frame) -> (accum_rows, rays)``."""
    from ..render import progressive_update, render_strip_impl, strip_rows_for

    shape, rows, tile_idx, sample_idx = _slice(mesh, cfg)
    n_sample = shape["sample"]
    strip = strip_rows_for(dataclasses.replace(cfg, height=rows))
    dev = mesh_device(mesh)

    def step(accum_rows, frame: int):
        frame = int(frame)
        strips, rays = [], 0
        for r0 in range(tile_idx * rows, (tile_idx + 1) * rows, strip):
            img, r = render_strip_impl(scene, packed, cfg, r0, strip, frame, alpha_pack=alpha_pack,
                                       features=features, stream=frame * n_sample + sample_idx,
                                       backend=backend)
            strips.append(img)
            rays = rays + r
        new, rays = _mean_and_rays(mesh, torch.cat(strips, dim=0), rays, n_sample, dev)
        return progressive_update(accum_rows, new, frame), rays

    return step


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(target, rank, world_size, port, args, env, device_type, backend):
    """A spawned rank: the ``torchrun`` variables, the process group, then
    ``target(rank, world_size, *args)``."""
    os.environ.update(env)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world_size),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    init_process_group(device_type, backend=backend, timeout_s=120.0)
    try:
        target(rank, world_size, *args)
    finally:
        if dist.is_initialized():  # the target may have left the group itself
            dist.destroy_process_group()


def spawn_ranks(target, world_size: int, args=(), timeout_s: float = 600.0, env=None,
                device_type: str = "cpu", backend=None) -> None:
    """Run ``target(rank, world_size, *args)`` (a module-level function) in
    ``world_size`` fresh processes (``spawn``), the ranks of one process
    group on a free localhost port (:func:`backend_for` ``device_type`` and
    ``backend``: gloo CPU ranks by default), with ``env`` added to their
    environment. Raises naming the failed ranks when one exits non-zero or
    the ranks do not finish within ``timeout_s``; no process outlives the
    call."""
    import multiprocessing as mp
    import time

    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_entry, args=(target, r, world_size, port, tuple(args),
                                                    dict(env or {}), device_type, backend),
                         daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.time() + timeout_s
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.time()))
            if p.exitcode not in (None, 0):
                break
    finally:
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
    if late or bad:
        raise RuntimeError(f"spawned ranks failed: exit codes {bad}"
                           + (f"; ranks {late} still running after {timeout_s:.0f} s" if late
                              else ""))
