"""The pooled wavefront's two bookkeeping stages over the lane pool, each a
CUDA kernel (``csrc/wavefront.cu``) with its plain torch version:

* :func:`regenerate`: dead lanes claim the next unclaimed (pixel, sample)
  units of the slice, in lane order, and start their camera paths (the
  reference's XLA body ``regenerate``, ``vk_raytrace_tpu/integrator/
  wavefront.py:158-196``, with the camera and the TEA seed);
* :func:`retire`: the bounce's epilogue after the shadow ray (reference
  ``:404-472``): the unoccluded light, Russian roulette, the depth gate, the
  firefly clamp and the scatter of each retired path into its unit, the
  lane updates, the ray and live counts and the optional step record.

Both keep the loop's control in ``ctrl``, an (3,) int64 tensor on the
pool's device: ``{next_unit, live, rays}``. :func:`regenerate` advances
``next_unit`` and clears ``live``; :func:`retire` counts ``live`` and adds
to ``rays``. The loop reads the three once an iteration.

The pool's state is a dict of tensors over its lanes (:data:`FIELDS` and
``active``); both stages update it in place or rebind its entries. CUDA
tensors launch the kernel or raise; CPU tensors run the plain version.
:data:`LAUNCHES` counts the kernels' launches (one a call each).
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional

import torch

from .. import cuda_build
from ..ops import rng
from ..ops.math import firefly_luminance
from .camera import generate_rays_for_pixels

# Per-lane path state: the eleven fields a regeneration resets.
FIELDS = (
    "pix", "unit", "origin", "direction", "radiance", "throughput",
    "absorption", "seed", "depth", "bsdf_pdf", "tdist",
)
# The occupancy record's length; later iterations share its last entry.
OCC_LEN = 1024

LAUNCHES = {"regenerate": 0, "retire": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Slice(NamedTuple):
    """What both stages need of the slice being traced."""

    total_units: int    # n_pix * spp
    n_pix: int
    spp: int
    pix0: int           # first pixel of the slice
    stream: int         # the random stream: tea(pixel, stream * spp + sample)
    frame: int          # frame 0 shoots pixel centres
    width: int
    height: int
    tiled: bool         # units map to pixels in 8x8 tiles
    camera: object      # the scene's Camera (the plain version)
    camera_rows: torch.Tensor  # (34,) f32: view_inverse, proj_inverse, focal_dist, aperture
    rr: bool
    rr_depth: int
    max_depth: int
    clamp: float        # the firefly clamp


def make_slice(cam, cfg, n_pix: int, pix0: int, stream: int, frame: int) -> Slice:
    """The :class:`Slice` of ``n_pix`` pixels from ``pix0`` under ``cfg``
    (a ``RenderConfig``); ``cam`` on the pool's device."""
    w = cfg.width
    rows = torch.cat([torch.as_tensor(x).reshape(-1).float() for x in (
        cam.view_inverse, cam.proj_inverse, cam.focal_dist, cam.aperture)]).contiguous()
    return Slice(n_pix * cfg.max_samples, n_pix, cfg.max_samples, pix0, stream, frame, w,
                 cfg.height, w % 8 == 0 and n_pix % (w * 8) == 0, cam, rows, bool(cfg.rr),
                 cfg.rr_depth, cfg.max_depth, cfg.firefly_clamp)


def empty_pool(n: int, dev) -> dict:
    """A pool of ``n`` dead lanes (direction +z, the rest zero)."""
    z3 = torch.zeros(n, 3, device=dev)
    i64 = lambda: torch.zeros(n, dtype=torch.int64, device=dev)  # noqa: E731
    return dict(
        pix=i64(), unit=i64(), origin=z3, direction=torch.zeros(n, 3, device=dev).index_fill_(
            1, torch.tensor([2], device=dev), 1.0),
        radiance=z3.clone(), throughput=z3.clone(), absorption=z3.clone(), seed=i64(),
        depth=i64(), bsdf_pdf=torch.zeros(n, device=dev), tdist=torch.zeros(n, device=dev),
        active=torch.zeros(n, dtype=torch.bool, device=dev),
    )


def compact(st: dict, width: int) -> dict:
    """The pool cut to ``width`` lanes, the live ones first in lane order (a
    stable partition, as the reference's ``argsort(~active)[:width]``)."""
    take = torch.argsort((~st["active"]).to(torch.uint8), stable=True)[:width]
    return {k: v[take].contiguous() for k, v in st.items()}


def regenerate(st: dict, ctrl: torch.Tensor, occ: Optional[torch.Tensor], it: int,
               sl: Slice) -> None:
    """Dead lanes claim units ``ctrl[0]``, ``ctrl[0] + 1``, ... in lane
    order while units remain, and start their paths; ``ctrl[0]`` advances
    by the grant and ``ctrl[1]`` is cleared. ``occ``, when given, gets the
    lanes active after the grant at ``min(it, OCC_LEN - 1)``."""
    dev = st["active"].device
    if dev.type == "cuda":
        _regenerate_cuda(st, ctrl, occ, it, sl)
    elif dev.type == "cpu":
        _regenerate_plain(st, ctrl, occ, it, sl)
    else:
        raise ValueError(f"no regeneration for device {dev}")


def retire(st: dict, b: dict, ctrl: torch.Tensor, out: torch.Tensor,
           steps: Optional[torch.Tensor], sl: Slice) -> None:
    """The bounce's epilogue over the pool. ``b``: the bounce's values
    (``alive``, ``visible``, ``radiance``, ``throughput``, ``nee``,
    ``rr_pcont``, ``pdf_b`` from the shading stage, ``occluded`` and
    ``seed`` from the shadow ray, ``hit_steps`` from the closest hit).
    Writes each retired path's clamped radiance to ``out[unit]`` (``out``
    has ``total_units`` rows and one spare a lane), updates the lanes'
    radiance, throughput, seed, depth, bsdf_pdf and active, adds the live
    lanes to ``ctrl[1]`` (which :func:`regenerate` cleared) and the bounce's
    rays (active plus visible shadow rays) to ``ctrl[2]``; ``steps`` ((n_pix
    + 1,) int32, the last entry a spare), when given, gets each active lane's
    closest-hit steps at its slice-local pixel."""
    dev = st["active"].device
    if dev.type == "cuda":
        _retire_cuda(st, b, ctrl, out, steps, sl)
    elif dev.type == "cpu":
        _retire_plain(st, b, ctrl, out, steps, sl)
    else:
        raise ValueError(f"no retirement for device {dev}")


# ---------------------------------------------------------------------------
# Plain versions (any device)
# ---------------------------------------------------------------------------


def unit_to_local(sl: Slice, p_rank):
    """Slice-local pixel of pixel-rank ``p_rank`` in the 8x8 tile order."""
    tiles_x = sl.width // 8
    t_id = p_rank // 64
    w_in = p_rank % 64
    lx = (t_id % tiles_x) * 8 + (w_in % 8)
    ly = (t_id // tiles_x) * 8 + (w_in // 8)
    return ly * sl.width + lx


def _regenerate_plain(st, ctrl, occ, it, sl):
    active = st["active"]
    dead = (~active).long()
    rank = torch.cumsum(dead, 0) - dead
    unit = ctrl[0] + rank
    granted = (dead > 0) & (unit < sl.total_units)
    n_dead = dead.sum()
    n_granted = torch.minimum(n_dead, sl.total_units - ctrl[0])
    p_rank = unit // sl.spp
    local = unit_to_local(sl, p_rank) if sl.tiled else p_rank
    upix = sl.pix0 + local
    usamp = unit % sl.spp
    seed_new = rng.tea(upix, sl.stream * sl.spp + usamp)
    o, d, seed_new = generate_rays_for_pixels(sl.camera, sl.width, sl.height, upix, sl.frame,
                                              seed_new)
    g3 = granted[:, None]
    st.update(
        pix=torch.where(granted, upix, st["pix"]),
        unit=torch.where(granted, unit, st["unit"]),
        origin=torch.where(g3, o, st["origin"]),
        direction=torch.where(g3, d, st["direction"]),
        radiance=torch.where(g3, 0.0, st["radiance"]),
        throughput=torch.where(g3, 1.0, st["throughput"]),
        absorption=torch.where(g3, 0.0, st["absorption"]),
        seed=torch.where(granted, seed_new, st["seed"]),
        depth=torch.where(granted, 0, st["depth"]),
        bsdf_pdf=torch.where(granted, 0.0, st["bsdf_pdf"]),
        tdist=torch.where(granted, 0.0, st["tdist"]),
        active=active | granted,
    )
    if occ is not None:
        occ[min(it, OCC_LEN - 1)] = (active.shape[0] - n_dead + n_granted).to(torch.int32)
    ctrl[0] += n_granted
    ctrl[1] = 0


def _retire_plain(st, b, ctrl, out, steps, sl):
    active = st["active"]
    alive, visible = b["alive"], b["visible"]
    rr_gate = st["depth"] >= sl.rr_depth if sl.rr else torch.zeros_like(alive)
    rr_pcont = torch.where(rr_gate, b["rr_pcont"], 1.0)
    radiance = b["radiance"] + torch.where((visible & ~b["occluded"])[..., None], b["nee"], 0.0)
    seed, u_rr = rng.rand(b["seed"])
    throughput = b["throughput"]
    if sl.rr:
        alive = alive & ~(rr_gate & (u_rr >= rr_pcont))
        throughput = torch.where(
            alive[..., None], throughput / torch.clamp(rr_pcont, min=1e-9)[..., None], throughput
        )
    depth = st["depth"] + active.long()
    alive = alive & (depth < sl.max_depth)
    # Path termination: the firefly clamp, then the unit's radiance (lanes
    # still alive write their own spare row).
    died = active & ~alive
    lum = firefly_luminance(radiance)
    scale = torch.where(lum > sl.clamp, sl.clamp / torch.clamp(lum, min=1e-20), 1.0)
    lane = torch.arange(active.shape[0], device=active.device)
    out.index_copy_(0, torch.where(died, st["unit"], sl.total_units + lane),
                    radiance * scale[..., None])
    if steps is not None:
        steps.index_add_(0, torch.where(active, st["pix"] - sl.pix0, sl.n_pix), b["hit_steps"])
    ctrl[2] += active.sum() + visible.sum()
    ctrl[1] += alive.sum()
    st.update(radiance=radiance, throughput=throughput, seed=seed, depth=depth,
              bsdf_pdf=torch.where(alive, b["pdf_b"], st["bsdf_pdf"]), active=alive)


# ---------------------------------------------------------------------------
# CUDA kernels: build at first use, bind through ctypes, launch.
# ---------------------------------------------------------------------------

_lib = None
_P = ctypes.c_void_p
_REGEN_PTRS = FIELDS + ("active", "ctrl", "occ", "scratch", "camera")
_RETIRE_IN = ("alive", "visible", "occluded", "radiance", "throughput", "nee", "rr_pcont",
              "pdf_b", "seed", "hit_steps")
_RETIRE_STATE = ("active", "pix", "unit", "st_radiance", "st_throughput", "st_seed", "depth",
                 "bsdf_pdf", "out", "steps", "ctrl")


class _RegenArgs(ctypes.Structure):
    """``csrc/wavefront.cu``'s RegenArgs, field for field."""

    _fields_ = (
        [(k, _P) for k in _REGEN_PTRS]
        + [(k, ctypes.c_int64) for k in ("n", "total_units", "spp", "pix0", "stream", "width",
                                         "height", "tiles_x")]
        + [(k, ctypes.c_int32) for k in ("tiled", "frame0", "it")]
    )


class _RetireArgs(ctypes.Structure):
    """``csrc/wavefront.cu``'s RetireArgs, field for field."""

    _fields_ = (
        [(k, _P) for k in _RETIRE_IN + _RETIRE_STATE]
        + [(k, ctypes.c_int64) for k in ("n", "pix0", "rr_depth", "max_depth")]
        + [("clamp", ctypes.c_float), ("rr", ctypes.c_int32)]
    )


def build(verbose: bool = False) -> str:
    """Compile ``csrc/wavefront.cu`` into ``_build/libwavefront.so`` when the
    library is missing or older than its source. Returns the library path."""
    return cuda_build.build("wavefront", "wavefront.cu", verbose=verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, args in (("regenerate", _RegenArgs), ("retire", _RetireArgs)):
            entry = getattr(lib, f"vkrt_{name}")
            entry.argtypes = [ctypes.POINTER(args), _P]
            entry.restype = ctypes.c_int
            size = getattr(lib, f"vkrt_{name}_args_size")()
            if size != ctypes.sizeof(args):
                raise RuntimeError(f"{args.__name__}: {size} bytes in the library, "
                                   f"{ctypes.sizeof(args)} in the binding")
        lib.vkrt_regenerate_scratch_words.argtypes = [ctypes.c_int64]
        lib.vkrt_regenerate_scratch_words.restype = ctypes.c_int64
        _lib = lib
    return _lib


def _ptr(name, x, shape, dtype, dev):
    if x is None:
        return None
    if (x.device != dev or x.dtype != dtype or tuple(x.shape) != tuple(shape)
            or not x.is_contiguous()):
        raise ValueError(f"{name}: want contiguous {dtype} {tuple(shape)} on {dev}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    return x.data_ptr()


_STATE_TYPES = dict(pix=torch.int64, unit=torch.int64, seed=torch.int64, depth=torch.int64,
                    bsdf_pdf=torch.float32, tdist=torch.float32, active=torch.bool)


def _state_ptr(st, k, n, dev):
    vec = k in ("origin", "direction", "radiance", "throughput", "absorption")
    return _ptr(k, st[k], (n, 3) if vec else (n,), _STATE_TYPES.get(k, torch.float32), dev)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _regenerate_cuda(st, ctrl, occ, it, sl):
    if st["active"].shape[0]:
        launch("regenerate", regenerate_args(st, ctrl, occ, it, sl))


def _retire_cuda(st, b, ctrl, out, steps, sl):
    if st["active"].shape[0]:
        launch("retire", retire_args(st, b, ctrl, out, steps, sl))


# The regeneration scan's scratch per (device, stream): zeroed when made and
# never reset, since each launch stamps what it publishes with its own epoch
# and takes its ticket counter back to 0; grown for a larger pool.
_SCRATCH = {}
_SCRATCH_LOCK = threading.Lock()


def _scan_scratch(dev, n):
    words = _load().vkrt_regenerate_scratch_words(n)
    key = (dev, _stream(dev))
    with _SCRATCH_LOCK:
        scratch = _SCRATCH.get(key)
        if scratch is None or scratch.numel() < words:
            scratch = _SCRATCH[key] = torch.zeros(words, dtype=torch.int64, device=dev)
    return scratch


def regenerate_args(st, ctrl, occ, it, sl):
    """``vkrt_regenerate``'s checked arguments on a pool of at least one
    lane, holding the scan's scratch."""
    dev = st["active"].device
    n = st["active"].shape[0]
    scratch = _scan_scratch(dev, n)
    a = _RegenArgs(
        *(_state_ptr(st, k, n, dev) for k in FIELDS + ("active",)),
        _ptr("ctrl", ctrl, (3,), torch.int64, dev), _ptr("occ", occ, (OCC_LEN,), torch.int32, dev),
        scratch.data_ptr(), _ptr("camera", sl.camera_rows, (34,), torch.float32, dev),
        n, sl.total_units, sl.spp, sl.pix0, sl.stream, sl.width, sl.height, sl.width // 8,
        int(sl.tiled), int(sl.frame == 0), it,
    )
    a.device, a.keep = dev, scratch
    return a


def retire_args(st, b, ctrl, out, steps, sl):
    """``vkrt_retire``'s checked arguments on a pool of at least one lane."""
    dev = st["active"].device
    n = st["active"].shape[0]
    f32, b8 = torch.float32, torch.bool
    ins = [_ptr(k, b[k], (n,), b8, dev) for k in ("alive", "visible", "occluded")]
    ins += [_ptr(k, b[k], (n, 3), f32, dev) for k in ("radiance", "throughput", "nee")]
    ins += [_ptr(k, b[k], (n,), f32, dev) for k in ("rr_pcont", "pdf_b")]
    ins += [_ptr("seed", b["seed"], (n,), torch.int64, dev),
            _ptr("hit_steps", b.get("hit_steps") if steps is not None else None, (n,),
                 torch.int32, dev)]
    state = [_state_ptr(st, k, n, dev) for k in ("active", "pix", "unit", "radiance",
                                                  "throughput", "seed", "depth", "bsdf_pdf")]
    state += [_ptr("out", out, (out.shape[0], 3), f32, dev),
              _ptr("steps", steps, (sl.n_pix + 1,), torch.int32, dev),
              _ptr("ctrl", ctrl, (3,), torch.int64, dev)]
    if out.shape[0] < sl.total_units + n:
        raise ValueError(f"out: want at least {sl.total_units + n} rows, got {out.shape[0]}")
    a = _RetireArgs(*ins, *state, n, sl.pix0, sl.rr_depth, sl.max_depth, sl.clamp, int(sl.rr))
    a.device = dev
    return a


def launch(name: str, a) -> None:
    """Launch ``vkrt_<name>`` ("regenerate" or "retire") on arguments from
    :func:`regenerate_args` / :func:`retire_args` and count it."""
    err = getattr(_load(), f"vkrt_{name}")(ctypes.byref(a), _stream(a.device))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1
