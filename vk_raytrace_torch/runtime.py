"""The port's binding to the native host builders (C++ through ctypes).

``csrc/native.cpp`` holds the hot host loops: binned-SAH BVH rows (the
wide back end's 8-wide rows and the planar 16- or 32-wide ones), oct encoding, RGBA8 packing and smooth normals (the port's
own copy of the reference's host runtime, trimmed to these calls), the
PNG decoder's scanline reconstruction and the JPEG decoder. It is compiled with g++
into ``vk_raytrace_torch/_build/libnative.so`` (rebuilt when the source is
newer) and bound here. There is no numpy fallback: every call raises when
the library cannot be built or loaded.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from . import cuda_build

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "csrc", "native.cpp")
_LIB_PATH = os.path.join(cuda_build.BUILD_DIR, "libnative.so")
_lib = None


def build() -> str:
    """Compile ``csrc/native.cpp`` into ``_build/libnative.so`` when the
    library is missing or older than the source. Returns the library path."""
    cuda_build.compile_if_stale(
        _LIB_PATH, _SRC, ["g++", "-O3", "-march=x86-64-v2", "-shared", "-fPIC"]
    )
    return _LIB_PATH


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.build_bvh8.restype = ctypes.c_int64
        lib.build_bvh16.restype = ctypes.c_int64
        lib.build_bvh32.restype = ctypes.c_int64
        lib.png_unfilter.restype = ctypes.c_int64
        lib.jpeg_decode.restype = ctypes.c_int64
        _lib = lib
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def oct_encode(vecs: np.ndarray) -> np.ndarray:
    """Octahedral-compress unit vectors (n, 3) f32 -> (n,) u32."""
    vecs = np.ascontiguousarray(vecs, np.float32)
    out = np.empty(len(vecs), np.uint32)
    _load().oct_encode_batch(_ptr(vecs), ctypes.c_int64(len(vecs)), _ptr(out))
    return out


def pack_rgba8(colors: np.ndarray) -> np.ndarray:
    """(n, 4) f32 in [0, 1] -> (n,) u32 RGBA8."""
    colors = np.ascontiguousarray(colors, np.float32)
    out = np.empty(len(colors), np.uint32)
    _load().pack_rgba8(_ptr(colors), ctypes.c_int64(len(colors)), _ptr(out))
    return out


def smooth_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals; (nv,3) f64 + (nt,3) i64 -> (nv,3) f64."""
    positions = np.ascontiguousarray(positions, np.float64)
    indices = np.ascontiguousarray(indices, np.int64)
    out = np.empty_like(positions)
    _load().smooth_normals(
        _ptr(positions), ctypes.c_int64(len(positions)),
        _ptr(indices), ctypes.c_int64(len(indices)), _ptr(out),
    )
    return out


def png_unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG filters of ``h`` scanlines, each a filter-type byte and
    ``stride`` bytes, ``bpp`` bytes per pixel: (h, stride) uint8. Raises on
    a truncated stream or an unknown filter type."""
    if len(raw) < h * (stride + 1):
        raise ValueError(f"{len(raw)} bytes of image data, {h * (stride + 1)} needed")
    src = np.frombuffer(raw, np.uint8, count=h * (stride + 1))
    out = np.empty((h, stride), np.uint8)
    bad = _load().png_unfilter(_ptr(src), ctypes.c_int64(h), ctypes.c_int64(stride),
                               ctypes.c_int64(bpp), _ptr(out))
    if bad:
        raise ValueError(f"unknown PNG filter type in scanline {bad - 1}")
    return out


def jpeg_decode(data: bytes, w: int, h: int, ycc: bool) -> tuple:
    """Decode a JPEG of ``w`` x ``h`` pixels: ``(error code, (h, w, 4)
    uint8 RGBA)``, the code 0 on success (the codes are ``jpeg::Err`` in
    ``csrc/native.cpp``). ``ycc``: three components are YCbCr, converted to
    RGB; four are YCCK, converted to CMYK."""
    src = np.frombuffer(data, np.uint8)
    out = np.empty((h, w, 4), np.uint8)
    code = _load().jpeg_decode(_ptr(src), ctypes.c_int64(len(src)), ctypes.c_int64(int(ycc)),
                               _ptr(out), ctypes.c_int64(w), ctypes.c_int64(h))
    return int(code), out


def _check_id_ceiling(max_orig: int) -> None:
    """A triangle id rides in an f32 leaf lane as ``orig*4 + flags``, exact
    only below ``2**24``: at most ``2**22`` triangles per id space."""
    if max_orig * 4 + 3 >= 2**24:
        raise ValueError(f"triangle id {max_orig} exceeds the exact-f32 ceiling {2**22 - 1}; "
                         "instance repeated geometry or split the scene")


def _host_tris(positions, indices, uv, tri_flags, tri_ids):
    """Contiguous builder inputs and the largest triangle id."""
    positions = np.ascontiguousarray(positions, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    uv = np.ascontiguousarray(uv, np.float32)
    tri_flags = np.ascontiguousarray(tri_flags, np.int32)
    max_orig = len(indices) - 1
    if tri_ids is not None:
        tri_ids = np.ascontiguousarray(tri_ids, np.int32)
        max_orig = int(tri_ids.max(initial=0))
    _check_id_ceiling(max_orig)
    return positions, indices, uv, tri_flags, tri_ids


def build_bvh8_rows(positions, indices, uv, tri_flags, tri_ids=None) -> np.ndarray:
    """Binned-SAH build of the wide back end's 8-wide rows (256 B: 8 child
    boxes and refs, or a leaf of 4 packed triangles; ``ops/bvh8.py::
    WideScene``). Returns (n_rows, 64) f32, row 0 the root.

    Triangle ids ride in f32 leaf lanes as ``orig*4 + flags`` and leaf refs
    as ``-(row*4 + count)``; both must stay exact in f32, so the build
    raises past those ceilings."""
    positions, indices, uv, tri_flags, tri_ids = _host_tris(positions, indices, uv, tri_flags,
                                                            tri_ids)
    t = len(indices)
    for max_rows in (t + t // 3 + 16, 2 * t + 8):
        rows = np.empty((max_rows, 64), np.float32)
        n = _load().build_bvh8(
            _ptr(positions), _ptr(indices), _ptr(uv),
            None if tri_ids is None else _ptr(tri_ids), _ptr(tri_flags),
            ctypes.c_int64(t), _ptr(rows), ctypes.c_int64(max_rows),
        )
        if n > 0:
            _check_ref_ceiling(n, 4)
            return np.ascontiguousarray(rows[:n])
    raise RuntimeError("native 8-wide BVH build failed")


def build_planar_rows(positions, indices, uv, tri_flags, tri_ids=None, width=16):
    """Binned-SAH build of ``width``-wide planar rows (16: 512 B rows of
    8-triangle leaves; 32: 1024 B rows of 16-triangle leaves). Returns
    ``(rows (n, width*8) f32, stack_depth)``.

    Triangle ids ride in f32 leaf lanes as ``orig*4 + flags`` and child refs
    in interior lanes as ``row*(width/2) + count``; both must stay exact in
    f32, so the build raises past those ceilings."""
    if width not in (16, 32):
        raise ValueError(f"planar rows are 16 or 32 wide, not {width}")
    lib = _load()
    build = lib.build_bvh16 if width == 16 else lib.build_bvh32
    positions, indices, uv, tri_flags, tri_ids = _host_tris(positions, indices, uv, tri_flags,
                                                            tri_ids)
    t = len(indices)
    ids_arg = None if tri_ids is None else _ptr(tri_ids)
    leaf = width // 2
    depth = ctypes.c_int32(0)
    f = t + 1  # row bound: a leaf holds at least leaf/2 triangles
    for max_rows in (f // (leaf // 2) + f // leaf + 16, f + 8):
        rows = np.empty((max_rows, width * 8), np.float32)
        n = build(
            _ptr(positions), _ptr(indices), _ptr(uv), ids_arg, _ptr(tri_flags),
            ctypes.c_int64(t), _ptr(rows), ctypes.c_int64(max_rows),
            ctypes.byref(depth), ctypes.c_float(0.0),
        )
        if n > 0:
            _check_ref_ceiling(n, leaf)
            return np.ascontiguousarray(rows[:n]), int(depth.value)
    raise RuntimeError("native planar BVH build failed")


def _check_ref_ceiling(n_rows: int, leaf_slots: int) -> None:
    """A leaf ref ``-(row * leaf_slots + count)`` rides in an f32 lane, so a
    table (or a concatenation of tables sharing one ref space) of
    ``n_rows`` rows must keep ``n_rows * leaf_slots + leaf_slots < 2**23``."""
    if n_rows * leaf_slots + leaf_slots >= 2**23:
        raise ValueError(
            f"{n_rows} BVH rows exceed the exact-f32 ref ceiling of "
            f"{2**23 // leaf_slots - 1}; instance repeated geometry or split the scene"
        )
