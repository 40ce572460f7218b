"""The scenes of BASELINE configurations #2 and #4 and the HDR helpers of the
port against the reference, array for array: ``material_test_grid``
(#4), ``helmet_scene`` (#2) at reduced tessellation, ``procedural_sky_hdr``,
and ``load_hdr`` on Radiance files the test writes (run-length and flat
scanlines). All are numpy on both sides with the same seeds, so equality is
exact: same dtype, same bytes.
"""

import dataclasses

import numpy as np
import pytest

from vk_raytrace_tpu.models import hdr as ref_hdr
from vk_raytrace_tpu.models import procedural as ref_proc
from vk_raytrace_torch.models import hdr as port_hdr
from vk_raytrace_torch.models import procedural as port_proc


def _assert_same(port, ref, path="scene"):
    """Field by field (dataclass vs NamedTuple), exact."""
    if dataclasses.is_dataclass(port):
        for f in dataclasses.fields(port):
            _assert_same(getattr(port, f.name), getattr(ref, f.name), f"{path}.{f.name}")
    elif port is None:
        assert ref is None, path
    else:
        a, b = np.asarray(port), np.asarray(ref)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("n", [2, 5])
def test_material_test_grid_matches_reference(n):
    port, ref = port_proc.material_test_grid(n=n), ref_proc.material_test_grid(n=n)
    for p, r, what in zip(port, ref, ("geometry", "materials", "lights", "camera")):
        _assert_same(p, r, what)
    rows = n * n
    assert len(port[0].indices) == rows * 2208 + 2
    tm = np.asarray(port[1].transmission_factor)
    assert (tm[:rows] > 0).sum() == (n if n == 5 else 0)  # the glass row is the fifth


@pytest.mark.parametrize("n_lat,n_lon", [(8, 16), (24, 48)])
def test_helmet_scene_matches_reference(n_lat, n_lon):
    port = port_proc.helmet_scene(n_lat=n_lat, n_lon=n_lon)
    ref = ref_proc.helmet_scene(n_lat=n_lat, n_lon=n_lon)
    for p, r, what in zip(port, ref, ("geometry", "materials", "lights", "camera", "atlas")):
        _assert_same(p, r, what)
    assert len(port[0].indices) == 2 * n_lon * (n_lat - 1) + 2


@pytest.mark.parametrize("kw", [{}, dict(h=32, w=64, sun_dir=(-0.5, 0.4, 0.2))])
def test_procedural_sky_hdr_matches_reference(kw):
    port, ref = port_hdr.procedural_sky_hdr(**kw), ref_hdr.procedural_sky_hdr(**kw)
    assert port.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(port, ref)


def _rle_channel(vals: np.ndarray) -> bytes:
    """New-style RLE of one channel of a scanline: runs of >= 3 equal bytes
    as (128 + n, value), the rest as literal packets (n, bytes...)."""
    out, i, n = bytearray(), 0, len(vals)
    while i < n:
        j = i
        while j < n and j - i < 127 and vals[j] == vals[i]:
            j += 1
        if j - i >= 3:
            out += bytes([128 + j - i, vals[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and vals[j] == vals[j + 1] == vals[j + 2]):
            j += 1
        out += bytes([j - i]) + bytes(vals[i:j])
        i = j
    return bytes(out)


def _write_hdr(path, rgbe: np.ndarray, rle: bool):
    h, w = rgbe.shape[:2]
    body = bytearray()
    for y in range(h):
        if rle:
            body += bytes([2, 2, w >> 8, w & 255])
            for c in range(4):
                body += _rle_channel(rgbe[y, :, c])
        else:
            body += rgbe[y].tobytes()
    head = f"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y {h} +X {w}\n".encode()
    path.write_bytes(head + bytes(body))


@pytest.mark.parametrize("h,w,rle", [(6, 40, True), (5, 7, False), (4, 16, False)])
def test_load_hdr_matches_reference(tmp_path, h, w, rle):
    r = np.random.default_rng(h * 100 + w)
    rgbe = r.integers(0, 256, (h, w, 4), dtype=np.uint8)
    rgbe[..., 3] = r.integers(100, 160, (h, w))
    rgbe[0, : w // 2] = rgbe[0, 0]   # a run in every channel
    rgbe[-1, -1, 3] = 0              # a zero exponent decodes to black
    path = tmp_path / "env.hdr"
    _write_hdr(path, rgbe, rle)
    port, ref = port_hdr.load_hdr(str(path)), ref_hdr.load_hdr(str(path))
    assert port.dtype == np.float32 and port.shape == (h, w, 3)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port, port_hdr._rgbe_to_float(rgbe))
    assert (port[-1, -1] == 0).all()


def test_load_hdr_refuses_other_files(tmp_path):
    path = tmp_path / "not.hdr"
    path.write_bytes(b"P6\n1 1\n255\n\x00\x00\x00")
    with pytest.raises(IOError):
        port_hdr.load_hdr(str(path))
