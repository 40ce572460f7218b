"""The port's JPEG decoder (``vk_raytrace_torch/utils/jpeg.py`` over
``csrc/native.cpp::jpeg_decode``) against Pillow's
``Image.open(...).convert("RGBA")``, array for array: JPEGs that Pillow
writes here at qualities 50 and 95 in 4:4:4, 4:2:2 and 4:2:0 and grey, at
sizes that are not multiples of the MCU, baseline and progressive (with
optimised Huffman tables too); restart intervals; 4:4:0 (a 4:2:2 stream
whose frame header is rewritten to 1x2 luma sampling, its MCU grid
transposed: Pillow does not write 4:4:0); an EXIF segment. The forms the
port does not decode (arithmetic coding, 12-bit samples, CMYK) raise
naming the image. The
committed ``tests/assets/jpeg_textures.glb`` loads in the port as in the
reference (every atlas array equal), and its textures decode to the Pillow
RGBA stored beside it, with Pillow hidden; so does the committed 2048 x
2048 texture, held against the SHA-256 of Pillow's RGBA."""

import io
import os
import sys

import numpy as np
import pytest
from PIL import Image

from test_torch_traverse import isolated_reference  # noqa: F401
from vk_raytrace_torch.utils import jpeg, png

ASSETS = os.path.join(os.path.dirname(__file__), "assets")
sys.path.insert(0, ASSETS)
import make_jpeg_glb  # noqa: E402


def _pixels(w, h, chans, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / (3.0 + c) + c) * np.cos(y / 4.0 - c)
                    for c in range(chans)], -1)
    return np.clip(img + rng.normal(0, 25, img.shape), 0, 255).astype(np.uint8)


def _jpeg(w, h, mode, seed=0, **kw):
    px = _pixels(w, h, 3 if mode == "RGB" else (4 if mode == "CMYK" else 1), seed)
    b = io.BytesIO()
    Image.fromarray(px if mode != "L" else px[..., 0], mode).save(b, "JPEG", **kw)
    return b.getvalue()


def _pil(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def _check(data, name="texture"):
    out = png.decode_image(data, name)
    ref = _pil(data)
    assert out.dtype == np.uint8 and out.shape == ref.shape, (out.shape, ref.shape)
    assert np.array_equal(out, ref), f"{int((out != ref).any(-1).sum())} pixels differ"


FORMS = {"444": ("RGB", 0), "422": ("RGB", 1), "420": ("RGB", 2), "grey": ("L", None)}


@pytest.mark.parametrize("quality", (50, 95))
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("size", ((17, 9), (33, 31), (64, 48), (1, 1), (2, 3)))
def test_jpeg_matches_pil(size, form, quality):
    mode, ss = FORMS[form]
    kw = dict(quality=quality) if ss is None else dict(quality=quality, subsampling=ss)
    _check(_jpeg(*size, mode, seed=size[0] * 7 + quality, **kw))


@pytest.mark.parametrize("extra", ({}, dict(optimize=True), dict(restart_marker_blocks=3)))
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("size", ((17, 9), (61, 45), (200, 131), (1, 1)))
def test_progressive_jpeg_matches_pil(size, form, extra):
    """Progressive scans (DC first and refinement, AC spectral bands first
    and refinement with end-of-band runs) into the same coefficients."""
    mode, ss = FORMS[form]
    kw = dict(quality=80, progressive=True, **extra)
    if ss is not None:
        kw["subsampling"] = ss
    data = _jpeg(*size, mode, seed=size[1] * 3 + 1, **kw)
    assert b"\xff\xc2" in data
    _check(data)


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("restart", (dict(restart_marker_rows=1), dict(restart_marker_blocks=1),
                                     dict(restart_marker_blocks=3)))
def test_jpeg_restart_intervals_match_pil(form, restart):
    mode, ss = FORMS[form]
    kw = dict(quality=85, **restart)
    if ss is not None:
        kw["subsampling"] = ss
    data = _jpeg(37, 29, mode, seed=3, **kw)
    assert b"\xff\xdd" in data and b"\xff\xd0" in data  # a DRI and an RST0 marker
    _check(data)


def _to_440(data, w2, h2):
    """A 4:2:2 stream (luma 2x1) rewritten to 4:4:0 (luma 1x2) at size
    ``w2`` x ``h2``: the same blocks per MCU and the same number of MCUs
    (the caller picks the size), so the entropy-coded data stays valid."""
    i = data.find(b"\xff\xc0")
    i = i if i >= 0 else data.index(b"\xff\xc2")
    out = bytearray(data)
    out[i + 5:i + 7] = h2.to_bytes(2, "big")
    out[i + 7:i + 9] = w2.to_bytes(2, "big")
    assert out[i + 11] == 0x21  # the luma component's sampling factors
    out[i + 11] = 0x12
    return bytes(out)


SIZES_440 = (((32, 24), (13, 41)), ((16, 8), (8, 16)), ((48, 40), (24, 80)), ((17, 9), (9, 31)))


def _blocks(w, h, factors):
    """Blocks of each component coded alone (a progressive AC scan):
    ``factors`` (h, v) per component."""
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    return [-(-(-(-w * fh // hmax)) // 8) * -(-(-(-h * fv // vmax)) // 8) for fh, fv in factors]


def _cases_440():
    """Sequential streams keep their meaning when the MCU count is kept; a
    progressive one also codes each component's blocks alone, so its
    counts must match too ((17, 9) -> (9, 31) does not: 6 luma blocks
    against 8)."""
    out = []
    for (w, h), (w2, h2) in SIZES_440:
        out.append(((w, h), (w2, h2), False))
        if _blocks(w, h, ((2, 1), (1, 1), (1, 1))) == _blocks(w2, h2, ((1, 2), (1, 1), (1, 1))):
            out.append(((w, h), (w2, h2), True))
    return out


@pytest.mark.parametrize("size, size_440, progressive", _cases_440())
@pytest.mark.parametrize("restart", (False, True))
def test_jpeg_440_matches_pil(size, size_440, progressive, restart):
    """4:4:0 runs libjpeg-turbo's h1v2 fancy upsampling."""
    kw = dict(restart_marker_blocks=2) if restart else {}
    data = _to_440(_jpeg(*size, "RGB", seed=5, quality=90, subsampling=1, progressive=progressive,
                         **kw), *size_440)
    assert Image.open(io.BytesIO(data)).size == size_440
    _check(data)


def test_jpeg_exif_segment_skipped():
    exif = Image.Exif()
    exif[0x010F] = "maker"
    exif[0x0110] = "model"
    data = _jpeg(33, 31, "RGB", seed=9, exif=exif.tobytes())
    assert b"Exif\x00\x00" in data
    _check(data)


def test_arithmetic_and_12bit_jpeg_raise_naming_the_image():
    """Frames the port does not decode, made by rewriting a baseline
    stream's frame header: arithmetic coding (SOF9) and 12-bit samples."""
    data = _jpeg(33, 31, "RGB", seed=2)
    i = data.index(b"\xff\xc0")
    arithmetic = data[:i + 1] + b"\xc9" + data[i + 2:]
    with pytest.raises(RuntimeError, match=r"image 7 of scene\.glb: a arithmetic sequential "
                                           r"\(SOF9\) JPEG"):
        png.decode_image(arithmetic, "image 7 of scene.glb")
    twelve = data[:i + 4] + b"\x0c" + data[i + 5:]
    with pytest.raises(RuntimeError, match=r"image 8: .*12-bit samples"):
        png.decode_image(twelve, "image 8")


def test_cmyk_jpeg_raises_naming_the_image():
    data = _jpeg(16, 16, "CMYK", seed=2)
    with pytest.raises(RuntimeError, match=r"image 2: .*4 components \(CMYK or YCCK\)"):
        png.decode_image(data, "image 2")


def test_other_formats_through_pillow_or_raise(monkeypatch):
    """A format that is neither PNG nor JPEG goes to Pillow, and without it
    raises naming the image; a JPEG stream without a frame raises."""
    b = io.BytesIO()
    Image.fromarray(_pixels(8, 8, 3, 0)).save(b, "BMP")
    assert np.array_equal(png.decode_image(b.getvalue(), "image 4"), _pil(b.getvalue()))
    with pytest.raises(ValueError, match="texture: a JPEG stream without a frame header"):
        png.decode_image(b"\xff\xd8\xff\xd9", "texture")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="image 4: neither PNG nor JPEG.*Pillow"):
        png.decode_image(b.getvalue(), "image 4")


def test_jpeg_decodes_without_pillow(monkeypatch):
    """With Pillow hidden, as on the card's machine, the decoder still
    returns Pillow's array (taken before hiding it)."""
    cases = [_jpeg(61, 45, "RGB", seed=1, quality=75, subsampling=2),
             _jpeg(33, 31, "L", seed=1, quality=50),
             _jpeg(61, 45, "RGB", seed=1, quality=75, progressive=True)]
    want = [_pil(d) for d in cases]
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError):
        import PIL.Image  # noqa: F401
    for data, ref in zip(cases, want):
        assert np.array_equal(png.decode_image(data, "texture"), ref)


def test_committed_asset_matches_its_npy(monkeypatch):
    """``jpeg_textures.glb``'s textures, written by Pillow with
    ``make_jpeg_glb.py``, decode to the Pillow RGBA committed beside them
    (what ``chip_smoke.py`` checks on the card's machine), with Pillow
    hidden."""
    import json
    import struct

    with open(make_jpeg_glb.GLB, "rb") as f:
        glb = f.read()
    (js_len,) = struct.unpack_from("<I", glb, 12)
    doc = json.loads(glb[20:20 + js_len])
    blob = glb[20 + js_len + 8:]
    images = [blob[doc["bufferViews"][im["bufferView"]]["byteOffset"]:][
        :doc["bufferViews"][im["bufferView"]]["byteLength"]] for im in doc["images"]]
    assert len(images) == len(make_jpeg_glb.TEXTURES) == 5
    monkeypatch.setitem(sys.modules, "PIL", None)
    for k, data in enumerate(images):
        assert np.array_equal(png.decode_image(data, f"image {k}"), np.load(make_jpeg_glb.npy_path(k)))


def test_committed_2k_texture_matches_pillow(monkeypatch):
    """The texture at the size a scene loads (``jpeg_2k_420.jpg``, 2048 x
    2048 4:2:0): Pillow's RGBA of it hashes to the committed digest, and the
    port's decoder, with Pillow hidden, returns the same bytes (what
    ``chip_smoke.py`` phase 34 checks and times on the card's machine)."""
    with open(make_jpeg_glb.BIG_JPEG, "rb") as f:
        data = f.read()
    with open(make_jpeg_glb.BIG_SHA) as f:
        digest = f.read().strip()
    assert make_jpeg_glb.rgba_digest(_pil(data)) == digest
    monkeypatch.setitem(sys.modules, "PIL", None)
    out = png.decode_image(data, "jpeg_2k_420.jpg")
    assert out.shape == (2048, 2048, 4) and make_jpeg_glb.rgba_digest(out) == digest


@pytest.mark.parametrize("mode", ("bake", "auto"))
def test_jpeg_gltf_matches_reference(mode):
    """The reference decodes the JPEG textures through Pillow, the port
    through its own decoder: every array of the loaded scene (the atlas
    among them) is equal."""
    from test_torch_gltf import _check_file

    geom, mats, lights, cam, atlas = _check_file(make_jpeg_glb.GLB, modes=(mode,))
    assert atlas is not None and len(np.asarray(mats.ior)) == 5
    assert jpeg.frame_header(make_jpeg_glb.jpeg_bytes(2), "grey")["ids"] == (1,)
