"""The port's JPEG decoder (``vk_raytrace_torch/utils/jpeg.py`` over
``csrc/native.cpp::jpeg_decode``) against Pillow's
``Image.open(...).convert("RGBA")``, array for array: JPEGs that Pillow
writes here at qualities 50 and 95 in 4:4:4, 4:2:2 and 4:2:0 and grey, at
sizes that are not multiples of the MCU, baseline and progressive (with
optimised Huffman tables too); restart intervals; 4:4:0 (a 4:2:2 stream
whose frame header is rewritten to 1x2 luma sampling, its MCU grid
transposed: Pillow does not write 4:4:0); an EXIF segment; CMYK (Pillow's
own, its Adobe segment removed, or its transform set to YCCK). The forms
Pillow cannot write come from the small encoders of
``tests/jpeg_encoders.py``, Pillow's decoding of the same bytes the judge:
arithmetic-coded sequential and progressive frames (with restart intervals
and DAC conditioning) and lossless frames (every predictor, point
transforms, restarts, components sampled 1x1 or above, which Pillow
upsamples by repetition). The forms Pillow rejects (hierarchical frames,
arithmetic lossless, 12- and 16-bit samples, lossless YCbCr and YCCK)
raise in the reference (which decodes through Pillow) and in the port,
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

import jpeg_encoders as enc  # noqa: E402


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


def _reference_decode(data):
    """The reference's texture decoding (``vk_raytrace_tpu/models/gltf.py::
    _decode_image``, Pillow), of a data-URI image."""
    import base64

    from vk_raytrace_tpu.models.gltf import _decode_image

    doc = {"images": [{"uri": "data:image/jpeg;base64," + base64.b64encode(data).decode()}]}
    return _decode_image(None, doc, 0)


def _sof_patched(data, sof=None, precision=None):
    i = data.index(b"\xff\xc0") if b"\xff\xc0" in data else data.index(b"\xff\xc3")
    if sof is not None:
        data = data[:i + 1] + bytes([sof]) + data[i + 2:]
    if precision is not None:
        data = data[:i + 4] + bytes([precision]) + data[i + 5:]
    return data


def _rejected_forms():
    base = _jpeg(33, 31, "RGB", seed=2)
    lossless = enc.lossless_jpeg(_pixels(13, 11, 3, 3), 4)
    forms = {f"SOF{m - 0xC0}": (_sof_patched(base, sof=m), rf"a .*\(SOF{m - 0xC0}\) JPEG")
             for m in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF)}
    forms["SOF11"] = (_sof_patched(lossless, sof=0xCB), r"a arithmetic lossless \(SOF11\) JPEG")
    forms["12-bit"] = (_sof_patched(base, precision=12), r"a .* JPEG of 12-bit samples")
    forms["12-bit lossless"] = (_sof_patched(lossless, precision=12), r"a .* JPEG of 12-bit samples")
    forms["16-bit lossless"] = (_sof_patched(lossless, precision=16), r"a .* JPEG of 16-bit samples")
    return forms


def test_arithmetic_and_12bit_jpeg_raise_naming_the_image():
    """Frames that neither the reference (Pillow) nor the port decodes,
    made by rewriting a stream's frame header: arithmetic-coded lossless
    (SOF11), hierarchical (SOF5-7, SOF13-15) and 12- or 16-bit samples;
    the port names the image and the frame."""
    for label, (data, pattern) in _rejected_forms().items():
        with pytest.raises(Exception):
            _reference_decode(data)
        with pytest.raises(RuntimeError, match=r"image 7 of scene\.glb: " + pattern):
            png.decode_image(data, "image 7 of scene.glb")


def test_cmyk_jpeg_raises_naming_the_image():
    """A lossless frame in YCbCr (a JFIF segment) or YCCK (an Adobe segment
    of transform 2): libjpeg converts no colour in a lossless image, so the
    reference raises, and the port raises naming the image."""
    px = _pixels(13, 11, 4, 4)
    jfif = enc._seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    adobe = enc._seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x02")
    for data, space in ((enc.lossless_jpeg(px[..., :3], 1, app=jfif), "YCbCr"),
                        (enc.lossless_jpeg(px, 1, app=adobe, ids=(1, 2, 3, 4)), "YCCK")):
        with pytest.raises(Exception):
            _reference_decode(data)
        with pytest.raises(RuntimeError, match=rf"image 2: a lossless \(SOF3\) JPEG in {space}"):
            png.decode_image(data, "image 2")


QUANT = {"fine": [np.ones((8, 8), int), np.full((8, 8), 2)],
         "coarse": [np.full((8, 8), 4), np.full((8, 8), 8)]}
ARITH_FORMS = {
    "grey": [(1, 1, 1, 0)],
    "444": [(1, 1, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1)],
    "422": [(1, 2, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1)],
    "420": [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)],
    "cmyk": [(1, 1, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1), (4, 1, 1, 0)],
}


@pytest.mark.parametrize("progressive", (False, True))
@pytest.mark.parametrize("form", sorted(ARITH_FORMS))
@pytest.mark.parametrize("case", ("plain", "restart_dac"))
def test_arithmetic_jpeg_matches_pil(form, progressive, case):
    """Arithmetic-coded frames (SOF9 / SOF10, the QM decoder and its
    statistics model) from random coefficients at two quantisations, with
    a restart interval and DAC conditioning in one case: the same RGBA
    array as Pillow's (the CMYK form through an Adobe segment)."""
    comps = ARITH_FORMS[form]
    size = (37, 29) if case == "plain" else (61, 23)
    quant = QUANT["coarse" if progressive else "fine"]
    coefs = enc.random_coefficients(*size, comps, len(form) * 7 + progressive, quant)
    app = enc._seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00") if form == "cmyk" else b""
    kw = dict(restart=3, dac=(1, 3, 9)) if case == "restart_dac" else {}
    _check(enc.arithmetic_jpeg(*size, comps, coefs, quant, progressive=progressive, app=app, **kw))


@pytest.mark.parametrize("predictor", range(1, 8))
@pytest.mark.parametrize("chans", (1, 3))
def test_lossless_jpeg_matches_pil(predictor, chans):
    """Lossless frames (SOF3): each predictor, a point transform and a
    restart interval of whole rows varying with it; grey and RGB (component
    ids 1-3: without a JFIF segment libjpeg reads a lossless frame as RGB)."""
    px = _pixels(21, 17, 3, predictor)
    img = px[..., 0] if chans == 1 else px
    _check(enc.lossless_jpeg(img, predictor, pt=predictor % 3, restart=21 * (predictor % 3)))


# Sampling factors of a lossless frame's three components.
LOSSLESS_SAMPLING = {"2x1": ((2, 1), (1, 1), (1, 1)), "2x2": ((2, 2), (1, 1), (1, 1)),
                     "1x2": ((1, 2), (1, 1), (1, 1)), "chroma_2x2": ((1, 1), (2, 2), (2, 2))}


@pytest.mark.parametrize("predictor", (1, 4, 7))
@pytest.mark.parametrize("sampling", sorted(LOSSLESS_SAMPLING))
def test_subsampled_lossless_jpeg_matches_pil(predictor, sampling):
    """Lossless frames (SOF3) whose components are sampled above 1x1, as
    Pillow decodes them (each subsampled component's samples repeated):
    sizes that leave partial MCUs and whole ones, a point transform, and a
    restart interval of whole MCU rows."""
    factors = LOSSLESS_SAMPLING[sampling]
    hmax, vmax = (max(f[k] for f in factors) for k in (0, 1))
    for w, h, pt, rows in ((21, 17, 0, 0), (20, 16, predictor % 3, 2), (3, 2, 1, 1)):
        img = _pixels(w, h, 3, predictor + w)
        restart = rows * -(-w // hmax)
        _check(enc.lossless_jpeg(img, predictor, pt=pt, restart=restart, sampling=factors))


@pytest.mark.parametrize("variant", ("adobe", "no_adobe", "ycck", "progressive_ycck"))
@pytest.mark.parametrize("size", ((21, 19), (64, 48)))
def test_cmyk_and_ycck_jpeg_match_pil(variant, size):
    """Four components: Pillow's CMYK JPEG (an Adobe segment of transform
    0), the same without the segment, and with its transform set to 2
    (YCCK, which libjpeg converts to CMYK); Pillow inverts every channel
    and converts CMYK to RGB with K."""
    kw = dict(quality=85, progressive=variant == "progressive_ycck")
    data = _jpeg(*size, "CMYK", seed=size[0], **kw)
    i = data.index(b"\xff\xee")
    if variant == "no_adobe":
        data = data[:i] + data[i + 2 + ((data[i + 2] << 8) | data[i + 3]):]
    elif variant != "adobe":
        data = data[:i + 15] + b"\x02" + data[i + 16:]
        assert data[i + 4:i + 9] == b"Adobe"
    _check(data)


def test_new_forms_decode_without_pillow(monkeypatch):
    """Arithmetic, lossless and CMYK frames, with Pillow hidden, decode to
    Pillow's arrays (taken before hiding it)."""
    quant = QUANT["fine"]
    comps = ARITH_FORMS["420"]
    cases = [enc.arithmetic_jpeg(37, 29, comps, enc.random_coefficients(37, 29, comps, 1, quant),
                                 quant, progressive=True),
             enc.lossless_jpeg(_pixels(21, 17, 3, 2), 7, pt=1),
             _jpeg(33, 31, "CMYK", seed=3, quality=90)]
    want = [_pil(d) for d in cases]
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    for data, ref in zip(cases, want):
        assert np.array_equal(png.decode_image(data, "texture"), ref)


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
