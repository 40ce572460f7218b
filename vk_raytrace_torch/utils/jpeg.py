"""JPEG decoding without Pillow (the card's machine has none).

:func:`decode_rgba` decodes the JPEG forms that Pillow decodes, into (H, W,
4) uint8 RGBA, array for array what Pillow's ``Image.open(...).convert(
"RGBA")`` returns for the same file (``tests/test_torch_jpeg.py``):

* Huffman-coded baseline, extended sequential and progressive frames
  (SOF0 / SOF1 / SOF2) and arithmetic-coded sequential and progressive
  frames (SOF9 / SOF10), at any sampling factors whose ratios are integers
  (4:4:4, 4:2:2, 4:2:0, 4:4:0, ...), with restart intervals;
* lossless frames (SOF3, Huffman-coded), at the same sampling factors
  (a subsampled component repeated, not interpolated, as libjpeg-turbo
  upsamples a lossless frame);
* 8-bit samples, grey, three components (YCbCr or RGB by libjpeg's rule: a
  JFIF segment, else an Adobe segment's transform, else the component ids)
  or four (CMYK, or YCCK by an Adobe segment's transform 2), at any size.

The decoding, the integer IDCT, the fancy upsampling and the colour
conversion run in ``csrc/native.cpp`` in libjpeg-turbo's own integer
arithmetic (``runtime.jpeg_decode``); four components then go through
Pillow's reading of them (every channel inverted, as Adobe's CMYK is) and
its CMYK to RGB conversion.

What Pillow does not decode raises a ``RuntimeError`` naming the image and
its frame type: hierarchical (differential) frames, arithmetic-coded
lossless frames, samples of other than 8 bits, and lossless frames in
YCbCr or YCCK (libjpeg converts no colour in a lossless image).
"""

from __future__ import annotations

SOI = b"\xff\xd8"

_SOF_NAMES = {
    0xC0: "baseline (SOF0)", 0xC1: "extended sequential (SOF1)", 0xC2: "progressive (SOF2)",
    0xC3: "lossless (SOF3)", 0xC5: "differential sequential (SOF5)",
    0xC6: "differential progressive (SOF6)", 0xC7: "differential lossless (SOF7)",
    0xC9: "arithmetic sequential (SOF9)", 0xCA: "arithmetic progressive (SOF10)",
    0xCB: "arithmetic lossless (SOF11)", 0xCD: "arithmetic differential sequential (SOF13)",
    0xCE: "arithmetic differential progressive (SOF14)",
    0xCF: "arithmetic differential lossless (SOF15)",
}
_ERRORS = {
    1: "the stream is truncated", 2: "no frame header", 3: "a bad frame header",
    4: "a bad quantisation, Huffman or restart table", 5: "a bad scan header",
    6: "sampling factors whose ratios are not integers", 7: "a bad image size",
}
_DECODED = (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA)


def frame_header(data: bytes, name: str) -> dict:
    """The frame header and colour-space markers of a JPEG stream: ``sof``
    (the marker byte), ``precision``, ``height``, ``width``, ``ids`` (the
    component ids), ``jfif`` and ``adobe_transform`` (None without an Adobe
    segment) as seen before the frame header."""
    pos, jfif, adobe = 2, False, None
    n = len(data)
    while pos < n:
        if data[pos] != 0xFF:
            pos += 1
            continue
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        m = data[pos]
        pos += 1
        if m == 0x01 or 0xD0 <= m <= 0xD7:
            continue
        if m == 0xD9 or pos + 2 > n:
            break
        length = (data[pos] << 8) | data[pos + 1]
        body = data[pos + 2:pos + length]
        if m == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif m == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif m in _SOF_NAMES:
            if len(body) < 6:
                break
            nc = body[5]
            return dict(sof=m, precision=body[0], height=(body[1] << 8) | body[2],
                        width=(body[3] << 8) | body[4],
                        ids=tuple(body[6 + 3 * c] for c in range(nc) if 6 + 3 * c < len(body)),
                        jfif=jfif, adobe_transform=adobe)
        pos += length
    raise ValueError(f"{name}: a JPEG stream without a frame header")


def _is_ycc(hdr: dict) -> bool:
    """libjpeg's colour-space guess (jdapimin.c default_decompress_parms):
    whether three components are YCbCr (rather than RGB), four YCCK
    (rather than CMYK). Without a JFIF or Adobe segment, three components
    are YCbCr unless their ids spell 'RGB' or the frame is lossless."""
    if len(hdr["ids"]) == 4:
        return hdr["adobe_transform"] is not None and hdr["adobe_transform"] != 0
    if hdr["jfif"]:
        return True
    if hdr["adobe_transform"] is not None:
        return hdr["adobe_transform"] != 0
    return hdr["sof"] != 0xC3 and tuple(hdr["ids"]) != (82, 71, 66)  # 'R', 'G', 'B'


def decode_rgba(data: bytes, name: str = "JPEG image"):
    """A JPEG file's bytes as (H, W, 4) uint8 RGBA; ``name`` labels errors."""
    from .. import runtime

    if not data.startswith(SOI):
        raise ValueError(f"{name}: not a JPEG file")
    hdr = frame_header(data, name)
    kind = _SOF_NAMES[hdr["sof"]]
    if hdr["sof"] not in _DECODED:
        raise RuntimeError(f"{name}: a {kind} JPEG; the port decodes the forms Pillow decodes: "
                           "sequential and progressive JPEG, Huffman- or arithmetic-coded "
                           "(SOF0 / SOF1 / SOF2 / SOF9 / SOF10), and lossless Huffman (SOF3)")
    if hdr["precision"] != 8:
        raise RuntimeError(f"{name}: a {kind} JPEG of {hdr['precision']}-bit samples; the port "
                           "decodes 8-bit samples only")
    nc = len(hdr["ids"])
    if nc not in (1, 3, 4):
        raise RuntimeError(f"{name}: a {kind} JPEG of {nc} components; the port decodes grey, "
                           "three- and four-component images")
    ycc = nc > 1 and _is_ycc(hdr)
    if hdr["sof"] == 0xC3 and ycc:
        raise RuntimeError(f"{name}: a {kind} JPEG in {'YCCK' if nc == 4 else 'YCbCr'}; "
                           "libjpeg converts no colour in a lossless image")
    w, h = hdr["width"], hdr["height"]
    if w == 0 or h == 0:
        raise RuntimeError(f"{name}: a {kind} JPEG of size {w}x{h} (a DNL height is not "
                           "supported)")
    code, out = runtime.jpeg_decode(data, w, h, ycc)
    if code:
        raise ValueError(f"{name}: not a valid {kind} JPEG: {_ERRORS.get(code, code)}")
    return out
