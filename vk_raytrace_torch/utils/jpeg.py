"""JPEG decoding without Pillow (the card's machine has none).

:func:`decode_rgba` decodes Huffman-coded JPEG, baseline, extended
sequential and progressive (SOF0 / SOF1 / SOF2), of 8-bit samples, grey or three-component, at any sampling
factors whose ratios are integers (4:4:4, 4:2:2, 4:2:0, 4:4:0, ...), with
restart intervals, at any size, into (H, W, 4) uint8 RGBA. It returns what
Pillow's ``Image.open(...).convert("RGBA")`` returns for the same file, array
for array (``tests/test_torch_jpeg.py``): the decoding, the integer IDCT, the
fancy upsampling and the colour conversion run in ``csrc/native.cpp`` in
libjpeg-turbo's own integer arithmetic (``runtime.jpeg_decode``). Three
components are YCbCr or RGB by libjpeg's rule (a JFIF segment, else an
Adobe segment's transform, else the component ids).

Lossless, hierarchical and arithmetic-coded frames, 12-bit samples and four-component (CMYK / YCCK) images raise a
``RuntimeError`` naming the image and its frame type.
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
    """libjpeg's colour-space guess for three components
    (jdapimin.c default_decompress_parms)."""
    if hdr["jfif"]:
        return True
    if hdr["adobe_transform"] is not None:
        return hdr["adobe_transform"] != 0
    return tuple(hdr["ids"]) != (82, 71, 66)  # 'R', 'G', 'B'


def decode_rgba(data: bytes, name: str = "JPEG image"):
    """A JPEG file's bytes as (H, W, 4) uint8 RGBA; ``name`` labels errors."""
    from .. import runtime

    if not data.startswith(SOI):
        raise ValueError(f"{name}: not a JPEG file")
    hdr = frame_header(data, name)
    kind = _SOF_NAMES[hdr["sof"]]
    if hdr["sof"] not in (0xC0, 0xC1, 0xC2):
        raise RuntimeError(f"{name}: a {kind} JPEG; the port decodes Huffman-coded "
                           "sequential and progressive JPEG (SOF0 / SOF1 / SOF2) only")
    if hdr["precision"] != 8:
        raise RuntimeError(f"{name}: a {kind} JPEG of {hdr['precision']}-bit samples; the port "
                           "decodes 8-bit samples only")
    if len(hdr["ids"]) not in (1, 3):
        raise RuntimeError(f"{name}: a {kind} JPEG of {len(hdr['ids'])} components (CMYK or "
                           "YCCK); the port decodes grey and three-component images only")
    w, h = hdr["width"], hdr["height"]
    if w == 0 or h == 0:
        raise RuntimeError(f"{name}: a {kind} JPEG of size {w}x{h} (a DNL height is not "
                           "supported)")
    code, out = runtime.jpeg_decode(data, w, h, _is_ycc(hdr))
    if code:
        raise ValueError(f"{name}: not a valid {kind} JPEG: {_ERRORS.get(code, code)}")
    return out
