"""PNG decoding and encoding without Pillow (the card's machine has none).

:func:`decode_rgba` reads what the glTF loader's textures need: PNG files
in colour types 0 (grey), 2 (RGB), 3 (palette), 4 (grey + alpha) and 6
(RGBA) at every bit depth the format allows (1, 2, 4 and 8 in grey and
palette, 16 in every type but palette), non-interlaced or Adam7-interlaced;
scanline filters 0-4, and ``tRNS`` transparency. It returns what Pillow's
``Image.open(...).convert("RGBA")`` returns for the same file
(``tests/test_torch_gltf.py`` holds it so), Pillow's quirks included: a
16-bit sample keeps its high byte, but 16-bit grey clips at 255; a colour
key compares its low byte with the 8-bit samples (a 1-bit grey key is 0 or
255, a 2- or 4-bit one is held against the scaled samples).
:func:`decode_image` sends a JPEG to the port's own decoder
(``utils/jpeg.py``), whether or not Pillow is installed; another format
goes to Pillow where it can be imported, and otherwise raises naming the
image.

:func:`encode` and :func:`write_png` write an 8-bit PNG with filter 0 and
zlib, from a [0, 1] float image rounded as the reference's ``write_png``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Samples per pixel of each colour type.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# The Adam7 passes: (x0, y0, dx, dy) of the pixels each one carries.
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _chunks(data: bytes, name: str):
    """(type, payload) of each chunk after the signature, CRC checked."""
    pos = len(SIGNATURE)
    while pos + 12 <= len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError(f"{name}: truncated PNG chunk {ctype!r}")
        (crc,) = struct.unpack_from(">I", data, pos + 8 + length)
        if zlib.crc32(ctype + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{name}: PNG chunk {ctype!r} fails its CRC")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{name}: PNG stream ends without IEND")


def _samples(raw: bytes, w: int, h: int, ch: int, depth: int):
    """The (h, w, ch) samples of ``h`` filtered scanlines at the start of
    ``raw`` (an image, or one Adam7 pass of it) and the bytes they take:
    uint16 at depth 16, raw (unscaled) uint8 values otherwise."""
    from .. import runtime

    stride = (w * ch * depth + 7) // 8
    rows = runtime.png_unfilter(raw, h, stride, max(1, ch * depth // 8))
    if depth == 16:
        rows = rows.view(">u2").astype(np.uint16)
    elif depth < 8:
        # Samples packed from the high bits of each byte.
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        rows = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :w * ch]
    return rows.reshape(h, w, ch), h * (stride + 1)


def decode_rgba(data: bytes, name: str = "PNG image") -> np.ndarray:
    """A PNG file's bytes as (H, W, 4) uint8 RGBA; ``name`` labels errors."""
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{name}: not a PNG file")
    header, palette, trns, idat = None, None, None, []
    for ctype, body in _chunks(data, name):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = body
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    allowed = (1, 2, 4, 8) if ctype == 3 else (1, 2, 4, 8, 16) if ctype == 0 else (8, 16)
    if ctype not in _CHANNELS or depth not in allowed or interlace not in (0, 1):
        raise ValueError(f"{name}: not a valid PNG: bit depth {depth}, colour type {ctype}, "
                         f"interlace method {interlace}")
    ch = _CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    if interlace:
        px = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = max(0, (w - x0 + dx - 1) // dx), max(0, (h - y0 + dy - 1) // dy)
            if pw and ph:  # an empty pass has no scanlines, not even filter bytes
                sub, n = _samples(raw[pos:], pw, ph, ch, depth)
                px[y0::dy, x0::dx] = sub
                pos += n
    else:
        px = _samples(raw, w, h, ch, depth)[0]
    key = None
    if trns is not None and ctype in (0, 2) and len(trns) >= 2 * ch:
        key = np.asarray(struct.unpack(f">{ch}H", trns[:2 * ch]))
    if ctype == 0 and depth < 8:
        px = px * np.uint8(255 // ((1 << depth) - 1))  # grey scales to 0-255
        if depth == 1 and key is not None:
            key = np.full(1, 255 if key[0] else 0)  # a 1-bit key: 0 or 255
    if depth == 16:
        px = np.minimum(px, 255) if ctype == 0 else px >> 8
        px = px.astype(np.uint8)
    if key is not None:
        key = key & 0xFF

    out = np.empty((h, w, 4), np.uint8)
    alpha = out[..., 3]
    alpha[...] = 255
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{name}: palette PNG without PLTE")
        table = np.zeros((256, 4), np.uint8)
        table[:len(palette), :3] = palette
        table[:, 3] = 255
        if trns is not None:
            a = np.frombuffer(trns, np.uint8)[:256]
            table[:len(a), 3] = a
        return table[px[..., 0]]
    if ctype in (0, 4):
        out[..., :3] = px[..., :1]
        if ctype == 4:
            alpha[...] = px[..., 1]
        elif key is not None:
            alpha[px[..., 0] == key[0]] = 0
        return out
    out[..., :3] = px[..., :3]
    if ctype == 6:
        alpha[...] = px[..., 3]
    elif key is not None:
        alpha[(px == key).all(-1)] = 0
    return out


def decode_image(data: bytes, name: str) -> np.ndarray:
    """An image file's bytes as (H, W, 4) uint8 RGBA: PNG by
    :func:`decode_rgba`, JPEG by ``utils/jpeg.decode_rgba`` (never Pillow);
    another format (neither of glTF 2.0's two) through Pillow, which must
    then be importable, or the call raises naming ``name``."""
    from . import jpeg

    if data.startswith(SIGNATURE):
        return decode_rgba(data, name)
    if data.startswith(jpeg.SOI):
        return jpeg.decode_rgba(data, name)
    try:
        import io

        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"{name}: neither PNG nor JPEG, and no decoder for it: Pillow is not "
                           "installed (the port decodes PNG and JPEG itself)") from e
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def to_uint8(img01: np.ndarray) -> np.ndarray:
    """[0, 1] floats to uint8 as the reference's ``write_png`` rounds them."""
    return np.clip(np.asarray(img01) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def encode(u8: np.ndarray) -> bytes:
    """PNG bytes of an (H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA uint8
    image: bit depth 8, filter 0 on every scanline, zlib level 6."""
    u8 = np.ascontiguousarray(u8, np.uint8)
    if u8.ndim == 2:
        u8 = u8[..., None]
    h, w, ch = u8.shape
    ctype = {1: 0, 3: 2, 4: 6}[ch]
    raw = np.zeros((h, w * ch + 1), np.uint8)
    raw[:, 1:] = u8.reshape(h, w * ch)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    return (SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def write_png(path: str, img01: np.ndarray) -> None:
    """Write a [0, 1] float image to a PNG file."""
    with open(path, "wb") as f:
        f.write(encode(to_uint8(img01)))
