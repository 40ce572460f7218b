"""PNG decoding and encoding without Pillow (the card's machine has none).

:func:`decode_rgba` reads what the glTF loader's textures need: PNG files,
non-interlaced, bit depth 8 in colour types 0 (grey), 2 (RGB), 3
(palette), 4 (grey + alpha) and 6 (RGBA), and bit depths 1, 2 and 4 in
types 0 and 3; scanline filters 0-4, and ``tRNS`` transparency. It returns
what Pillow's ``Image.open(...).convert("RGBA")`` returns for the same file
(``tests/test_torch_gltf.py`` holds it so). Any other form of PNG (16-bit
samples, Adam7 interlacing) raises.
:func:`decode_image` routes other formats (JPEG, ...) to Pillow where it
can be imported, and otherwise raises naming the image.

:func:`encode` and :func:`write_png` write an 8-bit PNG with filter 0 and
zlib, from a [0, 1] float image rounded as the reference's ``write_png``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Channels of each colour type at bit depth 8.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


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


def decode_rgba(data: bytes, name: str = "PNG image") -> np.ndarray:
    """A PNG file's bytes as (H, W, 4) uint8 RGBA; ``name`` labels errors."""
    from .. import runtime

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
    if ctype not in _CHANNELS or not (depth == 8 or (ctype in (0, 3) and depth in (1, 2, 4))):
        raise ValueError(f"{name}: PNG of bit depth {depth} and colour type {ctype} is not "
                         "supported (8-bit samples, or 1, 2 or 4 bits of grey or palette)")
    if interlace:
        raise ValueError(f"{name}: interlaced (Adam7) PNG is not supported")
    ch = _CHANNELS[ctype]
    stride = (w * ch * depth + 7) // 8
    rows = runtime.png_unfilter(zlib.decompress(b"".join(idat)), h, stride, max(1, ch * depth // 8))
    if depth < 8:
        # Samples packed from the high bits of each byte; grey scales to 0-255.
        per = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        rows = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, stride * per)[:, :w]
        if ctype == 0:
            rows = rows * np.uint8(255 // ((1 << depth) - 1))
            # Pillow holds a grey key against the scaled samples: a 1-bit
            # key as 0 or 255, a 2- or 4-bit key as it stands.
            if depth == 1 and trns is not None and len(trns) >= 2:
                trns = struct.pack(">H", 255 if struct.unpack(">H", trns[:2])[0] else 0)
    px = rows.reshape(h, w, ch)

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
        elif trns is not None and len(trns) >= 2:
            alpha[px[..., 0] == struct.unpack(">H", trns[:2])[0]] = 0
        return out
    out[..., :3] = px[..., :3]
    if ctype == 6:
        alpha[...] = px[..., 3]
    elif trns is not None and len(trns) >= 6:
        key = np.asarray(struct.unpack(">HHH", trns[:6]))
        alpha[(px.astype(np.int64) == key).all(-1)] = 0
    return out


def decode_image(data: bytes, name: str) -> np.ndarray:
    """An image file's bytes as (H, W, 4) uint8 RGBA: PNG by
    :func:`decode_rgba`; another format (JPEG, ...) through Pillow, which
    must then be importable, or the call raises naming ``name``."""
    if data.startswith(SIGNATURE):
        return decode_rgba(data, name)
    kind = "JPEG" if data[:2] == b"\xff\xd8" else "non-PNG"
    try:
        import io

        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"{name}: a {kind} image, and no decoder for it: Pillow is not "
                           "installed (the port decodes PNG itself)") from e
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
