"""Generate ``jpeg_textures.glb`` and the Pillow RGBA of each of its
textures (``jpeg_texture_<k>.npy``): a committed asset for the port's JPEG
decoder, which must read it on a machine without Pillow.

Five quads on a floor, each with its own base-colour texture, all JPEG as
Pillow writes them:

0. baseline 4:2:0, quality 75, 61 x 45 (an odd size, partial MCUs);
1. baseline 4:4:4, quality 95, 64 x 64;
2. grey (one component), quality 50, 33 x 31;
3. baseline 4:2:2 with a restart interval every 2 MCUs, quality 90, 48 x 40;
4. progressive 4:2:0, quality 85, 50 x 38.

A perspective camera and a point light frame them.

Beside them, one texture at the size a scene loads: ``jpeg_2k_420.jpg``,
2048 x 2048 baseline 4:2:0 at quality 85 (a brick wall: per-brick tints,
mortar, shading and mild noise; about 420 KB), and in
``jpeg_2k_420.sha256`` the SHA-256 of Pillow's RGBA of it (16 MiB as a
``.npy``), with its shape. Run ``python tests/assets/make_jpeg_glb.py``
to regenerate (needs Pillow).
"""

from __future__ import annotations

import io
import json
import os
import struct

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GLB = os.path.join(HERE, "jpeg_textures.glb")
# (size (w, h), Pillow mode, save keywords) of each texture.
TEXTURES = (
    ((61, 45), "RGB", dict(quality=75, subsampling=2)),
    ((64, 64), "RGB", dict(quality=95, subsampling=0)),
    ((33, 31), "L", dict(quality=50)),
    ((48, 40), "RGB", dict(quality=90, subsampling=1, restart_marker_blocks=2)),
    ((50, 38), "RGB", dict(quality=85, subsampling=2, progressive=True)),
)


BIG_JPEG = os.path.join(HERE, "jpeg_2k_420.jpg")
BIG_SHA = os.path.join(HERE, "jpeg_2k_420.sha256")


def npy_path(k: int) -> str:
    return os.path.join(HERE, f"jpeg_texture_{k}.npy")


def texture_pixels(k: int) -> np.ndarray:
    """A smooth pattern with noise (real JPEG content: every AC band used)."""
    (w, h), mode, _ = TEXTURES[k]
    rng = np.random.default_rng(100 + k)
    y, x = np.mgrid[0:h, 0:w]
    chans = 3 if mode == "RGB" else 1
    img = np.stack([128 + 100 * np.sin(x / (5.0 + c) + k) * np.cos(y / (4.0 + c) - c)
                    for c in range(chans)], -1)
    img = np.clip(img + rng.normal(0, 18, img.shape), 0, 255).astype(np.uint8)
    return img if mode == "RGB" else img[..., 0]


def big_pixels() -> np.ndarray:
    """The 2048 x 2048 brick wall: rows of 64 pixels, bricks 128 wide and
    staggered, a tint per brick, mortar lines, a slow shading and noise."""
    rng = np.random.default_rng(2048)
    y, x = np.mgrid[0:2048, 0:2048].astype(np.float32)
    row = (y // 64).astype(int)
    off = (row % 2) * 64
    col = ((x + off) // 128).astype(int)
    tint = rng.uniform(0.75, 1.1, (64, 64, 3)).astype(np.float32)
    img = np.array([170, 85, 60], np.float32) * tint[row % 64, col % 64]
    mortar = ((y % 64) < 4) | (((x + off) % 128) < 4)
    img = np.where(mortar[..., None], np.float32(200), img)
    img = img * (0.85 + 0.15 * (np.sin(x / 37.0) * np.cos(y / 53.0))[..., None])
    img = img + rng.normal(0, 2, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def rgba_digest(rgba: np.ndarray) -> str:
    """``<sha256 of the bytes> <h>x<w>x<c>``: the line of ``jpeg_2k_420.sha256``."""
    import hashlib

    return f"{hashlib.sha256(np.ascontiguousarray(rgba).tobytes()).hexdigest()} " + "x".join(
        str(n) for n in rgba.shape)


def write_big() -> None:
    from PIL import Image

    b = io.BytesIO()
    Image.fromarray(big_pixels(), "RGB").save(b, "JPEG", quality=85, subsampling=2)
    with open(BIG_JPEG, "wb") as f:
        f.write(b.getvalue())
    with open(BIG_SHA, "w") as f:
        f.write(rgba_digest(np.asarray(Image.open(io.BytesIO(b.getvalue())).convert("RGBA")))
                + "\n")


def jpeg_bytes(k: int) -> bytes:
    from PIL import Image

    _, mode, kw = TEXTURES[k]
    b = io.BytesIO()
    Image.fromarray(texture_pixels(k), mode).save(b, "JPEG", **kw)
    return b.getvalue()


def build(jpegs) -> bytes:
    bufs: list[bytes] = []
    views: list[dict] = []
    accessors: list[dict] = []

    def add_view(data: bytes, **kw) -> int:
        off = sum(len(b) for b in bufs)
        pad = (-off) % 4
        if pad:
            bufs.append(b"\x00" * pad)
            off += pad
        bufs.append(data)
        views.append(dict(buffer=0, byteOffset=off, byteLength=len(data), **kw))
        return len(views) - 1

    def add_accessor(view, ctype, count, type_, minmax=None):
        a = dict(bufferView=view, componentType=ctype, count=count, type=type_)
        if minmax is not None:
            a["min"], a["max"] = minmax
        accessors.append(a)
        return len(accessors) - 1

    pos = np.array([[-1, 0, -1], [-1, 0, 1], [1, 0, 1], [1, 0, -1]], np.float32)
    nrm = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
    uv = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    a_pos = add_accessor(add_view(pos.tobytes(), target=34962), 5126, 4, "VEC3",
                         (pos.min(0).tolist(), pos.max(0).tolist()))
    a_nrm = add_accessor(add_view(nrm.tobytes(), target=34962), 5126, 4, "VEC3")
    a_uv = add_accessor(add_view(uv.tobytes(), target=34962), 5126, 4, "VEC2")
    a_idx = add_accessor(add_view(idx.tobytes(), target=34963), 5125, 6, "SCALAR")
    images = [dict(bufferView=add_view(j), mimeType="image/jpeg") for j in jpegs]
    n = len(jpegs)
    gltf = dict(
        asset=dict(version="2.0", generator="vk_raytrace jpeg textures"),
        scene=0,
        scenes=[dict(nodes=list(range(n + 2)))],
        nodes=[dict(mesh=k, translation=[2.2 * (k - (n - 1) / 2), 0.0, 0.0]) for k in range(n)]
        + [dict(camera=0, translation=[0.0, 3.0, 6.0], rotation=[-0.26, 0.0, 0.0, 0.966]),
           dict(extensions=dict(KHR_lights_punctual=dict(light=0)), translation=[0, 3, 1])],
        cameras=[dict(type="perspective", perspective=dict(yfov=0.9, znear=0.01))],
        meshes=[dict(primitives=[dict(attributes=dict(POSITION=a_pos, NORMAL=a_nrm,
                                                      TEXCOORD_0=a_uv),
                                      indices=a_idx, material=k)]) for k in range(n)],
        materials=[dict(name=f"jpeg{k}", pbrMetallicRoughness=dict(
            baseColorTexture=dict(index=k), metallicFactor=0.0, roughnessFactor=0.7))
            for k in range(n)],
        textures=[dict(source=k, sampler=0) for k in range(n)],
        images=images,
        samplers=[dict(wrapS=10497, wrapT=10497)],
        extensions=dict(KHR_lights_punctual=dict(lights=[
            dict(type="point", intensity=60.0, color=[1, 1, 1])])),
        extensionsUsed=["KHR_lights_punctual"],
        bufferViews=views,
        accessors=accessors,
    )
    blob = b"".join(bufs)
    blob += b"\x00" * ((-len(blob)) % 4)
    gltf["buffers"] = [dict(byteLength=len(blob))]
    js = json.dumps(gltf).encode()
    js += b" " * ((-len(js)) % 4)
    total = 12 + 8 + len(js) + 8 + len(blob)
    return (b"glTF" + struct.pack("<II", 2, total) + struct.pack("<I", len(js)) + b"JSON" + js
            + struct.pack("<I", len(blob)) + b"BIN\x00" + blob)


def main() -> None:
    from PIL import Image

    jpegs = [jpeg_bytes(k) for k in range(len(TEXTURES))]
    with open(GLB, "wb") as f:
        f.write(build(jpegs))
    for k, j in enumerate(jpegs):
        np.save(npy_path(k), np.asarray(Image.open(io.BytesIO(j)).convert("RGBA")))
    write_big()
    print(f"wrote {GLB} ({os.path.getsize(GLB)} bytes), {len(jpegs)} .npy files and "
          f"{BIG_JPEG} ({os.path.getsize(BIG_JPEG)} bytes)")


if __name__ == "__main__":
    main()
