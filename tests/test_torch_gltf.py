"""The port's glTF loader (``vk_raytrace_torch/models/gltf.py``) and PNG
decoder (``vk_raytrace_torch/utils/png.py``) against the reference.

* ``load_gltf`` against the reference's on the same files, array for array
  with ``np.array_equal`` and equal dtypes: the geometry (or the mesh pool
  and instance table), materials, lights, camera and atlas. The files are
  ``tests/assets/quirks.glb`` in the three instancing modes and glTFs
  written here: the ones ``tests/test_gltf.py`` writes (a textured triangle
  with clearcoat and ior, a ``.glb``, a shared mesh, normalized and strided
  accessors) and more (an external ``.bin`` buffer and image, matrix, TRS
  and child nodes, spot and directional lights, ``KHR_texture_transform``,
  ``emissive_strength`` and the other material extensions, a triangle fan,
  a file without materials).
* The PNG decoder against Pillow's ``.convert("RGBA")``, equal, on quirks'
  textures and on PNGs written here of every colour type (grey, RGB,
  palette, grey + alpha, RGBA) under every scanline filter, with ``tRNS``;
  every bit depth (1, 2, 4, 8, 16) of each colour type, flat and
  Adam7-interlaced, sizes with empty passes included; the forms the format
  does not define raise naming the image; JPEG goes through the port's own
  decoder (``tests/test_torch_jpeg.py``), with or without Pillow.
* A two-level glTF of more than 512 instances loads, renders, picks and
  goes through the CLI as the reference's does; it is never baked instead.
"""

import base64
import io
import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401
from vk_raytrace_tpu.models.gltf import load_gltf as ref_load
from vk_raytrace_torch.models.gltf import load_gltf
from vk_raytrace_torch.utils import png

pytestmark = pytest.mark.usefixtures("one_torch_thread")

QUIRKS = os.path.join(os.path.dirname(__file__), "assets", "quirks.glb")


def _assert_same(port, ref, path="scene"):
    """Every array of the reference's result equals the port's (values,
    shape and dtype); tuples, named tuples and dataclasses field by field."""
    if hasattr(ref, "_fields"):
        for f in ref._fields:
            _assert_same(getattr(port, f), getattr(ref, f), f"{path}.{f}")
        return
    if isinstance(ref, tuple):
        assert isinstance(port, tuple) and len(port) == len(ref), path
        for i, (p, r) in enumerate(zip(port, ref)):
            _assert_same(p, r, f"{path}[{i}]")
        return
    if ref is None:
        assert port is None, path
        return
    if hasattr(ref, "__dataclass_fields__") or (hasattr(ref, "__dict__") and not hasattr(ref, "shape")):
        for f in vars(ref):
            _assert_same(getattr(port, f), getattr(ref, f), f"{path}.{f}")
        return
    p, r = np.asarray(port), np.asarray(ref)
    assert p.dtype == r.dtype and p.shape == r.shape, (path, p.dtype, r.dtype, p.shape, r.shape)
    assert np.array_equal(p, r), path


def _check_file(path, modes=("bake", "auto", "always")):
    for mode in modes:
        ref = ref_load(path, instancing=mode)
        port = load_gltf(path, instancing=mode)
        assert _is_two_level(port[0]) == (not hasattr(ref[0], "positions")), mode
        _assert_same(port, ref, mode)
    return port


def _is_two_level(geom):
    return isinstance(geom, tuple)


@pytest.mark.parametrize("mode", ["bake", "auto", "always"])
def test_quirks_matches_reference(mode):
    port = _check_file(QUIRKS, (mode,))
    geom, mats, lights, cam, atlas = port
    assert _is_two_level(geom) == (mode != "bake")
    assert atlas is not None and len(np.asarray(mats.ior)) == 3
    if mode == "auto":
        pool, inst = geom
        assert len(pool.tri_start) == 3 and len(inst.mesh_id) == 5


# ---------------------------------------------------------------------------
# glTFs written here
# ---------------------------------------------------------------------------


def _png_of(img: np.ndarray) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img).save(b, format="PNG")
    return b.getvalue()


def _data_uri(data: bytes, mime="application/octet-stream") -> str:
    return f"data:{mime};base64," + base64.b64encode(data).decode()


def _triangle_doc(color=(1.0, 0.2, 0.1, 1.0), double_sided=True, with_texture=False):
    """One triangle (positions, normals, uvs, uint16 indices in a data-URI
    buffer) with clearcoat and ior, translated, and a point light: the
    asset of ``tests/test_gltf.py::_write_triangle_gltf``."""
    positions = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    normals = np.array([[0, 0, 1]] * 3, np.float32)
    uvs = np.array([[0, 0], [1, 0], [0, 1]], np.float32)
    indices = np.array([0, 1, 2], np.uint16)
    buf = positions.tobytes() + normals.tobytes() + uvs.tobytes() + indices.tobytes()
    buf += b"\x00" * ((4 - len(buf) % 4) % 4)
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0, 1]}],
        "nodes": [{"mesh": 0, "translation": [1.0, 2.0, 3.0]},
                  {"extensions": {"KHR_lights_punctual": {"light": 0}},
                   "translation": [0, 5, 0]}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
            "indices": 3, "material": 0}]}],
        "materials": [{
            "pbrMetallicRoughness": {"baseColorFactor": list(color), "metallicFactor": 0.0,
                                     "roughnessFactor": 0.8},
            "doubleSided": double_sided,
            "extensions": {
                "KHR_materials_clearcoat": {"clearcoatFactor": 0.5,
                                            "clearcoatRoughnessFactor": 0.2},
                "KHR_materials_ior": {"ior": 1.4},
            },
        }],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3",
             "min": [0, 0, 0], "max": [1, 1, 0]},
            {"bufferView": 1, "componentType": 5126, "count": 3, "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": 3, "type": "VEC2"},
            {"bufferView": 3, "componentType": 5123, "count": 3, "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 36},
            {"buffer": 0, "byteOffset": 36, "byteLength": 36},
            {"buffer": 0, "byteOffset": 72, "byteLength": 24},
            {"buffer": 0, "byteOffset": 96, "byteLength": 6},
        ],
        "buffers": [{"byteLength": len(buf), "uri": _data_uri(buf)}],
        "extensions": {"KHR_lights_punctual": {
            "lights": [{"type": "point", "intensity": 10.0, "color": [1, 1, 0.5]}]}},
    }
    if with_texture:
        check = np.zeros((8, 8, 4), np.uint8)
        check[::2, ::2] = 255
        check[1::2, 1::2] = 255
        check[..., 3] = 255
        doc["images"] = [{"uri": _data_uri(_png_of(check), "image/png")}]
        doc["samplers"] = [{"wrapS": 33071, "wrapT": 10497}]
        doc["textures"] = [{"source": 0, "sampler": 0}]
        doc["materials"][0]["pbrMetallicRoughness"]["baseColorTexture"] = {"index": 0}
    return doc


def _write(tmp_path, name, doc):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def _write_glb(path, doc, bin_chunk=b""):
    js = json.dumps(doc).encode()
    js += b" " * ((4 - len(js) % 4) % 4)
    total = 12 + 8 + len(js) + (8 + len(bin_chunk) if bin_chunk else 0)
    out = struct.pack("<III", 0x46546C67, 2, total)
    out += struct.pack("<II", len(js), 0x4E4F534A) + js
    if bin_chunk:
        out += struct.pack("<II", len(bin_chunk), 0x004E4942) + bin_chunk
    with open(path, "wb") as f:
        f.write(out)
    return path


def _case_triangle(tmp_path):
    return _write(tmp_path, "tri.gltf", _triangle_doc())


def _case_textured(tmp_path):
    return _write(tmp_path, "tex.gltf", _triangle_doc(with_texture=True))


def _case_glb(tmp_path):
    """The triangle in a .glb whose buffer is its BIN chunk."""
    doc = _triangle_doc()
    buf = base64.b64decode(doc["buffers"][0]["uri"].split(",", 1)[1])
    doc["buffers"] = [{"byteLength": len(buf)}]
    return _write_glb(str(tmp_path / "tri.glb"), doc, buf)


def _case_glb_json_only(tmp_path):
    return _write_glb(str(tmp_path / "json_only.glb"), _triangle_doc())


def _case_shared_mesh(tmp_path):
    doc = _triangle_doc()
    doc["nodes"][0] = {"mesh": 0}
    doc["nodes"] += [{"mesh": 0, "translation": [2.0, 0.0, 0.0]},
                     {"mesh": 0, "translation": [0.0, 2.0, 0.0]}]
    doc["scenes"][0]["nodes"] += [2, 3]
    return _write(tmp_path, "shared.gltf", doc)


def _case_strided(tmp_path):
    """uint8-normalized colours interleaved with positions (byteStride 16),
    no indices, no normals (smooth normals are made)."""
    verts = np.zeros(3, dtype=[("p", np.float32, 3), ("c", np.uint8, 4)])
    verts["p"] = [[0, 0, 0], [1, 0, 0], [0, 1, 0]]
    verts["c"] = [[255, 0, 0, 255], [0, 255, 0, 255], [0, 0, 255, 255]]
    buf = verts.tobytes()
    doc = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "COLOR_0": 1}}]}],
        "accessors": [
            {"bufferView": 0, "byteOffset": 0, "componentType": 5126, "count": 3,
             "type": "VEC3"},
            {"bufferView": 0, "byteOffset": 12, "componentType": 5121, "count": 3,
             "type": "VEC4", "normalized": True},
        ],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": len(buf),
                         "byteStride": 16}],
        "buffers": [{"byteLength": len(buf), "uri": _data_uri(buf)}],
    }
    return _write(tmp_path, "strided.gltf", doc)


def _case_external_files(tmp_path):
    """The textured triangle with its buffer and its image in files beside
    the .gltf (one of them URI-escaped), and signed normalized int16 COLOR_0
    as VEC3."""
    doc = _triangle_doc(with_texture=True)
    buf = base64.b64decode(doc["buffers"][0]["uri"].split(",", 1)[1])
    col = np.array([[32767, -32768, 0], [0, 16384, -1], [100, 200, 300]], np.int16)
    off = len(buf)
    buf += col.tobytes() + b"\x00" * ((4 - col.nbytes % 4) % 4)
    (tmp_path / "mesh data.bin").write_bytes(buf)
    (tmp_path / "check.png").write_bytes(
        base64.b64decode(doc["images"][0]["uri"].split(",", 1)[1]))
    doc["buffers"] = [{"byteLength": len(buf), "uri": "mesh%20data.bin"}]
    doc["images"] = [{"uri": "check.png"}]
    doc["bufferViews"].append({"buffer": 0, "byteOffset": off, "byteLength": col.nbytes})
    doc["accessors"].append({"bufferView": 4, "componentType": 5122, "count": 3,
                             "type": "VEC3", "normalized": True})
    doc["meshes"][0]["primitives"][0]["attributes"]["COLOR_0"] = 4
    return _write(tmp_path, "external.gltf", doc)


def _case_node_forms(tmp_path):
    """A matrix node, a TRS node (scale, rotation, translation) and a
    child under a rotated parent, drawing one mesh; a camera on a child."""
    doc = _triangle_doc()
    s2 = float(np.sqrt(0.5))
    m = np.eye(4)
    m[:3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    m[:3, 3] = [3.0, -1.0, 0.5]
    doc["nodes"] = [
        {"mesh": 0, "matrix": m.T.reshape(-1).tolist()},
        {"mesh": 0, "scale": [2.0, 0.5, 1.5], "rotation": [0.0, s2, 0.0, s2],
         "translation": [-2.0, 0.0, 1.0]},
        {"rotation": [s2, 0.0, 0.0, s2], "translation": [0.0, 1.0, 0.0], "children": [3, 4]},
        {"mesh": 0, "translation": [0.5, 0.0, 0.0]},
        {"camera": 0, "translation": [0.0, 0.0, 8.0]},
        {"extensions": {"KHR_lights_punctual": {"light": 0}}, "translation": [0, 5, 0]},
    ]
    doc["scenes"] = [{"nodes": [0, 1, 2, 5]}]
    doc["cameras"] = [{"type": "perspective",
                       "perspective": {"yfov": 0.9, "aspectRatio": 1.5, "znear": 0.1}}]
    return _write(tmp_path, "nodes.gltf", doc)


def _case_lights(tmp_path):
    """Point, spot (with cone angles and a range) and directional lights on
    rotated nodes; no camera, so the loader frames the bounding box."""
    doc = _triangle_doc()
    s2 = float(np.sqrt(0.5))
    doc["extensions"]["KHR_lights_punctual"]["lights"] += [
        {"type": "spot", "intensity": 25.0, "color": [0.2, 0.9, 1.0], "range": 12.0,
         "spot": {"innerConeAngle": 0.2, "outerConeAngle": 0.6}},
        {"type": "directional", "intensity": 3.0},
    ]
    doc["nodes"] += [
        {"extensions": {"KHR_lights_punctual": {"light": 1}}, "rotation": [-s2, 0.0, 0.0, s2],
         "translation": [1.0, 4.0, -1.0]},
        {"extensions": {"KHR_lights_punctual": {"light": 2}}, "rotation": [0.3, 0.1, 0.0, 0.95]},
    ]
    doc["scenes"][0]["nodes"] += [2, 3]
    return _write(tmp_path, "lights.gltf", doc)


def _case_material_extensions(tmp_path):
    """``KHR_texture_transform`` (whose uv transform the reference computes
    twice, keeping the second), ``emissive_strength``, transmission, volume,
    sheen, anisotropy by rotation, unlit, a MASK and a BLEND material, and a
    normal texture with a scale."""
    doc = _triangle_doc(with_texture=True)
    pbr = doc["materials"][0]["pbrMetallicRoughness"]
    pbr["baseColorTexture"] = {"index": 0, "extensions": {"KHR_texture_transform": {
        "offset": [0.25, -0.5], "rotation": 0.7, "scale": [2.0, 3.0]}}}
    pbr["metallicRoughnessTexture"] = {"index": 0}
    doc["materials"][0].update(
        emissiveFactor=[0.5, 0.25, 1.0], emissiveTexture={"index": 0},
        normalTexture={"index": 0, "scale": 0.75}, alphaMode="MASK", alphaCutoff=0.3)
    doc["materials"][0]["extensions"].update({
        "KHR_materials_emissive_strength": {"emissiveStrength": 6.0},
        "KHR_materials_transmission": {"transmissionFactor": 0.4,
                                       "transmissionTexture": {"index": 0}},
        "KHR_materials_volume": {"thicknessFactor": 0.3, "attenuationDistance": 2.5,
                                 "attenuationColor": [0.9, 0.5, 0.2],
                                 "thicknessTexture": {"index": 0}},
        "KHR_materials_sheen": {"sheenColorFactor": [0.3, 0.2, 0.1],
                                "sheenRoughnessFactor": 0.6},
        "KHR_materials_anisotropy": {"anisotropyStrength": 0.5, "anisotropyRotation": 1.1},
    })
    doc["materials"].append({
        "alphaMode": "BLEND",
        "pbrMetallicRoughness": {"baseColorFactor": [0.2, 0.4, 0.6, 0.5]},
        "extensions": {"KHR_materials_unlit": {},
                       "KHR_materials_anisotropy": {"anisotropy": 0.3,
                                                    "anisotropyDirection": [0.0, 1.0, 0.0]},
                       "KHR_materials_clearcoat": {"clearcoatTexture": {"index": 0},
                                                   "clearcoatRoughnessTexture": {"index": 5}}},
    })
    doc["meshes"][0]["primitives"].append(dict(doc["meshes"][0]["primitives"][0], material=1))
    return _write(tmp_path, "materials.gltf", doc)


def _case_fan_no_materials(tmp_path):
    """A TRIANGLE_FAN of five vertices, and a TRIANGLE_STRIP of the same
    vertices by uint8 indices, in a file without materials."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1.5, 0], [-1, 1, 0]], np.float32)
    idx = np.array([0, 1, 2, 3, 4], np.uint8)
    buf = pos.tobytes() + idx.tobytes() + b"\x00" * 3
    doc = {
        "asset": {"version": "2.0"}, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "mode": 6},
                                   {"attributes": {"POSITION": 0}, "indices": 1, "mode": 5}]}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 5, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5121, "count": 5, "type": "SCALAR"},
        ],
        "bufferViews": [{"buffer": 0, "byteLength": 60},
                        {"buffer": 0, "byteOffset": 60, "byteLength": 5}],
        "buffers": [{"byteLength": len(buf), "uri": _data_uri(buf)}],
    }
    return _write(tmp_path, "fan.gltf", doc)


CASES = {
    "triangle": _case_triangle,
    "textured": _case_textured,
    "glb": _case_glb,
    "glb_json_only": _case_glb_json_only,
    "shared_mesh": _case_shared_mesh,
    "strided": _case_strided,
    "external_files": _case_external_files,
    "node_forms": _case_node_forms,
    "lights": _case_lights,
    "material_extensions": _case_material_extensions,
    "fan_no_materials": _case_fan_no_materials,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_written_gltf_matches_reference(case, tmp_path):
    geom, mats, lights, cam, atlas = _check_file(CASES[case](tmp_path))
    if case == "shared_mesh":
        assert _is_two_level(load_gltf(str(tmp_path / "shared.gltf"), instancing="auto")[0])
    if case == "material_extensions":
        assert np.asarray(mats.uv_transform)[0, 2, 0] == np.float32(0.25)
        assert np.allclose(np.asarray(mats.emissive_factor)[0], [3.0, 1.5, 6.0])


# ---------------------------------------------------------------------------
# PNG decoder against Pillow
# ---------------------------------------------------------------------------

_MODES = {0: "L", 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(row, prev, ft, bpp):
    out = bytearray(len(row))
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[ft]
        out[i] = (x - pred) & 0xFF
    return bytes([ft]) + bytes(out)


def _scanlines(px, depth):
    """(H, stride) bytes of ``px`` (H, W, C) samples of ``depth`` bits: big
    endian at 16, packed from each byte's high bits below 8."""
    h, w, ch = px.shape
    if depth == 16:
        return np.ascontiguousarray(px, ">u2").reshape(h, -1).view(np.uint8)
    rows = px.reshape(h, -1).astype(np.uint8)
    if depth < 8:
        per = 8 // depth
        pad = np.zeros((h, -(w * ch) % per), np.uint8)
        grouped = np.concatenate([rows, pad], 1).reshape(h, -1, per).astype(np.uint16)
        rows = sum(grouped[:, :, k] << (8 - depth * (k + 1)) for k in range(per)).astype(np.uint8)
    return rows


def _encode_png(px, ctype, filters, palette=None, trns=None, interlace=0, depth=8):
    """A PNG of ``px`` (H, W, C) samples of ``depth`` bits (uint16 at 16,
    else uint8) with the scanline filter of each row from ``filters``
    (cycled over the rows of every pass); ``interlace=1`` writes the seven
    Adam7 passes, an empty pass with no scanline at all."""
    h, w = px.shape[:2]
    bpp = max(1, _CHANNELS[ctype] * depth // 8)
    passes = png._ADAM7 if interlace else ((0, 0, 1, 1),)
    raw, n = b"", 0
    for x0, y0, dx, dy in passes:
        sub = px[y0::dy, x0::dx]
        if not sub.size:
            continue
        rows = _scanlines(sub, depth)
        prev = bytes(rows.shape[1])
        for y in range(rows.shape[0]):
            raw += _filter_row(bytes(rows[y]), prev, filters[n % len(filters)], bpp)
            prev = bytes(rows[y])
            n += 1

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    out = png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                      interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    # Two IDAT chunks: the decoder joins them.
    z = zlib.compress(raw)
    return out + chunk(b"IDAT", z[:7]) + chunk(b"IDAT", z[7:]) + chunk(b"IEND", b"")


def _pil_rgba(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("ctype", sorted(_MODES), ids=[_MODES[k] for k in sorted(_MODES)])
def test_png_decoder_matches_pil(ctype, filters):
    rng = np.random.default_rng(ctype * 10 + len(filters) + filters[0])
    h, w = 11, 13
    px = rng.integers(0, 256, (h, w, _CHANNELS[ctype]), dtype=np.uint8)
    palette = None
    if ctype == 3:
        palette = rng.integers(0, 256, (40, 3))
        px %= 40
    data = _encode_png(px, ctype, filters, palette=palette)
    got = png.decode_rgba(data)
    assert got.dtype == np.uint8 and got.shape == (h, w, 4)
    np.testing.assert_array_equal(got, _pil_rgba(data))


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("ctype", [0, 3], ids=["L", "P"])
def test_png_sub_byte_samples_match_pil(ctype, depth):
    """1, 2 and 4-bit grey and palette samples (Pillow writes a palette of
    up to 16 entries so), with a grey colour key or palette alphas."""
    rng = np.random.default_rng(depth)
    h, w = 7, 13  # a row ends inside a byte at every depth
    px = rng.integers(0, 1 << depth, (h, w, 1), dtype=np.uint8)
    palette = rng.integers(0, 256, (1 << depth, 3)) if ctype == 3 else None
    # A grey key of 1 marks the 1-bit samples of 1 (Pillow reads a 1-bit key
    # as 0 or 255); against the scaled 2- and 4-bit samples it marks none,
    # and a key of 17 marks the 4-bit samples of 1 (17 once scaled).
    trns = bytes([9, 200]) if ctype == 3 else struct.pack(">H", 17 if depth == 4 else 1)
    data = _encode_png(px, ctype, (0, 1, 2, 3, 4), palette=palette, trns=trns, depth=depth)
    got = png.decode_rgba(data)
    np.testing.assert_array_equal(got, _pil_rgba(data))
    assert (got[..., 3] < 255).any() == (ctype == 3 or depth != 2)


@pytest.mark.parametrize("ctype", [0, 2, 3], ids=["L", "RGB", "P"])
def test_png_transparency_matches_pil(ctype):
    """``tRNS``: a grey or RGB colour key, and palette alphas (fewer than
    the palette's entries)."""
    rng = np.random.default_rng(ctype)
    px = rng.integers(0, 6, (9, 10, _CHANNELS[ctype]), dtype=np.uint8) * 40
    palette = None
    if ctype == 0:
        trns = struct.pack(">H", 80)
    elif ctype == 2:
        px[2, 3] = px[5, 7] = [40, 80, 120]
        trns = struct.pack(">HHH", 40, 80, 120)
    else:
        px //= 40
        palette = rng.integers(0, 256, (6, 3))
        trns = bytes([0, 128, 255, 7])
    data = _encode_png(px, ctype, (4, 1, 3), palette=palette, trns=trns)
    got = png.decode_rgba(data)
    np.testing.assert_array_equal(got, _pil_rgba(data))
    assert (got[..., 3] < 255).any()


def test_png_decoder_matches_pil_on_quirks_textures():
    """The two textures of quirks.glb (Pillow's own RGB and RGBA encodings,
    its adaptive filters) and Pillow's grey, grey-alpha and palette files."""
    from vk_raytrace_torch.models.gltf import GltfFile

    g = GltfFile(QUIRKS)
    datas = []
    for spec in g.json["images"]:
        bv = g.json["bufferViews"][spec["bufferView"]]
        datas.append(g.buffer(0)[bv.get("byteOffset", 0):bv.get("byteOffset", 0) + bv["byteLength"]])
    rng = np.random.default_rng(3)
    smooth = (np.add.outer(np.arange(40), np.arange(50)) * 3 % 256).astype(np.uint8)
    datas += [_png_of(smooth), _png_of(np.stack([smooth, 255 - smooth], -1))]
    pal = Image.fromarray(rng.integers(0, 16, (20, 30), dtype=np.uint8), "P")
    pal.putpalette(rng.integers(0, 256, 48).tolist())
    b = io.BytesIO()
    pal.save(b, "PNG", transparency=bytes([255, 0, 100]))
    datas.append(b.getvalue())
    for data in datas:
        np.testing.assert_array_equal(png.decode_rgba(data), _pil_rgba(data))


_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


@pytest.mark.parametrize("size", [(1, 1), (3, 5), (2, 1), (9, 17)],
                         ids=["1x1", "3x5", "2x1", "9x17"])
@pytest.mark.parametrize("interlace", [0, 1], ids=["flat", "adam7"])
@pytest.mark.parametrize("form", [(c, d) for c in sorted(_DEPTHS) for d in _DEPTHS[c]],
                         ids=[f"{_MODES[c]}{d}" for c in sorted(_DEPTHS) for d in _DEPTHS[c]])
def test_png_16bit_and_adam7_match_pil(form, interlace, size):
    """Every colour type at every bit depth, flat and Adam7-interlaced,
    at sizes where some of the seven passes are empty (1x1: six of them;
    3x5; 2x1), with a colour key or palette alphas: Pillow keeps a 16-bit
    sample's high byte but clips 16-bit grey at 255, and compares a key's
    low byte with the 8-bit samples."""
    ctype, depth = form
    h, w = size
    rng = np.random.default_rng([ctype, depth, interlace, h, w])
    hi = 1 << depth
    px = rng.integers(0, hi, (h, w, _CHANNELS[ctype])).astype(np.uint16 if depth == 16 else np.uint8)
    if depth == 16 and ctype == 0:
        px[::2] %= 300  # samples on both sides of the clip at 255
    palette, trns = None, None
    if ctype == 3:
        palette = rng.integers(0, 256, (min(hi, 256), 3))
        trns = bytes(rng.integers(0, 256, 5, dtype=np.uint8))
    elif ctype in (0, 2):
        # A key whose low byte matches the first pixel, with a high byte set.
        first = px[0, 0].astype(np.int64)
        if depth == 16:
            first = np.minimum(first, 255) if ctype == 0 else first >> 8
        elif ctype == 0 and depth < 8:
            first = first if depth == 1 else first * (255 // (hi - 1))
        trns = struct.pack(f">{len(first)}H", *(int(k) | 0x100 for k in first))
    data = _encode_png(px, ctype, (0, 1, 2, 3, 4), palette=palette, trns=trns,
                       interlace=interlace, depth=depth)
    got = png.decode_rgba(data)
    assert got.dtype == np.uint8 and got.shape == (h, w, 4)
    np.testing.assert_array_equal(got, _pil_rgba(data))


def test_png_forms_not_supported_raise():
    """Forms the PNG format does not define raise naming the image, and so
    does a chunk that fails its CRC."""
    px = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(ValueError, match="texture 7: .*interlace method 2"):
        png.decode_rgba(_encode_png(px, 2, (0,), interlace=2), "texture 7")
    with pytest.raises(ValueError, match="texture 8: .*bit depth 16, colour type 3"):
        png.decode_rgba(_encode_png(px[..., :1], 3, (0,), palette=np.zeros((1, 3)), depth=16),
                        "texture 8")
    with pytest.raises(ValueError, match="texture 9: .*bit depth 4, colour type 2"):
        png.decode_rgba(_encode_png(px, 2, (0,), depth=4), "texture 9")
    good = _encode_png(px, 2, (0,))
    with pytest.raises(ValueError, match="CRC"):
        png.decode_rgba(good[:40] + bytes([good[40] ^ 1]) + good[41:])


def test_jpeg_through_pillow_or_raises(monkeypatch):
    """A JPEG, baseline or progressive, decodes to Pillow's array with
    Pillow installed and without it (the port's own decoder either way); a
    form that Pillow rejects too, hierarchical (a baseline frame header
    rewritten to SOF5), raises naming the image."""
    img = np.random.default_rng(1).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    streams = []
    for kw in ({}, dict(progressive=True)):
        b = io.BytesIO()
        Image.fromarray(img).save(b, "JPEG", **kw)
        streams.append(b.getvalue())
    want = [_pil_rgba(d) for d in streams]
    for data, ref in zip(streams, want):
        np.testing.assert_array_equal(png.decode_image(data, "image 0"), ref)
    monkeypatch.setitem(sys.modules, "PIL", None)  # Pillow not installed
    for data, ref in zip(streams, want):
        np.testing.assert_array_equal(png.decode_image(data, "image 0"), ref)
    i = streams[0].index(b"\xff\xc0")
    with pytest.raises(RuntimeError, match=r"image 0.*differential sequential \(SOF5\) JPEG"):
        png.decode_image(streams[0][:i + 1] + b"\xc5" + streams[0][i + 2:], "image 0")


# ---------------------------------------------------------------------------
# More than 512 instances
# ---------------------------------------------------------------------------


def test_auto_over_512_instances_raises(tmp_path, monkeypatch):
    """520 nodes drawing one triangle: ``auto`` loads two levels, as the
    reference does, and nothing raises any more: the scene renders (the
    reference's tables through ``Renderer``, 16x12, depth 2, sun&sky, under
    ``tests/test_torch_render.py``'s criterion), picks (the same hits,
    triangles and instances, t within rtol 1e-5) and goes through the CLI
    (against the reference CLI's ``--hdr-out``) as the reference's does,
    on the chunked candidate scan; nothing bakes in its place."""
    from vk_raytrace_tpu import cli as ref_cli
    from vk_raytrace_tpu import render as ref_render
    from vk_raytrace_tpu.models.schema import PBR_GLTF, RenderConfig as RefConfig
    from vk_raytrace_tpu.utils import cache as ref_cache
    from vk_raytrace_torch import cli
    from vk_raytrace_torch import render as R
    from vk_raytrace_torch.convert import from_reference
    from vk_raytrace_torch.models.schema import RenderConfig
    from vk_raytrace_torch.ops import tlas

    monkeypatch.setattr(ref_cache, "enable_compile_cache", lambda: None)
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    doc = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": list(range(520))}],
        "nodes": [{"mesh": 0, "translation": [1.5 * (i % 26), 1.5 * (i // 26), 0.0]}
                  for i in range(520)],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}}]}],
        "accessors": [{"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3"}],
        "bufferViews": [{"buffer": 0, "byteLength": 36}],
        "buffers": [{"byteLength": 36, "uri": _data_uri(pos.tobytes())}],
    }
    path = _write(tmp_path, "many.gltf", doc)
    (pool, inst), mats, lights, cam, atlas = load_gltf(path, instancing="auto")
    (ref_pool, ref_inst), ref_mats, ref_lights, ref_cam, ref_atlas = ref_load(path,
                                                                            instancing="auto")
    assert len(inst.mesh_id) == len(ref_inst.mesh_id) == 520 > tlas._DENSE_I_MAX
    cfg = dict(width=16, height=12, max_depth=2, max_samples=1, pbr_mode=PBR_GLTF,
               firefly_clamp=10.0, use_sun_sky=True)
    ref = ref_render.Renderer(ref_render.build_instanced_scene(
        ref_pool, ref_inst, ref_mats, ref_lights, ref_cam, atlas=ref_atlas), RefConfig(**cfg))
    scene, acc = from_reference(ref.scene, ref.packed)
    port = R.Renderer(scene, RenderConfig(**{**cfg, "use_sun_sky": False, "sun_disk": True}),
                      device="cpu", packed=acc)
    rays = [[], []]
    for k, r in enumerate((ref, port)):
        for _ in range(2):
            r.step()
            rays[k].append(r.last_rays)
    img = port.accum.numpy()
    assert np.isfinite(img).all() and img.mean() > 0.0
    assert np.isclose(img, np.asarray(ref.accum), rtol=1e-3, atol=1e-4).all(-1).mean() >= 0.99
    assert all(abs(p - q) <= 1e-3 * q for p, q in zip(rays[1], rays[0])), rays
    # Picks of the port's own scene against the reference renderer's.
    own = R.Renderer(R.build_instanced_scene(pool, inst, mats, lights, cam, atlas=atlas),
                     RenderConfig(width=16, height=12), device="cpu")
    ref_pick = ref_render.Renderer(ref.scene, RefConfig(width=16, height=12), packed=ref.packed)
    ys, xs = np.divmod(np.arange(16 * 12), 16)
    picks = own.pick_many(xs, ys)
    hit = [i for i, p in enumerate(picks) if p is not None]
    miss = [i for i, p in enumerate(picks) if p is None]
    assert len(hit) >= 24 and miss
    for i in hit[::len(hit) // 3][:3] + miss[:1]:
        p, q = picks[i], ref_pick.pick(int(xs[i]), int(ys[i]))
        assert (p is None) == (q is None), (i, p, q)
        if p is not None:
            assert (p["triangle"], p["instance"]) == (q["triangle"], q["instance"]) or (
                p["t"] == q["t"]), (p, q)
            np.testing.assert_allclose(p["t"], q["t"], rtol=1e-5)
    # The CLI, both packages.
    args = ["-f", path, "--size", "16", "12", "--depth", "2", "--spp", "1", "--sun-sky"]
    assert cli.main([*args, "--device", "cpu", "-o", str(tmp_path / "many.png"), "--hdr-out",
                     str(tmp_path / "port.npy")]) == 0
    assert ref_cli.main([*args, "-o", str(tmp_path / "ref.png"), "--hdr-out",
                         str(tmp_path / "ref.npy")]) == 0
    a, b = np.load(tmp_path / "port.npy"), np.load(tmp_path / "ref.npy")
    assert a.shape == b.shape and np.isfinite(a).all() and a.mean() > 0.0
    assert np.isclose(a, b, rtol=1e-3, atol=1e-4).all(-1).mean() >= 0.99
    assert (tmp_path / "many.png").exists()
