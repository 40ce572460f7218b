"""glTF 2.0 loader: .gltf/.glb -> the port's scene tables (counterpart of
``vk_raytrace_tpu/models/gltf.py``; host numpy, float64 throughout, so that
every array equals the reference's).

* parses .gltf (JSON with external, .bin or data-URI buffers) and .glb
  containers, with ``byteStride``, sparse accessors and normalized integers
* flattens the node hierarchy (matrix or TRS nodes) to draws of mesh
  primitives; TRIANGLE_STRIP and TRIANGLE_FAN become triangle lists
* imports every material field of the shading table with the KHR
  extensions: texture_transform, transmission, ior, volume, clearcoat,
  sheen, unlit, anisotropy, emissive_strength
* imports KHR_lights_punctual and the first perspective camera, or frames
  the scene's bounding box when there is none
* decodes textures with the port's own PNG and JPEG decoders
  (``utils/png.py``, ``utils/jpeg.py``; no Pillow) and packs them into the
  atlas

``instancing="bake"`` bakes node transforms into one world-space geometry;
``"auto"`` returns a mesh pool and an instance table when a primitive is
drawn by more than one node (``render.build_instanced_scene``); ``"always"``
does so without sharing. A two-level scene of any instance count, and of
any mix of opaque and alpha-tested triangles, renders (``ops/tlas.py``): the
loader never bakes in its place.
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import Optional

import numpy as np

from .builder import GeometryBuilder
from .procedural import look_at_camera
from .schema import (
    ALPHA_BLEND,
    ALPHA_MASK,
    ALPHA_OPAQUE,
    LIGHT_DIRECTIONAL,
    LIGHT_POINT,
    LIGHT_SPOT,
    Camera,
    make_lights,
    make_materials,
)
from .textures import AtlasBuilder

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
    "MAT2": 4, "MAT3": 9, "MAT4": 16,
}
_ALPHA_MODES = {"OPAQUE": ALPHA_OPAQUE, "MASK": ALPHA_MASK, "BLEND": ALPHA_BLEND}
_LIGHT_TYPES = {"directional": LIGHT_DIRECTIONAL, "point": LIGHT_POINT, "spot": LIGHT_SPOT}


class GltfFile:
    """Parsed glTF container with buffer access."""

    def __init__(self, path: str):
        self.path = path
        self.dir = os.path.dirname(os.path.abspath(path))
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] == b"glTF":
            # GLB container: 12-byte header, then chunks (JSON, BIN)
            _, _, _ = struct.unpack("<III", data[:12])
            offset = 12
            self.json = None
            self.bin = None
            while offset < len(data):
                clen, ctype = struct.unpack_from("<II", data, offset)
                chunk = data[offset + 8 : offset + 8 + clen]
                if ctype == 0x4E4F534A:  # 'JSON'
                    self.json = json.loads(chunk)
                elif ctype == 0x004E4942:  # 'BIN'
                    self.bin = chunk
                offset += 8 + clen
                offset += (4 - offset % 4) % 4
            if self.json is None:
                raise ValueError(f"{path}: GLB without a JSON chunk")
        else:
            self.json = json.loads(data)
            self.bin = None
        self._buffers: dict[int, bytes] = {}

    def buffer(self, index: int) -> bytes:
        if index not in self._buffers:
            spec = self.json["buffers"][index]
            uri = spec.get("uri")
            if uri is None:
                data = self.bin
            elif uri.startswith("data:"):
                data = base64.b64decode(uri.split(",", 1)[1])
            else:
                from urllib.parse import unquote

                with open(os.path.join(self.dir, unquote(uri)), "rb") as f:
                    data = f.read()
            self._buffers[index] = data
        return self._buffers[index]

    def accessor(self, index: int) -> np.ndarray:
        """Decode an accessor to (count, components) float64/int arrays,
        honoring bufferView byteStride and normalized integers."""
        acc = self.json["accessors"][index]
        count = acc["count"]
        ncomp = _TYPE_COUNTS[acc["type"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        itemsize = np.dtype(dtype).itemsize

        if "bufferView" not in acc:
            out = np.zeros((count, ncomp), dtype)
        else:
            bv = self.json["bufferViews"][acc["bufferView"]]
            buf = self.buffer(bv["buffer"])
            start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
            stride = bv.get("byteStride", itemsize * ncomp)
            if stride == itemsize * ncomp:
                out = np.frombuffer(
                    buf, dtype, count=count * ncomp, offset=start
                ).reshape(count, ncomp)
            else:
                raw = np.frombuffer(buf, np.uint8)
                idx = start + stride * np.arange(count)[:, None] + np.arange(itemsize * ncomp)[None, :]
                out = raw[idx].copy().view(dtype).reshape(count, ncomp)

        # Sparse substitution
        sparse = acc.get("sparse")
        if sparse:
            out = out.copy()
            sidx = self._sparse_array(sparse["indices"], np.uint32, 1, sparse["count"])
            sval = self._sparse_array(sparse["values"], dtype, ncomp, sparse["count"])
            out[sidx[:, 0]] = sval

        if acc.get("normalized") and np.issubdtype(dtype, np.integer):
            info = np.iinfo(dtype)
            out = out.astype(np.float64) / info.max
            if info.min < 0:
                out = np.maximum(out, -1.0)
        return np.array(out)

    def _sparse_array(self, spec, dtype, ncomp, count):
        if "componentType" in spec:
            dtype = _COMPONENT_DTYPES[spec["componentType"]]
        bv = self.json["bufferViews"][spec["bufferView"]]
        buf = self.buffer(bv["buffer"])
        start = bv.get("byteOffset", 0) + spec.get("byteOffset", 0)
        return np.frombuffer(buf, dtype, count=count * ncomp, offset=start).reshape(
            count, ncomp
        )


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T  # column-major
    m = np.eye(4)
    if "scale" in node:
        m[:3, :3] = np.diag(node["scale"])
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ]
        )
        m[:3, :3] = r @ m[:3, :3]
    if "translation" in node:
        t = np.eye(4)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def _import_material(gm: dict, tex_index) -> dict:
    """Map one glTF material to the SoA row (scene.cpp:339-382)."""
    row: dict = {}
    pbr = gm.get("pbrMetallicRoughness", {})
    row["base_color_factor"] = pbr.get("baseColorFactor", [1, 1, 1, 1])
    row["metallic_factor"] = pbr.get("metallicFactor", 1.0)
    row["roughness_factor"] = pbr.get("roughnessFactor", 1.0)
    row["base_color_texture"] = tex_index(pbr.get("baseColorTexture"))
    row["metallic_roughness_texture"] = tex_index(pbr.get("metallicRoughnessTexture"))
    row["emissive_factor"] = gm.get("emissiveFactor", [0, 0, 0])
    row["emissive_texture"] = tex_index(gm.get("emissiveTexture"))
    row["alpha_mode"] = _ALPHA_MODES.get(gm.get("alphaMode", "OPAQUE"), ALPHA_OPAQUE)
    row["alpha_cutoff"] = gm.get("alphaCutoff", 0.5)
    row["double_sided"] = 1 if gm.get("doubleSided") else 0
    nt = gm.get("normalTexture")
    row["normal_texture"] = tex_index(nt)
    row["normal_texture_scale"] = (nt or {}).get("scale", 1.0)

    ext = gm.get("extensions", {})
    # KHR_texture_transform (on baseColorTexture, like the reference
    # scene.cpp:371-381 which keeps a single uvTransform)
    tt = ((pbr.get("baseColorTexture") or {}).get("extensions", {})).get(
        "KHR_texture_transform"
    )
    if tt:
        off = tt.get("offset", [0, 0])
        rot = tt.get("rotation", 0.0)
        sc = tt.get("scale", [1, 1])
        c, s = np.cos(rot), np.sin(rot)
        row["uv_transform"] = (
            np.array([[1, 0, 0], [0, 1, 0], [off[0], off[1], 1]])
            @ np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
            @ np.array([[sc[0], 0, 0], [0, sc[1], 0], [0, 0, 1]])
        ).T @ np.eye(3)  # applied as [u,v,1] @ T
        row["uv_transform"] = np.array(
            [[sc[0] * c, sc[0] * -s, 0], [sc[1] * s, sc[1] * c, 0], [off[0], off[1], 1]]
        )
    row["unlit"] = 1 if "KHR_materials_unlit" in ext else 0
    tr = ext.get("KHR_materials_transmission", {})
    row["transmission_factor"] = tr.get("transmissionFactor", 0.0)
    row["transmission_texture"] = tex_index(tr.get("transmissionTexture"))
    row["ior"] = ext.get("KHR_materials_ior", {}).get("ior", 1.5)
    an = ext.get("KHR_materials_anisotropy", {})
    row["anisotropy"] = an.get("anisotropyStrength", an.get("anisotropy", 0.0))
    ad = an.get("anisotropyDirection", [1, 0, 0])
    if "anisotropyRotation" in an:
        rot = an["anisotropyRotation"]
        ad = [np.cos(rot), np.sin(rot), 0.0]
    row["anisotropy_direction"] = ad
    vol = ext.get("KHR_materials_volume", {})
    row["attenuation_color"] = vol.get("attenuationColor", [1, 1, 1])
    row["thickness_factor"] = vol.get("thicknessFactor", 0.0)
    row["thickness_texture"] = tex_index(vol.get("thicknessTexture"))
    row["attenuation_distance"] = vol.get("attenuationDistance", 1e10)
    cc = ext.get("KHR_materials_clearcoat", {})
    row["clearcoat_factor"] = cc.get("clearcoatFactor", 0.0)
    row["clearcoat_roughness"] = cc.get("clearcoatRoughnessFactor", 0.0)
    row["clearcoat_texture"] = tex_index(cc.get("clearcoatTexture"))
    row["clearcoat_roughness_texture"] = tex_index(cc.get("clearcoatRoughnessTexture"))
    # KHR_materials_sheen: the reference packs color.rgb + roughness into one
    # RGBA8 (scene.cpp:375, host_device.h:176) and unpacks sheenTint = rgb,
    # sheen = w (gltf_material.glsl:189-192) — i.e. the roughness factor acts
    # as the sheen amount in the Disney lobe (pbr_disney.glsl:396).
    sh = ext.get("KHR_materials_sheen", {})
    row["sheen_color"] = sh.get("sheenColorFactor", [0, 0, 0])
    row["sheen_roughness"] = sh.get("sheenRoughnessFactor", 0.0)
    es = ext.get("KHR_materials_emissive_strength", {})
    if es:
        row["emissive_factor"] = [
            c * es.get("emissiveStrength", 1.0) for c in row["emissive_factor"]
        ]
    return row


def load_gltf(path: str, instancing: str = "bake"):
    """Load a scene. Returns ``(geometry, materials, lights, camera, atlas)``.

    ``instancing`` selects the acceleration-structure shape (the reference
    always builds TLAS-over-nodes, ``accelstruct.cpp:132-162``):

    * ``"bake"`` (default): node transforms baked to one world-space
      geometry — single-level accel, the round-1/2 behavior.
    * ``"auto"``: when any mesh primitive is drawn by more than one node,
      return ``((MeshPool, InstanceTable), materials, lights, camera,
      atlas)`` for :func:`vk_raytrace_torch.render.build_instanced_scene`
      (shared meshes cost one copy); otherwise bake.
    * ``"always"``: instanced form even without sharing.
    """
    g = GltfFile(path)
    doc = g.json

    def tex_index(ref: Optional[dict]) -> int:
        return -1 if not ref else ref.get("index", -1)

    # ---- materials -------------------------------------------------------
    mat_rows = [
        _import_material(gm, tex_index) for gm in doc.get("materials", [])
    ]
    if not mat_rows:
        mat_rows = [dict()]
    default_mat = len(mat_rows) - 1 if not doc.get("materials") else None

    # ---- textures -> atlas ----------------------------------------------
    atlas_builder = AtlasBuilder()
    tex_table: list[int] = []
    for tex in doc.get("textures", []):
        src = tex.get("source", -1)
        smp = doc.get("samplers", [{}])[tex["sampler"]] if "sampler" in tex else {}
        img = _decode_image(g, doc, src) if src >= 0 else None
        tex_table.append(atlas_builder.add(img, smp))
    atlas = atlas_builder.build() if tex_table else None

    # ---- nodes -> draw records ------------------------------------------
    draws: list[tuple[int, dict, int, np.ndarray]] = []  # (prim_key, prim, mat, m)
    lights_rows: list[dict] = []
    camera: Optional[Camera] = None
    scn = doc.get("scenes", [{}])[doc.get("scene", 0)]

    prim_cache: dict = {}

    def read_primitive(prim):
        key = id(prim)
        if key not in prim_cache:
            attrs = prim["attributes"]
            pos = g.accessor(attrs["POSITION"]).astype(np.float64)
            normals = (
                g.accessor(attrs["NORMAL"]).astype(np.float64)
                if "NORMAL" in attrs
                else None
            )
            uv = (
                g.accessor(attrs["TEXCOORD_0"]).astype(np.float64)
                if "TEXCOORD_0" in attrs
                else None
            )
            tang = (
                g.accessor(attrs["TANGENT"]).astype(np.float64)
                if "TANGENT" in attrs
                else None
            )
            color = None
            if "COLOR_0" in attrs:
                c = g.accessor(attrs["COLOR_0"]).astype(np.float64)
                if c.shape[1] == 3:
                    c = np.concatenate([c, np.ones((len(c), 1))], axis=1)
                color = c
            if "indices" in prim:
                idx = g.accessor(prim["indices"]).astype(np.int64).reshape(-1)
            else:
                idx = np.arange(len(pos), dtype=np.int64)
            mode = prim.get("mode", 4)
            if mode == 4:
                tris = idx.reshape(-1, 3)
            elif mode == 5:  # TRIANGLE_STRIP
                a, b, c = idx[:-2], idx[1:-1], idx[2:]
                flip = np.arange(len(a)) % 2 == 1
                tris = np.stack([a, np.where(flip, c, b), np.where(flip, b, c)], 1)
            elif mode == 6:  # TRIANGLE_FAN
                tris = np.stack(
                    [np.full(len(idx) - 2, idx[0]), idx[1:-1], idx[2:]], 1
                )
            else:
                raise ValueError(f"unsupported primitive mode {mode}")
            prim_cache[key] = (pos, normals, uv, tang, color, tris)
        return prim_cache[key]

    def visit(node_idx: int, parent: np.ndarray):
        nonlocal camera
        node = doc["nodes"][node_idx]
        m = parent @ _node_matrix(node)
        if "mesh" in node:
            mesh = doc["meshes"][node["mesh"]]
            for prim in mesh["primitives"]:
                mat_id = prim.get("material", default_mat)
                if mat_id is None:
                    mat_id = 0
                draws.append((id(prim), prim, mat_id, m))
        if "camera" in node and camera is None:
            cam_spec = doc["cameras"][node["camera"]]
            if cam_spec.get("type") == "perspective":
                p = cam_spec["perspective"]
                eye = m[:3, 3]
                fwd = -m[:3, 2]
                up = m[:3, 1]
                camera = look_at_camera(
                    eye, eye + fwd, up,
                    fov_deg=np.rad2deg(p.get("yfov", 0.7)),
                    aspect=p.get("aspectRatio", 16 / 9),
                )
        lt = node.get("extensions", {}).get("KHR_lights_punctual")
        if lt is not None:
            spec = doc["extensions"]["KHR_lights_punctual"]["lights"][lt["light"]]
            stype = _LIGHT_TYPES.get(spec.get("type", "point"), LIGHT_POINT)
            spot = spec.get("spot", {})
            lights_rows.append(
                dict(
                    type=stype,
                    color=spec.get("color", [1, 1, 1]),
                    intensity=spec.get("intensity", 1.0),
                    range=spec.get("range", 0.0),
                    position=m[:3, 3],
                    direction=-m[:3, 2] / max(np.linalg.norm(m[:3, 2]), 1e-12),
                    inner_cone_cos=float(np.cos(spot.get("innerConeAngle", 0.0))),
                    outer_cone_cos=float(np.cos(spot.get("outerConeAngle", np.pi / 4))),
                )
            )
        for child in node.get("children", []):
            visit(child, m)

    for root in scn.get("nodes", []):
        visit(root, np.eye(4))

    # Remap material texture references through the atlas table
    for row in mat_rows:
        for key in (
            "base_color_texture", "metallic_roughness_texture", "emissive_texture",
            "normal_texture", "transmission_texture", "thickness_texture",
            "clearcoat_texture", "clearcoat_roughness_texture",
        ):
            t = row.get(key, -1)
            row[key] = tex_table[t] if (0 <= t < len(tex_table)) else -1

    materials = make_materials(mat_rows)
    lights = make_lights(lights_rows)

    n_shared = len(draws) - len({k for k, *_ in draws})
    singular = any(
        abs(np.linalg.det(m[:3, :3])) < 1e-12 for *_, m in draws
    )
    use_inst = bool(draws) and not singular and (
        instancing == "always" or (instancing == "auto" and n_shared > 0)
    )

    def mesh_args(prim, mat_id):
        pos, normals, uv, tang, color, tris = read_primitive(prim)
        row = mat_rows[mat_id]
        return dict(
            positions=pos, indices=tris, material=mat_id,
            normals=normals, uv=uv, tangents=tang, colors=color,
            double_sided=bool(row.get("double_sided", 0)),
            alpha_mode=row.get("alpha_mode", ALPHA_OPAQUE),
        )

    if use_inst:
        from .instances import InstancedSceneBuilder

        ib = InstancedSceneBuilder()
        mesh_ids: dict[int, int] = {}
        for key, prim, mat_id, m in draws:
            if key not in mesh_ids:
                mesh_ids[key] = ib.add_mesh(**mesh_args(prim, mat_id))
            ib.add_instance(mesh_ids[key], m)
        pool, inst_table = ib.build()
        geometry = (pool, inst_table)
        lo = np.asarray(inst_table.aabb_min).min(0)
        hi = np.asarray(inst_table.aabb_max).max(0)
    else:
        builder = GeometryBuilder()
        for _, prim, mat_id, m in draws:
            builder.add_mesh(transform=m, **mesh_args(prim, mat_id))
        geometry = builder.build()
        pos = np.asarray(geometry.positions)
        lo, hi = pos.min(0), pos.max(0)

    if camera is None:
        # Frame the scene bbox (CameraManip.fit analog, scene.cpp:294-298)
        center = (lo + hi) / 2
        radius = float(np.linalg.norm(hi - lo)) / 2 + 1e-6
        eye = center + np.array([0.0, radius * 0.3, radius * 2.2])
        camera = look_at_camera(eye, center, [0, 1, 0], fov_deg=45.0, aspect=16 / 9)

    return geometry, materials, lights, camera, atlas


def _decode_image(g: GltfFile, doc: dict, source: int) -> Optional[np.ndarray]:
    """Decode a glTF image to (H, W, 4) uint8 RGBA (``utils/png.py``,
    ``utils/jpeg.py``)."""
    from ..utils import png

    spec = doc["images"][source]
    if "bufferView" in spec:
        bv = doc["bufferViews"][spec["bufferView"]]
        buf = g.buffer(bv["buffer"])
        data = buf[bv.get("byteOffset", 0) : bv.get("byteOffset", 0) + bv["byteLength"]]
    else:
        uri = spec["uri"]
        if uri.startswith("data:"):
            data = base64.b64decode(uri.split(",", 1)[1])
        else:
            from urllib.parse import unquote

            with open(os.path.join(g.dir, unquote(uri)), "rb") as f:
                data = f.read()
    where = spec.get("uri", f"bufferView {spec.get('bufferView')}")
    if where.startswith("data:"):
        where = where.split(",", 1)[0] + ",..."
    return png.decode_image(data, f"image {source} ({where}) of {g.path}")
