"""The benchmark's two scenes, frozen: the atrium and the bistro street.

A copy of ``atrium_scene`` and ``bistro_scene`` of
``vk_raytrace_torch/models/procedural.py`` with the helpers they call, so
that a later change to the port's generators cannot move the yardstick.
The atrium is the Sponza-class courtyard of the reference's bench workload
(~217k triangles, alpha-cutout banners, textured glTF PBR, three point
lights); the bistro is the Bistro-class street (579k unique and >1M
instantiated triangles over 166 instances of 8 meshes, alpha-cutout
foliage). Pure numpy with the same seeds, so every array is byte-identical
to the port's (``rtbench/tests/test_rtbench_scenes.py``).
"""

from __future__ import annotations

import numpy as np

from .builder import GeometryBuilder
from .schema import ALPHA_MASK, LIGHT_POINT, Camera, make_lights, make_materials


def _quad(a, b, c, d):
    """Two CCW triangles for quad a-b-c-d."""
    verts = np.array([a, b, c, d], np.float64)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    return verts, idx


def _box(center, size):
    """Axis-aligned box, outward-facing quads."""
    cx, cy, cz = center
    sx, sy, sz = np.asarray(size) / 2.0
    quads = [
        [[cx + sx, cy - sy, cz - sz], [cx + sx, cy + sy, cz - sz], [cx + sx, cy + sy, cz + sz], [cx + sx, cy - sy, cz + sz]],
        [[cx - sx, cy - sy, cz + sz], [cx - sx, cy + sy, cz + sz], [cx - sx, cy + sy, cz - sz], [cx - sx, cy - sy, cz - sz]],
        [[cx - sx, cy + sy, cz - sz], [cx - sx, cy + sy, cz + sz], [cx + sx, cy + sy, cz + sz], [cx + sx, cy + sy, cz - sz]],
        [[cx - sx, cy - sy, cz + sz], [cx - sx, cy - sy, cz - sz], [cx + sx, cy - sy, cz - sz], [cx + sx, cy - sy, cz + sz]],
        [[cx - sx, cy - sy, cz + sz], [cx + sx, cy - sy, cz + sz], [cx + sx, cy + sy, cz + sz], [cx - sx, cy + sy, cz + sz]],
        [[cx - sx, cy + sy, cz - sz], [cx + sx, cy + sy, cz - sz], [cx + sx, cy - sy, cz - sz], [cx - sx, cy - sy, cz - sz]],
    ]
    v, f = [], []
    for k, q in enumerate(quads):
        verts, idx = _quad(*q)
        v.append(verts)
        f.append(idx + 4 * k)
    return np.concatenate(v), np.concatenate(f)


def look_at_camera(
    eye, center, up, fov_deg: float, aspect: float,
    focal_dist: float = 0.0, aperture: float = 0.0,
) -> Camera:
    """viewInverse/projInverse for the ray generator (pathtrace.glsl:360-363)."""
    eye = np.asarray(eye, np.float64)
    center = np.asarray(center, np.float64)
    up = np.asarray(up, np.float64)
    f = center - eye
    f /= np.linalg.norm(f)
    s = np.cross(f, up)
    s /= np.linalg.norm(s)
    u = np.cross(s, f)
    view = np.eye(4)
    view[0, :3] = s
    view[1, :3] = u
    view[2, :3] = -f
    view[:3, 3] = -view[:3, :3] @ eye

    fy = 1.0 / np.tan(np.deg2rad(fov_deg) / 2.0)
    near, far = 0.1, 1000.0
    proj = np.zeros((4, 4))
    proj[0, 0] = fy / aspect
    proj[1, 1] = -fy  # Vulkan clip space: y down
    proj[2, 2] = far / (near - far)
    proj[2, 3] = (far * near) / (near - far)
    proj[3, 2] = -1.0
    if focal_dist <= 0.0:
        focal_dist = float(np.linalg.norm(center - eye))
    return Camera(
        view_inverse=np.linalg.inv(view).astype(np.float32),
        proj_inverse=np.linalg.inv(proj).astype(np.float32),
        focal_dist=np.float32(focal_dist),
        aperture=np.float32(aperture),
    )


def _grid_mesh(nx: int, ny: int):
    """Triangles of an (nx+1) x (ny+1) vertex grid."""
    jj, ii = np.meshgrid(np.arange(nx + 1), np.arange(ny + 1))
    stride = nx + 1
    a = (ii[:-1, :-1] * stride + jj[:-1, :-1]).ravel()
    b = a + 1
    c = a + stride
    d = c + 1
    return np.concatenate(
        [np.stack([a, c, b], 1), np.stack([b, c, d], 1)], axis=0
    ).astype(np.int64)


def _lathe(profile_y, profile_r, n_seg: int, fluting: float = 0.0, flutes: int = 20):
    """Surface of revolution around +y with optional cosine fluting.
    Returns (verts, idx, uv)."""
    profile_y = np.asarray(profile_y, np.float64)
    profile_r = np.asarray(profile_r, np.float64)
    theta = np.linspace(0.0, 2.0 * np.pi, n_seg + 1)
    r = profile_r[:, None] * (1.0 + fluting * np.cos(flutes * theta)[None, :])
    x = r * np.cos(theta)[None, :]
    z = r * np.sin(theta)[None, :]
    y = np.broadcast_to(profile_y[:, None], r.shape)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    u = np.broadcast_to(theta[None, :] / (2 * np.pi), r.shape)
    vv = np.broadcast_to(
        ((profile_y - profile_y.min()) / max(np.ptp(profile_y), 1e-9))[:, None],
        r.shape,
    )
    uv = np.stack([u, vv], axis=-1).reshape(-1, 2)
    return verts, _grid_mesh(n_seg, len(profile_y) - 1), uv


def _bilerp_upsample(g: np.ndarray, h: int, w: int) -> np.ndarray:
    gh, gw = g.shape
    y = np.linspace(0, gh - 1, h)
    x = np.linspace(0, gw - 1, w)
    y0 = np.floor(y).astype(int)
    x0 = np.floor(x).astype(int)
    y1 = np.minimum(y0 + 1, gh - 1)
    x1 = np.minimum(x0 + 1, gw - 1)
    fy = (y - y0)[:, None]
    fx = (x - x0)[None, :]
    return (
        g[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
        + g[np.ix_(y0, x1)] * (1 - fy) * fx
        + g[np.ix_(y1, x0)] * fy * (1 - fx)
        + g[np.ix_(y1, x1)] * fy * fx
    )


def _value_noise(h: int, w: int, seed: int = 0, octaves: int = 5) -> np.ndarray:
    """[0,1] multi-octave value noise."""
    rng = np.random.default_rng(seed)
    out = np.zeros((h, w), np.float64)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        gh = max(2, min(h, 4 << o))
        gw = max(2, min(w, 4 << o))
        out += amp * _bilerp_upsample(rng.random((gh, gw)), h, w)
        total += amp
        amp *= 0.55
    return (out / total).astype(np.float32)


def _rgba(rgb: np.ndarray, alpha: np.ndarray | None = None) -> np.ndarray:
    a = (
        np.full(rgb.shape[:2] + (1,), 255, np.uint8)
        if alpha is None
        else (np.clip(alpha, 0, 1)[..., None] * 255).astype(np.uint8)
    )
    return np.concatenate([(np.clip(rgb, 0, 1) * 255).astype(np.uint8), a], axis=-1)


def _tex_stone(size: int, seed: int, tint=(0.75, 0.70, 0.62)) -> np.ndarray:
    v = 0.65 + 0.35 * _value_noise(size, size, seed)
    return _rgba(np.stack([v * tint[0], v * tint[1], v * tint[2]], axis=-1))


def _tex_floor(size: int, seed: int, tiles: int = 10) -> np.ndarray:
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    checker = ((yy * tiles // size + xx * tiles // size) % 2).astype(np.float64)
    n = _value_noise(size, size, seed)
    v = (0.35 + 0.4 * checker) * (0.8 + 0.25 * n)
    return _rgba(np.stack([v, v * 0.97, v * 0.9], axis=-1))


def _tex_banner(size: int, seed: int, color=(0.55, 0.12, 0.10)) -> np.ndarray:
    """Cloth with noise-carved holes and a ragged hem (alpha cutout)."""
    n = _value_noise(size, size, seed)
    yy = np.linspace(0, 1, size)[:, None] * np.ones((1, size))
    alpha = ((n > 0.32) | (yy < 0.75)).astype(np.float64)
    hem = 0.82 + 0.15 * _value_noise(1, size, seed + 1)[0]
    alpha *= (yy < hem[None, :]).astype(np.float64)
    shade = 0.7 + 0.3 * _value_noise(size, size, seed + 2)
    rgb = np.stack([shade * color[0], shade * color[1], shade * color[2]], axis=-1)
    return _rgba(rgb, alpha)


def atrium_scene(
    bays_x: int = 7,
    bays_z: int = 4,
    column_segments: int = 80,
    column_rows: int = 30,
    with_banners: bool = True,
):
    """Sponza-class courtyard (the renderer's bench workload).
    Returns (geometry, materials, lights, camera, atlas)."""
    from .textures import AtlasBuilder

    atlas = AtlasBuilder()
    t_stone = atlas.add(_tex_stone(512, 11), {})
    t_floor = atlas.add(_tex_floor(1024, 12), {})
    t_banner = atlas.add(_tex_banner(512, 13), {})
    t_wall = atlas.add(_tex_stone(512, 14, tint=(0.78, 0.72, 0.60)), {})

    rows = [
        dict(base_color_factor=[1, 1, 1, 1], roughness_factor=0.85,
             metallic_factor=0.0, base_color_texture=t_stone),
        dict(base_color_factor=[1, 1, 1, 1], roughness_factor=0.45,
             metallic_factor=0.0, base_color_texture=t_floor),
        dict(base_color_factor=[1, 1, 1, 1], roughness_factor=0.9,
             metallic_factor=0.0, base_color_texture=t_banner,
             alpha_mode=ALPHA_MASK, alpha_cutoff=0.5, double_sided=1),
        dict(base_color_factor=[1, 1, 1, 1], roughness_factor=0.95,
             metallic_factor=0.0, base_color_texture=t_wall),
        dict(base_color_factor=[0.6, 0.55, 0.45, 1.0], roughness_factor=0.4,
             metallic_factor=0.6),
    ]

    g = GeometryBuilder()
    bay = 4.0
    ex, ez = bays_x * bay / 2, bays_z * bay / 2
    story_h = 6.0

    shaft = np.linspace(0.9, story_h - 0.9, column_rows - 8)
    prof_y = np.concatenate([
        [0.0, 0.25, 0.6, 0.9], shaft,
        [story_h - 0.9, story_h - 0.55, story_h - 0.2, story_h],
    ])
    prof_r = np.concatenate([
        [0.55, 0.55, 0.42, 0.34], np.full(len(shaft), 0.32),
        [0.34, 0.44, 0.52, 0.52],
    ])
    cv, ci, cuv = _lathe(prof_y, prof_r, column_segments, fluting=0.06, flutes=20)

    xs = [(-ex + i * bay) for i in range(bays_x + 1)]
    zs = [(-ez + j * bay) for j in range(bays_z + 1)]
    col_pts = [(x, -ez) for x in xs] + [(x, ez) for x in xs]
    col_pts += [(-ex, z) for z in zs[1:-1]] + [(ex, z) for z in zs[1:-1]]
    for story in range(2):
        y0 = story * (story_h + 0.6)
        for (x, z) in col_pts:
            tr = np.eye(4)
            tr[:3, 3] = [x, y0, z]
            g.add_mesh(cv, ci, 0, uv=cuv, transform=tr)

    def slab(x0, z0, x1, z1, y, nx, nz, mat, uv_scale):
        gx = np.linspace(x0, x1, nx + 1)
        gz = np.linspace(z0, z1, nz + 1)
        zz, xx = np.meshgrid(gz, gx, indexing="ij")
        verts = np.stack([xx, np.full_like(xx, y), zz], -1).reshape(-1, 3)
        uv = np.stack(
            [
                (xx - x0) / max(x1 - x0, 1e-9) * uv_scale,
                (zz - z0) / max(z1 - z0, 1e-9) * uv_scale,
            ],
            -1,
        ).reshape(-1, 2)
        g.add_mesh(verts, _grid_mesh(nx, nz), mat, uv=uv)

    m = 1.6  # margin outside the colonnade
    slab(-ex - m, -ez - m, ex + m, ez + m, 0.0, 64, 40, 1, 8.0)
    wy = story_h + 0.3
    slab(-ex - m, -ez - m, ex + m, -ez + 1.2, wy, 48, 6, 3, 4.0)
    slab(-ex - m, ez - 1.2, ex + m, ez + m, wy, 48, 6, 3, 4.0)
    slab(-ex - m, -ez + 1.2, -ex + 1.2, ez - 1.2, wy, 6, 32, 3, 4.0)
    slab(ex - 1.2, -ez + 1.2, ex + m, ez - 1.2, wy, 6, 32, 3, 4.0)
    slab(-ex - m, -ez - m, ex + m, ez + m, 2 * story_h + 1.2, 48, 32, 3, 6.0)

    wh = 2 * story_h + 1.2
    for (a, b) in [
        ([-ex - m, 0, -ez - m], [ex + m, 0, -ez - m]),
        ([ex + m, 0, -ez - m], [ex + m, 0, ez + m]),
        ([ex + m, 0, ez + m], [-ex - m, 0, ez + m]),
        ([-ex - m, 0, ez + m], [-ex - m, 0, -ez - m]),
    ]:
        v0 = np.asarray(a, np.float64)
        v1 = np.asarray(b, np.float64)
        verts = np.stack([v0, v1, v1 + [0, wh, 0], v0 + [0, wh, 0]])
        uv = np.asarray([[0, 0], [6, 0], [6, 2], [0, 2]], np.float64)
        g.add_mesh(verts, np.asarray([[0, 1, 2], [0, 2, 3]]), 3, uv=uv)

    for story in range(2):
        y0 = story * (story_h + 0.6) + story_h
        for (x0, z0, sx, sz) in [
            (0, -ez, 2 * ex + 1.0, 0.8),
            (0, ez, 2 * ex + 1.0, 0.8),
            (-ex, 0, 0.8, 2 * ez + 1.0),
            (ex, 0, 0.8, 2 * ez + 1.0),
        ]:
            bv, bi = _box([x0, y0 + 0.3, z0], [sx, 0.6, sz])
            g.add_mesh(bv, bi, 4)

    if with_banners:
        rng = np.random.default_rng(5)
        for i in range(bays_x):
            for side in (-1, 1):
                if rng.uniform() < 0.5:
                    continue
                x = -ex + (i + 0.5) * bay
                z = side * (ez - 0.9)
                nxg, nyg = 12, 16
                gx = np.linspace(-0.9, 0.9, nxg + 1)
                gy = np.linspace(0.0, -2.6, nyg + 1)
                yy, xx = np.meshgrid(gy, gx, indexing="ij")
                ripple = 0.12 * np.sin(xx * 4.0 + yy * 2.0)
                verts = np.stack(
                    [xx + x, yy + wy - 0.1, np.full_like(xx, z) + ripple], -1
                ).reshape(-1, 3)
                uv = np.stack([(xx + 0.9) / 1.8, -yy / 2.6], -1).reshape(-1, 2)
                g.add_mesh(
                    verts, _grid_mesh(nxg, nyg), 2, uv=uv,
                    double_sided=True, alpha_mode=ALPHA_MASK,
                )

    mats = make_materials(rows)
    lights = make_lights([
        dict(type=LIGHT_POINT, position=[0.0, wh - 1.0, 0.0], intensity=1500.0),
        dict(type=LIGHT_POINT, position=[-ex * 0.6, story_h, 0.0], intensity=400.0),
        dict(type=LIGHT_POINT, position=[ex * 0.6, story_h, 0.0], intensity=400.0),
    ])
    cam = look_at_camera(
        eye=[-ex + 1.5, 2.2, -ez + 2.5], center=[ex * 0.5, 3.5, ez * 0.4],
        up=[0, 1, 0], fov_deg=60.0, aspect=16 / 9,
    )
    return g.build(), mats, lights, cam, atlas.build()


def _tex_foliage(size: int, seed: int) -> np.ndarray:
    """Leaf-cluster card texture: green clusters with alpha-cutout gaps
    (the foliage workload class of Bistro's trees)."""
    n = _value_noise(size, size, seed, octaves=6)
    n2 = _value_noise(size, size, seed + 1, octaves=4)
    # radial falloff so cards read as clusters, not squares
    yy, xx = np.meshgrid(
        np.linspace(-1, 1, size), np.linspace(-1, 1, size), indexing="ij"
    )
    rad = np.sqrt(xx * xx + yy * yy)
    alpha = ((n > 0.42) & (rad < 0.95)).astype(np.float64)
    g = 0.25 + 0.45 * n2
    rgb = np.stack([g * 0.35, g, g * 0.28], axis=-1)
    return _rgba(rgb, alpha)


def _tex_facade(size: int, seed: int) -> np.ndarray:
    """Plastered facade with darker window rectangles (matches the window
    grid displacement of the facade mesh)."""
    n = _value_noise(size, size, seed)
    base = 0.55 + 0.3 * n
    tint = [(0.82, 0.74, 0.62), (0.72, 0.70, 0.66), (0.78, 0.66, 0.58)][seed % 3]
    rgb = np.stack([base * tint[0], base * tint[1], base * tint[2]], axis=-1)
    # window rectangles: 6 columns x 4 rows, darker glass-blue
    yy, xx = np.meshgrid(
        np.linspace(0, 1, size), np.linspace(0, 1, size), indexing="ij"
    )
    wx = (xx * 6.0) % 1.0
    wy = (yy * 4.0) % 1.0
    win = (wx > 0.25) & (wx < 0.75) & (wy > 0.3) & (wy < 0.85)
    glass = np.stack(
        [0.10 + 0.1 * n, 0.12 + 0.1 * n, 0.16 + 0.12 * n], axis=-1
    )
    return _rgba(np.where(win[..., None], glass, rgb))


def _facade_mesh(nx: int, ny: int, w: float, h: float, seed: int):
    """Tessellated building front: a displaced grid with window insets and
    noise relief (dense planar regions like Bistro's facades)."""
    gx = np.linspace(-w / 2, w / 2, nx + 1)
    gy = np.linspace(0.0, h, ny + 1)
    yy, xx = np.meshgrid(gy, gx, indexing="ij")
    u = (xx + w / 2) / w
    v = yy / h
    wx = (u * 6.0) % 1.0
    wy = (v * 4.0) % 1.0
    win = (wx > 0.25) & (wx < 0.75) & (wy > 0.3) & (wy < 0.85)
    relief = _value_noise(64, 64, seed)
    ri = np.clip((v * 63).astype(int), 0, 63)
    rj = np.clip((u * 63).astype(int), 0, 63)
    zz = 0.05 * relief[ri, rj] - np.where(win, 0.18, 0.0)
    verts = np.stack([xx, yy, zz], -1).reshape(-1, 3)
    uv = np.stack([u, v], -1).reshape(-1, 2)
    return verts, _grid_mesh(nx, ny), uv


def _tree_meshes(detail: float, seed: int):
    """(trunk verts/idx/uv, leaf-card verts/idx/uv): a lathe trunk and a
    cloud of alpha-cutout leaf cards (two triangles each)."""
    rows = max(6, int(24 * detail))
    seg = max(6, int(36 * detail))
    prof_y = np.linspace(0.0, 3.2, rows)
    prof_r = 0.22 * (1.0 - prof_y / 4.2) + 0.02
    tv, ti, tuv = _lathe(prof_y, prof_r, seg)

    n_cards = max(12, int(420 * detail))
    rng = np.random.default_rng(seed)
    # card centers in a squashed sphere around the crown
    th = np.arccos(1 - 2 * rng.random(n_cards))
    ph = rng.random(n_cards) * 2 * np.pi
    rad = 1.4 * rng.random(n_cards) ** (1 / 3)
    cx = rad * np.sin(th) * np.cos(ph)
    cy = 3.6 + 0.8 * rad * np.cos(th)
    cz = rad * np.sin(th) * np.sin(ph)
    # random card orientations
    ax = rng.normal(size=(n_cards, 3))
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    up = np.where(
        np.abs(ax[:, 1:2]) < 0.9, np.asarray([[0.0, 1.0, 0.0]]),
        np.asarray([[1.0, 0.0, 0.0]]),
    )
    side = np.cross(ax, up)
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    upv = np.cross(side, ax)
    s = 0.55
    c = np.stack([cx, cy, cz], -1)
    corners = [
        c - s * side - s * upv, c + s * side - s * upv,
        c + s * side + s * upv, c - s * side + s * upv,
    ]
    lv = np.concatenate(corners, axis=0)
    i0 = np.arange(n_cards)
    li = np.concatenate(
        [
            np.stack([i0, i0 + n_cards, i0 + 2 * n_cards], 1),
            np.stack([i0, i0 + 2 * n_cards, i0 + 3 * n_cards], 1),
        ],
        axis=0,
    )
    luv = np.concatenate(
        [
            np.tile([0.0, 0.0], (n_cards, 1)), np.tile([1.0, 0.0], (n_cards, 1)),
            np.tile([1.0, 1.0], (n_cards, 1)), np.tile([0.0, 1.0], (n_cards, 1)),
        ],
        axis=0,
    )
    return (tv, ti, tuv), (lv, li, luv)


def bistro_scene(detail: float = 1.0, instanced: bool = True, seed: int = 9):
    """Bistro-class street: two building-lined blocks around a fountain
    plaza, instanced trees with alpha-cutout foliage, bistro tables —
    **>1M instantiated triangles at detail=1** (BASELINE config #5 class).

    ``instanced=True`` returns ``(pool, instances, mats, lights, cam,
    atlas)`` — the two-level TLAS/BLAS path with shared meshes
    (``build_instanced_scene``). ``instanced=False`` bakes every instance
    into world space (``(geometry, mats, lights, cam, atlas)``; the same
    surfaces, N x the memory), the world-space witness of the tests.
    """
    from .textures import AtlasBuilder
    from .instances import InstancedSceneBuilder

    d = float(detail)
    atlas = AtlasBuilder()
    t_cobble = atlas.add(_tex_floor(512, seed + 1, tiles=24), {})
    t_fac = [atlas.add(_tex_facade(512, seed + 2 + k), {}) for k in range(3)]
    t_leaf = atlas.add(_tex_foliage(512, seed + 7), {})
    t_stone = atlas.add(_tex_stone(512, seed + 8), {})

    rows = [
        dict(  # 0 street cobbles
            base_color_factor=[1, 1, 1, 1], roughness_factor=0.8,
            metallic_factor=0.0, base_color_texture=t_cobble,
        ),
        *[
            dict(  # 1..3 facades
                base_color_factor=[1, 1, 1, 1], roughness_factor=0.9,
                metallic_factor=0.0, base_color_texture=t,
            )
            for t in t_fac
        ],
        dict(  # 4 foliage (alpha cutout, double sided)
            base_color_factor=[1, 1, 1, 1], roughness_factor=0.95,
            metallic_factor=0.0, base_color_texture=t_leaf,
            alpha_mode=ALPHA_MASK, alpha_cutoff=0.5, double_sided=1,
        ),
        dict(  # 5 bark
            base_color_factor=[0.35, 0.25, 0.18, 1.0], roughness_factor=0.9,
            metallic_factor=0.0,
        ),
        dict(  # 6 fountain stone
            base_color_factor=[1, 1, 1, 1], roughness_factor=0.6,
            metallic_factor=0.0, base_color_texture=t_stone,
        ),
        dict(  # 7 bistro furniture (painted metal)
            base_color_factor=[0.25, 0.30, 0.33, 1.0], roughness_factor=0.35,
            metallic_factor=0.85,
        ),
    ]

    # --- unique meshes -----------------------------------------------------
    L, W = 120.0, 26.0  # street length / width
    street_v, street_i, street_uv = (lambda nx, nz: (
        np.stack(
            [
                np.meshgrid(np.linspace(-L / 2, L / 2, nx + 1),
                            np.linspace(-W / 2, W / 2, nz + 1),
                            indexing="xy")[0],
                np.zeros((nz + 1, nx + 1)),
                np.meshgrid(np.linspace(-L / 2, L / 2, nx + 1),
                            np.linspace(-W / 2, W / 2, nz + 1),
                            indexing="xy")[1],
            ],
            -1,
        ).reshape(-1, 3),
        _grid_mesh(nx, nz),
        np.stack(
            np.meshgrid(np.linspace(0, 24, nx + 1), np.linspace(0, 6, nz + 1),
                        indexing="xy"),
            -1,
        ).reshape(-1, 2),
    ))(max(8, int(620 * d)), max(6, int(380 * d)))

    fac_meshes = [
        _facade_mesh(max(6, int(124 * d)), max(5, int(78 * d)),
                     w=14.0, h=13.0, seed=seed + 11 + k)
        for k in range(3)
    ]
    (trunk_v, trunk_i, trunk_uv), (leaf_v, leaf_i, leaf_uv) = _tree_meshes(
        d, seed + 17
    )
    fy = np.linspace(0.0, 2.2, max(6, int(80 * d)))
    fr = 3.0 - 1.9 * (fy / 2.2) ** 0.7 + 0.25 * np.sin(fy * 6.0)
    fount_v, fount_i, fount_uv = _lathe(fy, fr, max(10, int(300 * d)))
    ty = np.asarray([0.0, 0.02, 0.70, 0.72, 0.74])
    trr = np.asarray([0.28, 0.28, 0.035, 0.42, 0.42])
    tab_v, tab_i, tab_uv = _lathe(ty, trr, max(8, int(22 * d)))

    # --- instance transforms -------------------------------------------------
    rng = np.random.default_rng(seed)

    def xform(pos, yaw=0.0, s=1.0):
        m = np.eye(4)
        cy, sy = np.cos(yaw), np.sin(yaw)
        m[:3, :3] = np.asarray(
            [[cy * s, 0, sy * s], [0, s, 0], [-sy * s, 0, cy * s]]
        )
        m[:3, 3] = pos
        return m

    placements = []  # (mesh_key, transform)
    placements.append(("street", np.eye(4)))
    placements.append(("fountain", xform([0.0, 0.0, 0.0])))
    n_bld = max(2, int(12 * min(1.0, d * 4)))
    for side in (-1, 1):
        for i in range(n_bld):
            x = -L / 2 + 8.0 + i * (L - 16.0) / max(n_bld - 1, 1)
            if abs(x) < 9.0:
                continue  # plaza gap
            k = int(rng.integers(3))
            placements.append(
                (f"facade{k}",
                 xform([x, 0.0, side * (W / 2)],
                       # grid normals point -z: rotate each side to face the
                       # street (side -1 sits at z=-W/2, street is +z of it)
                       yaw=np.pi if side < 0 else 0.0,
                       s=1.0 + 0.1 * rng.random()))
            )
    n_tree = max(2, int(30 * min(1.0, d * 4)))
    for side in (-1, 1):
        for i in range(n_tree):
            x = -L / 2 + 4.0 + i * (L - 8.0) / max(n_tree - 1, 1)
            z = side * (W / 2 - 2.4) + rng.uniform(-0.5, 0.5)
            if abs(x) < 6.5 and abs(z) < 6.5:
                continue
            yaw = rng.uniform(0, 2 * np.pi)
            s = 0.85 + 0.4 * rng.random()
            placements.append(("trunk", xform([x, 0.0, z], yaw, s)))
            placements.append(("leaves", xform([x, 0.0, z], yaw, s)))
    n_tab = max(2, int(30 * min(1.0, d * 4)))
    for i in range(n_tab):
        x = rng.uniform(-L / 2 + 5, L / 2 - 5)
        z = rng.uniform(-W / 2 + 3.4, W / 2 - 3.4)
        if abs(x) < 7.0 and abs(z) < 7.0:
            continue
        placements.append(("table", xform([x, 0.0, z], rng.uniform(0, 6.28))))

    meshes = {
        "street": (street_v, street_i, street_uv, 0, {}),
        "facade0": (*fac_meshes[0], 1, {}),
        "facade1": (*fac_meshes[1], 2, {}),
        "facade2": (*fac_meshes[2], 3, {}),
        "trunk": (trunk_v, trunk_i, trunk_uv, 5, {}),
        "leaves": (leaf_v, leaf_i, leaf_uv, 4,
                   dict(double_sided=True, alpha_mode=ALPHA_MASK)),
        "fountain": (fount_v, fount_i, fount_uv, 6, {}),
        "table": (tab_v, tab_i, tab_uv, 7, {}),
    }

    mats = make_materials(rows)
    lights = make_lights([
        dict(type=LIGHT_POINT, position=[0.0, 9.0, 0.0], intensity=900.0),
        dict(type=LIGHT_POINT, position=[-L / 4, 7.0, 0.0], intensity=500.0),
        dict(type=LIGHT_POINT, position=[L / 4, 7.0, 0.0], intensity=500.0),
    ])
    cam = look_at_camera(
        eye=[-L / 2 + 6.0, 2.4, -W / 2 + 5.0], center=[L / 6, 2.8, 0.0],
        up=[0, 1, 0], fov_deg=65.0, aspect=16 / 9,
    )

    if instanced:
        b = InstancedSceneBuilder()
        ids = {}
        for key, (v, i, uvq, mat, kw) in meshes.items():
            ids[key] = b.add_mesh(v, i, mat, uv=uvq, **kw)
        for key, m in placements:
            b.add_instance(ids[key], m)
        pool, instances = b.build()
        return pool, instances, mats, lights, cam, atlas.build()

    g = GeometryBuilder()
    for key, m in placements:
        v, i, uvq, mat, kw = meshes[key]
        g.add_mesh(v, i, mat, uv=uvq, transform=m, **kw)
    return g.build(), mats, lights, cam, atlas.build()

