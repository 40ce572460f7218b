"""Interactive progressive viewer of the port (counterpart of
``vk_raytrace_tpu/viewer.py``): a small HTTP server and a browser page in
place of the reference application's window and panel.

* progressive frames stream to the page (``/frame.png``), accumulating
  while the camera is still;
* mouse drag orbits, the wheel dollies, shift-drag pans (orbit about a
  pivot; the accumulation resets on a change); while the camera moves the
  frames render at 1/``VKRT_VIEW_DESCALE`` resolution (default 4) through a
  twin renderer that shares the acceleration structures;
* the control panel (POST ``/control``) edits the tonemapper (the
  accumulation is post-processed again, nothing retraced), the path
  settings (the renderer is rebuilt, the acceleration structures kept) and
  the sun&sky (re-baked);
* ``/pick?x=&y=`` reports the triangle, material and distance under a
  pixel (``Renderer.pick``) and makes the hit the orbit pivot;
* ``/state`` carries the frame count, the statistics and profiler panels
  and the per-frame ms, Mrays/s and device-memory rings;
* a scene file is watched; saving it loads it again on a worker thread.

The renderer's traversal back end is ``--renderer`` (the CLI's flag,
``fused`` by default) and switches at run time with ``set renderer wide``
or ``fused`` (the reference's pipeline switch, sample_gui.cpp:180-189): the
renderer is rebuilt over the same scene and acceleration structures, the
wide back end's 8-wide tables built at its first use. The tone curve is the
service's, passed to
``Renderer.postprocess(mode=)``. Device memory is read from the caching
allocator's counters after the frame's own synchronisation (no device sync
of its own).

Run: ``python -m vk_raytrace_torch.viewer --scene atrium --sun-sky --port
8722`` (the CLI's flags, ``--device cuda`` by default), then open
``http://localhost:8722/`` or drive it with curl::

    curl -s localhost:8722/state
    curl -s -o f.png localhost:8722/frame.png
    curl -s -d '{"cmd": "orbit", "dx": 40, "dy": 10}' localhost:8722/control
    curl -s 'localhost:8722/pick?x=640&y=360'
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import threading
import time
import traceback
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


# ----------------------------------------------------------------------------
# Camera manipulation (CameraManip.cpp orbit semantics)
# ----------------------------------------------------------------------------

class OrbitCamera:
    """Eye / pivot orbit state; produces the port's ``Camera`` on demand.

    The pivot is derived from the scene like CameraManip's interest point:
    the centre of the scene's bounds projected onto the view ray, and
    :meth:`set_pivot` re-targets it from a pick."""

    def __init__(self, camera, width: int, height: int, bounds=None):
        vi = np.asarray(camera.view_inverse, np.float64)
        self.eye = vi[:3, 3].copy()
        fwd = -vi[:3, 2]
        if bounds is not None:
            c = (np.asarray(bounds[0]) + np.asarray(bounds[1])) * 0.5
            # the scene centre projected onto the view ray, kept in front
            self.dist = float(max(np.dot(c - self.eye, fwd), 1.0))
        else:
            self.dist = 3.0
        self.center = self.eye + fwd * self.dist
        self.up = np.array([0.0, 1.0, 0.0])
        fy = abs(float(np.asarray(camera.proj_inverse)[1, 1]))  # tan(fov / 2)
        self.fov = float(np.degrees(2.0 * np.arctan(fy))) if fy > 0 else 60.0
        self.width, self.height = width, height
        self.focal = float(np.asarray(camera.focal_dist))
        self.aperture = float(np.asarray(camera.aperture))

    def set_pivot(self, p) -> None:
        self.center = np.asarray(p, np.float64).copy()

    def orbit(self, dx: float, dy: float) -> None:
        off = self.eye - self.center
        r = np.linalg.norm(off)
        theta = np.arctan2(off[0], off[2]) - dx * 0.005
        phi = np.arccos(np.clip(off[1] / max(r, 1e-9), -1, 1)) + dy * 0.005
        phi = np.clip(phi, 0.05, np.pi - 0.05)
        self.eye = self.center + r * np.array(
            [np.sin(phi) * np.sin(theta), np.cos(phi), np.sin(phi) * np.cos(theta)])

    def dolly(self, amount: float) -> None:
        self.eye = self.center + (self.eye - self.center) * float(np.exp(amount * 0.1))

    def pan(self, dx: float, dy: float) -> None:
        fwd = self.center - self.eye
        r = np.linalg.norm(fwd)
        fwd = fwd / max(r, 1e-9)
        side = np.cross(fwd, self.up)
        side /= max(np.linalg.norm(side), 1e-9)
        upv = np.cross(side, fwd)
        move = (-side * dx + upv * dy) * 0.002 * r
        self.eye = self.eye + move
        self.center = self.center + move

    def camera(self):
        from .models.procedural import look_at_camera

        return look_at_camera(self.eye, self.center, self.up, self.fov,
                              self.width / self.height, self.focal, self.aperture)

    # -- bookmarks (the reference application's per-scene camera JSON) ----
    def to_dict(self) -> dict:
        return {"eye": [float(v) for v in self.eye], "center": [float(v) for v in self.center],
                "up": [float(v) for v in self.up], "fov": self.fov, "focal": self.focal,
                "aperture": self.aperture}

    def from_dict(self, d: dict) -> None:
        self.eye = np.asarray(d["eye"], np.float64)
        self.center = np.asarray(d["center"], np.float64)
        self.up = np.asarray(d.get("up", [0, 1, 0]), np.float64)
        self.fov = float(d.get("fov", self.fov))
        self.focal = float(d.get("focal", self.focal))
        self.aperture = float(d.get("aperture", self.aperture))


def _bookmark_path(scene_arg: str):
    """Per-scene camera bookmarks: ``<scene>.cameras.json`` beside a scene
    file, or ``cameras-<name>.json`` in the port's cache directory
    (``utils/cache.py``) for a built-in scene; None when the cache is off."""
    from .utils import cache

    if os.path.exists(scene_arg):
        return scene_arg + ".cameras.json"
    d = cache.cache_dir()
    return None if d is None else os.path.join(d, f"cameras-{scene_arg}.json")


def load_bookmarks(scene_arg: str) -> list:
    path = _bookmark_path(scene_arg)
    try:
        with open(path) as f:
            return json.load(f)
    except (TypeError, OSError, ValueError):  # no path, no file, or not JSON
        return []


def save_bookmarks(scene_arg: str, marks: list) -> None:
    path = _bookmark_path(scene_arg)
    if path is None:
        return
    try:
        with open(path, "w") as f:
            json.dump(marks, f, indent=1)
    except OSError as e:
        print(f"viewer: bookmarks not saved to {path}: {e}", file=sys.stderr)


def _png_bytes(img01: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of a [0, 1] float image (``utils/png.py``)."""
    from .utils import png

    return png.encode(png.to_uint8(img01))


def _scene_stats(r) -> str:
    """The statistics panel (sample_gui.cpp:330-363): the scene's inventory."""
    from .ops.tlas import InstancedAccel

    g = r.scene.geometry
    lines = [
        f"triangles {int(g.indices.shape[0]):>10,}",
        f"materials {int(r.scene.materials.ior.shape[0]):>10,}",
        f"textures  {int(r.scene.atlas.x.shape[0]):>10,}",
        f"lights    {int(r.scene.n_lights):>10,}",
    ]
    p = r.packed
    if isinstance(p, InstancedAccel):
        blas = p.blas if r.renderer == "wide" else p.blas_planar
        lines += [
            f"instances {int(p.inst.mesh_id.shape[0]):>10,}",
            f"meshes    {int(p.mesh_root_planar.shape[0]):>10,}",
            f"BVH rows  {int(blas.rows.shape[0]):>10,}",
        ]
    else:
        trees = (p.opaque, p.alpha) if r.renderer == "wide" else (p.opaque_planar, p.alpha_planar)
        rows = sum(int(t.rows.shape[0]) for t in trees if t is not None)
        lines.append(f"BVH rows  {rows:>10,}")
    return "\n".join(lines)


def _device_mib() -> float:
    """MiB the caching allocator holds on the current card (-1: no card).
    A host-side counter: it does not synchronise the device."""
    from .utils.profiler import device_memory_stats

    mem = device_memory_stats()
    return mem[0]["bytes_in_use"] / 2**20 if mem else -1.0


def _prof_stats(r, t_frame: float, cfg, mem_mib: float = -1.0) -> str:
    """The profiler panel (sample_gui.cpp:368-423): the frame's timing,
    Mrays/s, the build times and the device memory in use."""
    rays = getattr(r, "last_rays", 0)
    lines = [
        f"frame     {r.frame:>10,}",
        f"spp       {r.frame * cfg.max_samples:>10,}",
        f"ms/frame  {1000 * t_frame:>10.1f}",
        f"Mrays/s   {rays / max(t_frame, 1e-9) / 1e6:>10.2f}",
    ]
    for k, v in getattr(r, "build_times", {}).items():
        lines.append(f"{k:<9s} {v:>9.1f}s")
    if mem_mib >= 0:
        lines.append(f"dev mem   {mem_mib:>8.0f}MB")
    return "\n".join(lines)


# ----------------------------------------------------------------------------
# The page
# ----------------------------------------------------------------------------

# The control inventory of sample_gui.cpp: camera and aperture (:109-117),
# the ray-tracing settings with the 13 debug modes and the back end
# (:122-193; the port has one, ``fused``), the tonemapper (:196-242), the
# sun&sky editor (:247-325), the statistics (:330-363) and the profiler with
# its plots (:368-423).
_PAGE = """<!doctype html><html><head><title>vk_raytrace_torch</title><style>
body{margin:0;background:#111;color:#ccc;font:12px monospace;display:flex}
#img{image-rendering:pixelated;cursor:grab;align-self:flex-start}
#panel{padding:10px;min-width:250px;max-height:100vh;overflow-y:auto}
label{display:block;margin-top:4px}
input[type=range]{width:130px;vertical-align:middle}
select{background:#222;color:#ccc}
details{margin-top:8px;border-top:1px solid #333;padding-top:4px}
summary{color:#ca8;cursor:pointer}
.v{color:#8ac;display:inline-block;width:44px;text-align:right}
#stats,#prof{margin-top:8px;white-space:pre;color:#8c8}
.pl{margin-top:4px;color:#589}
.pl canvas{display:block;background:#181818;border:1px solid #333}
#pick{margin-top:8px;white-space:pre;color:#88c}
</style></head><body>
<img id="img" width="__W__" height="__H__">
<div id="panel">
 <b>vk_raytrace_torch viewer</b>
 <details open><summary>camera</summary>
  <label>fov <span class="v" id="v_fov">60</span><input type="range" id="fov" min="10" max="120" step="1" value="60"></label>
  <label>aperture <span class="v" id="v_aperture">0</span><input type="range" id="aperture" min="0" max="0.5" step="0.005" value="0"></label>
  <label>focal dist <span class="v" id="v_focal">0</span><input type="range" id="focal" min="0" max="60" step="0.2" value="0"></label>
 </details>
 <details open><summary>ray tracing</summary>
  <label>max depth <span class="v" id="v_depth">__D__</span><input type="range" id="depth" min="1" max="10" step="1" value="__D__"></label>
  <label>samples/frame <span class="v" id="v_spp">1</span><input type="range" id="spp" min="1" max="8" step="1" value="1"></label>
  <label>max frames <span class="v" id="v_maxframes">0</span><input type="range" id="maxframes" min="0" max="4096" step="16" value="0"></label>
  <label>pbr model <select id="pbr"><option value="1">glTF</option><option value="0">Disney</option></select></label>
  <label>renderer <select id="renderer"><option value="fused">fused (planar trees)</option><option value="wide">wide (8-wide, alpha in traversal)</option></select></label>
  <label>debug mode <select id="debug">
   <option value="0">none</option><option value="1">base color</option>
   <option value="2">normal</option><option value="3">metallic</option>
   <option value="4">emissive</option><option value="5">alpha</option>
   <option value="6">roughness</option><option value="7">texcoord</option>
   <option value="8">tangent</option><option value="9">radiance</option>
   <option value="10">weight</option><option value="11">ray dir</option>
   <option value="12">heatmap</option></select></label>
  <label><input type="checkbox" id="pause"> pause</label>
 </details>
 <details><summary>tonemapper</summary>
  <label>curve <select id="tonemode"><option value="0">Uncharted2</option>
   <option value="1">Hejl-Richard</option><option value="2">ACES</option></select></label>
  <label>exposure <span class="v" id="v_exposure">0</span><input type="range" id="exposure" min="-4" max="4" step="0.1" value="0"></label>
  <label>brightness <span class="v" id="v_brightness">1</span><input type="range" id="brightness" min="0.1" max="3" step="0.05" value="1"></label>
  <label>contrast <span class="v" id="v_contrast">1</span><input type="range" id="contrast" min="0.1" max="3" step="0.05" value="1"></label>
  <label>saturation <span class="v" id="v_saturation">1</span><input type="range" id="saturation" min="0" max="2" step="0.05" value="1"></label>
  <label>vignette <span class="v" id="v_vignette">0</span><input type="range" id="vignette" min="0" max="2" step="0.05" value="0"></label>
  <label>auto exposure <select id="autoexp"><option value="0">off</option>
   <option value="1">global</option><option value="3">local</option></select></label>
  <label><input type="checkbox" id="dither"> dither</label>
 </details>
 <details><summary>sun &amp; sky</summary>
  <label><input type="checkbox" id="sunsky" __SS__> enabled</label>
  <label>azimuth <span class="v" id="v_azimuth">80</span><input type="range" id="azimuth" min="-180" max="180" step="2" value="80"></label>
  <label>elevation <span class="v" id="v_elevation">15</span><input type="range" id="elevation" min="1" max="89" step="1" value="15"></label>
  <label>haze <span class="v" id="v_haze">0</span><input type="range" id="haze" min="0" max="15" step="0.25" value="0"></label>
  <label>red-blue shift <span class="v" id="v_rbshift">0</span><input type="range" id="rbshift" min="-1" max="1" step="0.05" value="0"></label>
  <label>sky saturation <span class="v" id="v_skysat">1</span><input type="range" id="skysat" min="0" max="1" step="0.05" value="1"></label>
  <label>horizon height <span class="v" id="v_horizon">0</span><input type="range" id="horizon" min="-1" max="1" step="0.02" value="0"></label>
  <label>horizon blur <span class="v" id="v_horizonblur">0.1</span><input type="range" id="horizonblur" min="0" max="1" step="0.02" value="0.1"></label>
  <label>sun disk intensity <span class="v" id="v_sundisk">1</span><input type="range" id="sundisk" min="0" max="5" step="0.1" value="1"></label>
  <label>sun disk scale <span class="v" id="v_sunscale">1</span><input type="range" id="sunscale" min="0.1" max="10" step="0.1" value="1"></label>
  <label>sun glow <span class="v" id="v_sunglow">1</span><input type="range" id="sunglow" min="0" max="5" step="0.1" value="1"></label>
 </details>
 <details open><summary>bookmarks</summary>
  <button id="bmsave">save view</button> <button id="bmclear">clear</button>
  <div id="bmlist"></div>
 </details>
 <details open><summary>statistics</summary><div id="stats"></div></details>
 <details open><summary>profiler</summary><div id="prof"></div>
  <div id="plots">
   <div class="pl">ms/frame <canvas id="pl_ms" width="230" height="36"></canvas></div>
   <div class="pl">Mrays/s <canvas id="pl_mrays" width="230" height="36"></canvas></div>
   <div class="pl">dev mem MB <canvas id="pl_mem" width="230" height="36"></canvas></div>
  </div></details>
 <div id="pick">click image to pick (sets orbit pivot)</div>
</div>
<script>
const img = document.getElementById('img');
let drag = null;
function post(o){fetch('/control',{method:'POST',body:JSON.stringify(o)});}
img.onmousedown = e => {drag = [e.clientX, e.clientY, e.shiftKey]; e.preventDefault();};
window.onmouseup = e => {
  if (drag && Math.abs(e.clientX-drag[0])<2 && Math.abs(e.clientY-drag[1])<2) {
    const r = img.getBoundingClientRect();
    fetch('/pick?x='+Math.round(e.clientX-r.left)+'&y='+Math.round(e.clientY-r.top))
      .then(r=>r.json()).then(j=>{document.getElementById('pick').textContent=JSON.stringify(j,null,1);});
  }
  drag = null;
};
window.onmousemove = e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (Math.abs(dx)+Math.abs(dy) < 2) return;
  post(drag[2] ? {cmd:'pan',dx:dx,dy:dy} : {cmd:'orbit',dx:dx,dy:dy});
  drag = [e.clientX, e.clientY, drag[2]];
};
img.onwheel = e => {post({cmd:'dolly',amount:Math.sign(e.deltaY)}); e.preventDefault();};
const sliders = ['fov','aperture','focal','depth','spp','maxframes','exposure','brightness',
 'contrast','saturation','vignette','azimuth','elevation','haze','rbshift',
 'skysat','horizon','horizonblur','sundisk','sunscale','sunglow'];
for (const id of sliders)
  document.getElementById(id).oninput = e => {
    const el = document.getElementById('v_'+id);
    if (el) el.textContent = e.target.value;
    post({cmd:'set',key:id,value:+e.target.value});
  };
for (const id of ['debug','pbr','tonemode','autoexp'])
  document.getElementById(id).onchange = e => post({cmd:'set',key:id,value:+e.target.value});
document.getElementById('renderer').onchange = e => post({cmd:'set',key:'renderer',value:e.target.value});
document.getElementById('bmsave').onclick = () => post({cmd:'bookmark_save'});
document.getElementById('bmclear').onclick = () => post({cmd:'bookmark_clear'});
let bmCount = -1;
function renderBookmarks(n){
  if (n === bmCount) return; bmCount = n;
  const el = document.getElementById('bmlist'); el.innerHTML = '';
  for (let i = 0; i < n; i++) {
    const b = document.createElement('button');
    b.textContent = 'cam ' + (i+1);
    b.onclick = () => post({cmd:'bookmark_goto',index:i});
    el.appendChild(b);
  }
}
for (const id of ['pause','dither','sunsky'])
  document.getElementById(id).onchange = e => post({cmd:'set',key:id,value:e.target.checked?1:0});
function spark(id, xs){
  const c = document.getElementById(id), g = c.getContext('2d');
  g.clearRect(0, 0, c.width, c.height);
  if (!xs || xs.length < 2) return;
  const lo = Math.min(...xs), hi = Math.max(...xs), span = (hi - lo) || 1;
  g.strokeStyle = '#8ac'; g.beginPath();
  xs.forEach((v, i) => {
    const x = i * (c.width - 2) / (xs.length - 1) + 1;
    const y = c.height - 2 - (v - lo) * (c.height - 4) / span;
    i ? g.lineTo(x, y) : g.moveTo(x, y);
  });
  g.stroke();
  g.fillStyle = '#589'; g.font = '9px monospace';
  g.fillText(hi.toFixed(1), 2, 9);
  g.fillText(lo.toFixed(1), 2, c.height - 2);
}
async function tick(){
  img.src = '/frame.png?t=' + Date.now();
  const s = await (await fetch('/state')).json();
  document.getElementById('stats').textContent = s.stats || '';
  document.getElementById('prof').textContent = (s.busy ? 'BUSY: loading scene...\n' : '') + (s.prof || '');
  renderBookmarks(s.bookmarks || 0);
  if (s.hist) { spark('pl_ms', s.hist.ms); spark('pl_mrays', s.hist.mrays); spark('pl_mem', s.hist.mem); }
}
setInterval(tick, 700); tick();
</script></body></html>"""


class ViewerService:
    """The render loop (:meth:`run_render_loop`, on its own thread), the
    control queue it drains before each frame, and the latest frame and
    state that the HTTP handler (:meth:`make_handler`) serves. ``args``:
    :func:`build_parser`'s namespace. Stop the loop by setting ``_stop``."""

    def __init__(self, args):
        import torch

        self.args = args
        self.device = torch.device(args.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise SystemExit("vk_raytrace_torch viewer: CUDA is not available; use --device cpu")
        self._lock = threading.Lock()
        self._controls = []
        self._frame_png = _png_bytes(np.zeros((args.size[1], args.size[0], 3)))
        self._state = {"frame": 0, "spp": 0, "ms_per_frame": 0}
        self._stop = False
        self._busy = False
        self._renderer = None
        self._tone_mode = 0
        self._bookmarks = load_bookmarks(args.scene)
        self._scene_path = args.scene if os.path.exists(args.scene) else None
        self._mtime = os.path.getmtime(self._scene_path) if self._scene_path else 0

    # -- render thread -----------------------------------------------------
    def run_render_loop(self):
        import torch

        from . import cli as C
        from . import render as R
        from .integrator.camera import with_aspect
        from .models.schema import RenderConfig

        args, dev = self.args, self.device
        scene, env = C.load_scene_from_args(args, dev)
        self._scene0 = scene  # pristine: the sun&sky not baked, instances intact
        w, h = args.size
        # The environment's weight as the CLI sets it: 1 with an HDR
        # environment or the sun&sky (the reference viewer leaves the sun&sky
        # at 0).
        def hdr_mult(sun_sky):
            return 1.0 if (env is not None or sun_sky) else 0.0

        cfg = RenderConfig(width=w, height=h, max_depth=args.depth, max_samples=1,
                           firefly_clamp=10.0, hdr_multiplier=hdr_mult(args.sun_sky),
                           use_sun_sky=bool(args.sun_sky))
        backend = [args.renderer]  # the traversal back end, switched by "set renderer"
        r = R.Renderer(scene, cfg, device=dev, fused_shade=args.fused_shade, renderer=backend[0])
        cam = OrbitCamera(scene.camera, w, h, bounds=_bounds(scene))
        self._cam = cam
        pause = False
        t_frame = 0.0
        sunsky = scene.sun_sky
        descale_left = 0  # frames left to render at 1/DS (a drag in progress)
        r_small = [None]  # the descaled twin, built lazily for the current cfg

        def renderer(sc, c):
            return R.Renderer(sc, c, device=dev, tonemapper=r.tonemapper, packed=r.packed,
                              fused_shade=args.fused_shade, renderer=backend[0])

        def rebuild(new_cfg, new_sunsky=None):
            """A path-setting edit: retrace, but keep the acceleration
            structures (createRender, sample_example.cpp:322-337); a sun&sky
            edit bakes the sky again."""
            nonlocal cfg, r, sunsky
            cfg = new_cfg
            if new_sunsky is not None:
                sunsky = new_sunsky
            r = renderer(dataclasses.replace(self._scene0, sun_sky=sunsky, camera=cam.camera(),
                                             instances=None), cfg)
            r_small[0] = None

        # Interaction descaling (sample_example.cpp:410-415): while the camera
        # moves, frames render at 1/DS resolution through a twin renderer that
        # shares the acceleration structures, upscaled for display; the
        # full-resolution accumulation restarts when the drag ends.
        DS = max(1, int(os.environ.get("VKRT_VIEW_DESCALE", "4")))

        def get_small():
            if r_small[0] is None and DS > 1:
                scfg = dataclasses.replace(cfg, width=max(8, w // DS), height=max(8, h // DS))
                r_small[0] = renderer(dataclasses.replace(
                    self._scene0, sun_sky=sunsky, camera=cam.camera(), instances=None), scfg)
            return r_small[0]

        def set_sunsky(**kw):
            vals = {k: np.asarray(v, np.float32) for k, v in kw.items()}
            rebuild(cfg, new_sunsky=dataclasses.replace(sunsky, **vals))

        sun_az, sun_el = [80.0], [15.0]  # the sliders' state, degrees

        def sun_dir():
            az, el = np.radians(sun_az[0]), np.radians(sun_el[0])
            return np.asarray([np.cos(el) * np.sin(az), np.sin(el), np.cos(el) * np.cos(az)],
                              np.float32)

        def tm_value(key, v, dtype=torch.float32):
            return dataclasses.replace(r.tonemapper,
                                       **{key: torch.tensor(v, dtype=dtype, device=dev)})

        # Monotonic counters (descaled frames presented, accumulation resets):
        # the transient ``descaled`` flag can slip between an observer's polls.
        n_desc = 0
        n_resets = 0
        # Per-frame rings for the profiler's plots (the reference
        # application's NVML sampling ring, nvml_monitor.hpp:56-176).
        hist_ms: deque = deque(maxlen=120)
        hist_mrays: deque = deque(maxlen=120)
        hist_mem: deque = deque(maxlen=120)
        while not self._stop:
            # Queued controls: the camera resets the accumulation; the
            # tonemapper posts it again; path settings rebuild (accel kept).
            with self._lock:
                controls, self._controls = self._controls, []
            dirty_cam = False
            for c in controls:
                cmd = c.get("cmd")
                if cmd == "_swap":  # a reload finished (see _load_async)
                    self._scene0, r, cam = c["scene"], c["renderer"], c["cam"]
                    cfg = r.cfg
                    self._cam = cam
                    r_small[0] = None
                    continue
                if cmd == "bookmark_save":
                    self._bookmarks.append(cam.to_dict())
                    save_bookmarks(args.scene, self._bookmarks)
                elif cmd == "bookmark_goto":
                    i = int(c.get("index", -1))
                    if 0 <= i < len(self._bookmarks):
                        cam.from_dict(self._bookmarks[i])
                        dirty_cam = True
                elif cmd == "bookmark_clear":
                    self._bookmarks = []
                    save_bookmarks(args.scene, self._bookmarks)
                elif cmd == "orbit":
                    cam.orbit(c["dx"], c["dy"])
                    dirty_cam = True
                elif cmd == "dolly":
                    cam.dolly(c["amount"])
                    dirty_cam = True
                elif cmd == "pan":
                    cam.pan(c["dx"], c["dy"])
                    dirty_cam = True
                elif cmd == "pivot":
                    cam.set_pivot(c["p"])
                    dirty_cam = True
                elif cmd == "set":
                    key, val = c["key"], c["value"]
                    if key == "pause":
                        pause = bool(val)
                    # -- camera (sample_gui.cpp:109-117)
                    elif key in ("fov", "aperture", "focal"):
                        setattr(cam, key, float(val))
                        dirty_cam = True
                    # -- tonemapper (:196-242): posted again, not retraced
                    elif key == "exposure":  # avgLum, tonemapping.glsl:86-88
                        r.tonemapper = tm_value("avg_lum", 2.0 ** float(val))
                    elif key in ("brightness", "contrast", "saturation", "vignette"):
                        r.tonemapper = tm_value(key, float(val))
                    elif key == "autoexp":
                        r.tonemapper = tm_value("auto_exposure", int(val), torch.int32)
                    elif key == "dither":
                        r.tonemapper = tm_value("dither", int(val), torch.int32)
                    elif key == "tonemode":
                        self._tone_mode = int(val)
                    # -- ray tracing (:122-193)
                    elif key in ("depth", "spp", "debug", "pbr"):
                        field = {"depth": "max_depth", "spp": "max_samples",
                                 "debug": "debug_mode", "pbr": "pbr_mode"}[key]
                        rebuild(dataclasses.replace(cfg, **{field: int(val)}))
                        dirty_cam = True
                    elif key == "maxframes":
                        # The convergence stop (0: the default 100000); a
                        # host-side gate: no retrace, no reset.
                        mf = int(val) if val else 100000
                        cfg = dataclasses.replace(cfg, max_frames=mf)
                        r.cfg = dataclasses.replace(r.cfg, max_frames=mf)
                    elif key == "renderer":
                        # The pipeline switch (sample_gui.cpp:180-189): the
                        # renderer rebuilt over the same scene and tables.
                        if val in ("fused", "wide"):
                            backend[0] = val
                            rebuild(cfg)
                            dirty_cam = True
                        else:
                            print(f"viewer: no renderer {val!r}; the port has 'fused' and "
                                  "'wide'", file=sys.stderr)
                    # -- sun & sky (:247-325)
                    elif key == "sunsky":
                        rebuild(dataclasses.replace(cfg, use_sun_sky=bool(val),
                                                    hdr_multiplier=hdr_mult(bool(val))))
                        dirty_cam = True
                    elif key in ("azimuth", "elevation"):
                        (sun_az if key == "azimuth" else sun_el)[0] = float(val)
                        set_sunsky(sun_direction=sun_dir())
                        dirty_cam = True
                    elif key in _SUNSKY_KEYS:
                        set_sunsky(**{_SUNSKY_KEYS[key]: float(val)})
                        dirty_cam = True
            if dirty_cam:
                r.scene = dataclasses.replace(r.scene, camera=with_aspect(cam.camera(), w, h).to(dev))
                r.reset()
                n_resets += 1
                descale_left = 2 if DS > 1 else 0

            # The scene file's hot reload (main.cpp:183-191,
            # sample_example.cpp:119-162): loaded and built on a worker
            # thread while the old scene keeps rendering, then swapped in at
            # the top of a frame.
            if self._scene_path and not self._busy:
                m = os.path.getmtime(self._scene_path)
                if m != self._mtime:
                    self._mtime = m
                    self._busy = True
                    threading.Thread(target=self._load_async,
                                     args=(cfg, r.tonemapper, backend[0]),
                                     daemon=True).start()

            if pause or r.converged:
                # m_maxFrames reached (sample_example.cpp:407-408): keep
                # serving the finished image, trace nothing.
                time.sleep(0.1)
                continue

            t0 = time.time()
            was_descaled = descale_left > 0 and DS > 1
            if was_descaled:
                rs = get_small()
                rs.scene = dataclasses.replace(
                    rs.scene, camera=with_aspect(cam.camera(), rs.cfg.width, rs.cfg.height).to(dev))
                rs.tonemapper = r.tonemapper
                rs.reset()
                rs.step()
                img = rs.postprocess(mode=self._tone_mode).cpu().numpy()
                img = img.repeat(DS, axis=0).repeat(DS, axis=1)[:h, :w]
                descale_left -= 1
                n_desc += 1
            else:
                r.step()
                img = r.postprocess(mode=self._tone_mode).cpu().numpy()
            t_frame = time.time() - t0
            # After the frame's own synchronisation (the copy to the host):
            # the allocator's counter, no device sync of its own.
            mem_mib = _device_mib()
            png = _png_bytes(img)
            hist_ms.append(round(1000 * t_frame, 2))
            hist_mrays.append(round(getattr(r, "last_rays", 0) / max(t_frame, 1e-9) / 1e6, 3))
            if mem_mib >= 0:
                hist_mem.append(round(mem_mib, 1))
            state = {
                "frame": r.frame,
                "busy": self._busy,
                "descaled": was_descaled,
                "descale_frames": n_desc,
                "resets": n_resets,
                "bookmarks": len(self._bookmarks),
                "stats": _scene_stats(r),
                "prof": _prof_stats(r, t_frame, cfg, mem_mib),
                "hist": {"ms": list(hist_ms), "mrays": list(hist_mrays), "mem": list(hist_mem)},
            }
            with self._lock:
                self._frame_png = png
                self._renderer = r
                self._state = state

    def _load_async(self, cfg, tonemapper, renderer="fused"):
        """Load the scene file again and build its renderer; queue the swap.
        A failure is reported on stderr, and the old scene stays."""
        from . import cli as C
        from . import render as R

        try:
            scene, _ = C.load_scene_from_args(self.args, self.device)
            nr = R.Renderer(scene, cfg, device=self.device, tonemapper=tonemapper,
                            fused_shade=self.args.fused_shade, renderer=renderer)
            nc = OrbitCamera(scene.camera, *self.args.size, bounds=_bounds(scene))
            with self._lock:
                self._controls.append({"cmd": "_swap", "scene": scene, "renderer": nr, "cam": nc})
        except Exception:  # a half-saved file: keep the old scene, say why
            print(f"viewer: reloading {self._scene_path} failed:\n{traceback.format_exc()}",
                  file=sys.stderr)
        finally:
            self._busy = False

    def page(self) -> bytes:
        w, h = self.args.size
        return (_PAGE.replace("__W__", str(w)).replace("__H__", str(h))
                .replace("__D__", str(self.args.depth))
                .replace("__SS__", "checked" if self.args.sun_sky else "")).encode()

    def pick(self, x: int, y: int):
        """``Renderer.pick`` on the latest frame's renderer, as JSON-ready
        values; a hit becomes the orbit pivot."""
        with self._lock:
            r = self._renderer
        res = r.pick(x, y) if r is not None else None
        if res:
            res = {k: (v.tolist() if hasattr(v, "tolist") else v) for k, v in res.items()}
            with self._lock:
                self._controls.append({"cmd": "pivot", "p": res["position"]})
        return res

    # -- HTTP --------------------------------------------------------------
    def make_handler(service):
        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    with service._lock:
                        png = service._frame_png
                    self._send(200, "image/png", png)
                elif self.path.startswith("/state"):
                    with service._lock:
                        st = dict(service._state)
                    self._send(200, "application/json", json.dumps(st).encode())
                elif self.path.startswith("/pick"):
                    from urllib.parse import parse_qs, urlparse

                    q = parse_qs(urlparse(self.path).query)
                    try:
                        x, y = int(q["x"][0]), int(q["y"][0])
                    except (KeyError, ValueError) as e:
                        self._send(400, "text/plain", f"pick needs x and y: {e}".encode())
                        return
                    self._send(200, "application/json", json.dumps(service.pick(x, y)).encode())
                else:
                    self._send(200, "text/html", service.page())

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    c = json.loads(self.rfile.read(n) or b"{}")
                except ValueError as e:
                    self._send(400, "text/plain", str(e).encode())
                    return
                with service._lock:
                    service._controls.append(c)
                self._send(200, "application/json", b"{}")

        return H


# The sun&sky sliders that set one field of ``SunSky``.
_SUNSKY_KEYS = {"haze": "haze", "rbshift": "redblueshift", "skysat": "saturation",
                "horizon": "horizon_height", "horizonblur": "horizon_blur",
                "sundisk": "sun_disk_intensity", "sunscale": "sun_disk_scale",
                "sunglow": "sun_glow_intensity"}


def _bounds(scene):
    """The scene's world bounds (of the instanced geometry's object-space
    pool for a two-level scene, as the reference takes them), or None."""
    pos = np.asarray(scene.geometry.positions)
    return (pos.min(axis=0), pos.max(axis=0)) if len(pos) else None


def build_parser() -> argparse.ArgumentParser:
    """The CLI's parser (``cli.build_parser``) and ``--port``."""
    from .cli import build_parser as cli_parser

    p = argparse.ArgumentParser(parents=[cli_parser()], add_help=False,
                                conflict_handler="resolve", prog="vk_raytrace_torch.viewer")
    p.add_argument("--port", type=int, default=8722)
    return p


def serve(svc: ViewerService, host: str, port: int) -> ThreadingHTTPServer:
    """An HTTP server of ``svc`` on ``host:port`` (0: any free port; the
    bound one is ``server_address[1]``), not yet serving."""
    return ThreadingHTTPServer((host, port), svc.make_handler())


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    svc = ViewerService(args)
    t = threading.Thread(target=svc.run_render_loop, daemon=True)
    t.start()
    httpd = serve(svc, "0.0.0.0", args.port)
    print(f"viewer: http://localhost:{httpd.server_address[1]}/  (scene={args.scene})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        svc._stop = True
        t.join(timeout=30)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
