"""The benchmark's files: BENCHMARK.json against the contract's limits, the
readers against it, and a new scene, mix and metric picked up by name."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from rtbench import bench
from rtbench import trace as tr

ROOT = bench.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_keys_names_and_units():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["rtbench"] and b["command"][1].startswith("rtbench/")
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith("rtbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    configs = {c["name"] for c in b["configs"]}
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert configs == {w["config"] for w in b["workloads"]}
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}


def test_every_cell_reports_what_its_metrics_move():
    b = _bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for w in b["workloads"]:
        reports = {m["name"] for m in b["end_to_end"] if bench._covers(m, w["name"])}
        layers = [m for m in b["per_layer"] if bench._covers(m, w["name"])]
        assert "setup_s" in reports and len(reports) >= 2 and layers
        for m in layers:
            assert m["moves"] in e2e and m["moves"] in reports, (w["name"], m["name"])


def test_readers_agree_with_the_benchmark():
    b = _bench()
    for m in b["per_layer"]:
        r = bench.load_reader("metrics", m["name"])
        assert (r.NAME, r.UNIT, r.LAYER, r.SOURCE, r.MOVES) == (
            m["name"], m["unit"], m["layer"], m["source"], m["moves"])
    for m in b["end_to_end"]:
        r = bench.load_reader("endtoend", m["name"])
        assert (r.NAME, r.UNIT) == (m["name"], m["unit"])
    for w in b["workloads"]:
        cell = bench.load_cell(w["name"])
        assert cell.check["limits"] and cell.traffic["name"] == w["traffic"]
        assert cell.config["name"] == w["config"]


def _synthetic_trace():
    return tr.Trace(frames=4, window_s=0.2, busy_s=0.05, launches=1480, host_syncs=76,
                    rays=16_000_000,
                    kernel_s={"persistent_traverse_kernel": 0.0128, "alpha_rounds_kernel": 0.0042,
                              "shade_stage_kernel": 0.0057, "regenerate_kernel": 0.0012,
                              "retire_kernel": 0.0006, "Memset (Device)": 0.0001},
                    kernel_n={"persistent_traverse_kernel": 104, "alpha_rounds_kernel": 104,
                              "shade_stage_kernel": 52, "regenerate_kernel": 52,
                              "retire_kernel": 52, "Memset (Device)": 8},
                    idle_by_host={"cudaEventSynchronize": 0.01, "aten::nonzero": 0.02})


@pytest.mark.parametrize("name,want", [
    ("device_idle_pct", 75.0), ("launches_per_frame", 370.0), ("host_syncs_per_frame", 19.0),
    ("ab_ms_per_frame", 3.2), ("alpha_rounds_ms_per_frame", 1.05),
    ("opaque_machine_ms_per_frame", None), ("alpha_machine_ms_per_frame", None),
    ("shade_ms_per_frame", 1.425), ("pool_ms_per_frame", 0.45), ("rays_per_frame", 4.0),
    ("device_idle_pct.host_bound", 75.0), ("launches_per_frame.host_bound", 370.0),
    ("host_syncs_per_frame.host_bound", 19.0), ("shade_ms_per_frame.host_bound", 1.425),
    ("pool_ms_per_frame.host_bound", 0.45), ("rays_per_frame.host_bound", 4.0),
])
def test_metric_readers_on_a_synthetic_trace(name, want):
    got = bench.load_reader("metrics", name).read(_synthetic_trace())
    assert (got is None) if want is None else got == pytest.approx(want, rel=1e-12)


def test_breakdown_orders_and_caps():
    t = _synthetic_trace()
    t.kernel_s.update({f"k{i}": 1e-4 * i for i in range(12)})
    b = t.breakdown()
    assert len(b["device_ops"]) == 10 and b["device_ops"][0] == ["persistent_traverse_kernel", 0.0128]
    assert b["idle_gaps"] == [["aten::nonzero", 0.02], ["cudaEventSynchronize", 0.01]]


@pytest.mark.parametrize("name,base", [
    ("void persistent_traverse_kernel<0, true, 16>(TraverseArgs)", "persistent_traverse_kernel"),
    ("void capped_traverse_kernel<16, false, true>(CappedArgs)", "capped_traverse_kernel"),
    ("void round_traverse_kernel<2, true, 16, false>(RoundArgs)", "round_traverse_kernel"),
    ("regenerate_kernel(RegenArgs)", "regenerate_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::"
     "foo, at::detail::Array<char*, 2> >(int, bar)", "vectorized_elementwise_kernel"),
    ("Memcpy DtoH (Device -> Pinned)", "Memcpy DtoH (Device -> Pinned)"),
])
def test_kernel_names_match_whole(name, base):
    assert tr.kernel_base(name) == base


class _Ev:
    def __init__(self, name, start, end, cuda, annotation=False):
        import torch

        self.name = name
        self.time_range = type("R", (), {"start": start, "end": end})()
        self.device_type = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
        self.is_user_annotation = annotation


def test_reduce_a_profile():
    events = [
        _Ev("void shade_stage_kernel<false>(StageArgs)", 100, 300, True),
        _Ev("void persistent_traverse_kernel<0, true, 16>(Args)", 250, 400, True),
        _Ev("shade_stage", 90, 420, True, annotation=True),
        _Ev("regenerate_kernel(RegenArgs)", 1000, 1100, True),
        _Ev("aten::nonzero", 380, 900, False),
        _Ev("cudaStreamSynchronize", 600, 850, False),
        _Ev("cudaEventSynchronize", 950, 1150, False),
    ]
    prof = type("P", (), {"events": lambda self: events})()
    t = tr.reduce(prof, frames=2, window_s=0.002, rays=10)
    assert t.launches == 3 and t.host_syncs == 2
    assert t.busy_s == pytest.approx(400e-6)
    assert t.kernel_s["shade_stage_kernel"] == pytest.approx(200e-6)
    assert t.idle_by_host == {"cudaStreamSynchronize": pytest.approx(600e-6)}
    assert bench.load_reader("metrics", "device_idle_pct").read(t) == pytest.approx(80.0)


NEW_METRIC = '''NAME = "frames_per_frame"
UNIT = "frames/frame"
LAYER = "integrator"
SOURCE = "program_counter"
MOVES = "msamples_per_s.host_bound"
KERNELS = ("Memset (Device)",)


def snapshot(renderer):
    return renderer.frame


def read(trace):
    before, after = trace.counters[NAME]
    return (after - before) / trace.frames
'''

# Run in the copy: its rtbench (with the new generator module) first on the
# path, the port from this checkout.
IN_COPY = """
import json, sys
from rtbench import bench
cell = bench.load_cell("tiny_hall.tiny")
out = bench.run_cell(cell, 12345, 0.5, False, "cpu", 0.0, log=lambda *a, **k: None)
print(json.dumps([bench.ROOT, cell.per_layer, sorted(bench.claimed_kernels()), out]))
"""


def test_new_scene_mix_and_metric_picked_up_by_name(tmp_path):
    """A copy of the benchmark with a new scene generator, configuration,
    traffic mix, cell and per-layer metric added as files and entries, no
    file edited: a run of the new cell in the copy finds them all."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "rtbench"), root / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    rt = root / "rtbench"
    (rt / "scenes" / "tiny_hall.py").write_text(
        "from .procedural import atrium_scene\n\n\ndef tiny_hall():\n"
        "    return atrium_scene(bays_x=2, bays_z=2, column_segments=8, column_rows=12)\n")
    (rt / "configs" / "tiny_hall.json").write_text(json.dumps(dict(
        bench._json(os.path.join(ROOT, "rtbench", "configs", "atrium.json")), name="tiny_hall",
        scene={"generator": "tiny_hall.tiny_hall"})))
    (rt / "traffic" / "tiny.json").write_text(json.dumps(dict(
        bench._json(os.path.join(ROOT, "rtbench", "traffic", "accumulate-1080p-d4.json")),
        name="tiny", width=32, height=18)))
    (rt / "checks" / "tiny_hall.tiny.json").write_text(
        json.dumps({"pixels": 8, "limits": {"image_gap": 1e-3}}))
    (rt / "metrics" / "frames_per_frame.py").write_text(NEW_METRIC)
    b = _bench()
    b["configs"].append(dict(b["configs"][0], name="tiny_hall",
                             file="rtbench/configs/tiny_hall.json"))
    b["workloads"].append({"name": "tiny_hall.tiny", "config": "tiny_hall", "traffic": "tiny",
                           "chips": 1, "why": "a test cell"})
    b["per_layer"].append(dict(b["per_layer"][0], name="frames_per_frame", unit="frames/frame",
                               source="program_counter", moves="msamples_per_s.host_bound",
                               workloads=["tiny_hall.tiny"]))
    for m in b["end_to_end"]:
        if m["name"] == "msamples_per_s.host_bound":
            m["workloads"].append("tiny_hall.tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), ROOT]))
    p = subprocess.run([sys.executable, "-c", IN_COPY], capture_output=True, text=True,
                       cwd=str(root), env=env, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    where, per_layer, claimed, out = json.loads(p.stdout.strip().splitlines()[-1])
    assert where == str(root) and "frames_per_frame" in per_layer
    assert "Memset (Device)" in claimed
    assert out["correct"] and set(out["metrics"]) == {"setup_s", "msamples_per_s.host_bound",
                                                      "peak_mib"}


def test_a_reader_of_counters_and_spans():
    """A per-layer reader's ``snapshot`` is read as the trace starts and
    ends, and the program's spans reach the readers in the trace."""
    import torch

    class Renderer:
        frame, last_rays = 7, 100

        def step(self):
            with torch.profiler.record_function("frame_span"):
                self.frame += 1

    m = {}
    exec(compile(NEW_METRIC, "frames_per_frame.py", "exec"), m)
    r = Renderer()
    frame_s, _, _, traced = bench.run_window(r, 0.3, "cpu", 0.1, {m["NAME"]: m["snapshot"]})
    t = tr.reduce(*traced)
    assert t.frames >= 1 and t.counters[m["NAME"]][1] == r.frame == 7 + len(frame_s)
    assert m["read"](t) == 1.0
    assert sum(name == "frame_span" for name, _, _ in t.host_events) == t.frames
