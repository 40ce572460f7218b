"""Reduction of a ``torch.profiler`` trace of whole frames to the numbers the
per-layer metrics read.

Device activities are the trace's kernels, copies and sets; a kernel is
named by its function's own name, its template arguments, parameters,
return type and namespaces cut away (``void alpha_rounds_kernel<true,
16>(Args)`` is ``alpha_rounds_kernel``), and metrics match those names
whole. Host syncs are the CUDA runtime's stream, device and event
synchronize calls. The device's idle gaps are attributed to the host
operation that was running at each gap's middle (the innermost one).
"""

from __future__ import annotations

import bisect
import dataclasses
import re

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
TOP = 10


def kernel_base(name: str) -> str:
    """A device activity's name for matching: a kernel's function name alone;
    a copy or a set keeps its whole name."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    s = name.replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", s, maxsplit=1)[0].strip()
    return head.split(" ")[-1].split("::")[-1] or name


def union_intervals(spans):
    """The union of ``(start, end)`` intervals as a sorted list."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


@dataclasses.dataclass
class Trace:
    """What a traced stretch of ``frames`` whole frames gave."""

    frames: int
    window_s: float                 # host clock over the traced frames
    busy_s: float                   # union of the device activities
    launches: int                   # kernels, copies and sets
    host_syncs: int
    rays: int                       # the program's rays over the traced frames
    kernel_s: dict                  # base name -> device seconds
    kernel_n: dict                  # base name -> activities
    idle_by_host: dict              # host operation -> idle device seconds
    # The raw trace and the program's readings, for readers of spans and
    # counters: (name, start us, end us) of every host operation (the
    # program's ``record_function`` spans among them) and device activity;
    # reader name -> what its ``snapshot(renderer)`` read as the trace
    # started and as it ended.
    host_events: list = dataclasses.field(default_factory=list)
    device_events: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)

    def per_frame(self, x: float) -> float:
        return x / self.frames

    def kernel_ms_per_frame(self, names):
        """Device ms a frame of the kernels ``names`` (matched whole), or
        None where none of them ran."""
        if not any(self.kernel_n.get(k, 0) for k in names):
            return None
        return 1e3 * sum(self.kernel_s.get(k, 0.0) for k in names) / self.frames

    def breakdown(self) -> dict:
        """The ``breakdown`` of the result line: the device operations that
        took most time and the longest idle gaps by host operation."""
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


def reduce(prof, frames: int, window_s: float, rays: int, counters=None) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile``;
    ``counters``: the readers' snapshots, kept as given."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host, syncs = [], [], 0
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if not getattr(e, "is_user_annotation", False):
                dev.append((e.name, start, end))
        else:
            host.append((start, end, e.name))
            syncs += e.name in SYNCS
    kernel_s, kernel_n = {}, {}
    for name, s, e in dev:
        k = kernel_base(name)
        kernel_s[k] = kernel_s.get(k, 0.0) + (e - s) * 1e-6
        kernel_n[k] = kernel_n.get(k, 0) + 1
    busy = union_intervals([(s, e) for _, s, e in dev])
    busy_s = sum(e - s for s, e in busy) * 1e-6
    return Trace(frames, window_s, busy_s, len(dev), syncs, rays, kernel_s, kernel_n,
                 _idle_by_host(busy, host), [(n, s, e) for s, e, n in host], dev,
                 dict(counters or {}))


def _idle_by_host(busy, host, scan: int = 4096) -> dict:
    """Each gap between the device's busy intervals, in seconds, summed by
    the innermost host operation running at its middle."""
    host = sorted(host)
    starts = [h[0] for h in host]
    out = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        name = "(host between operations)"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - scan, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        out[name] = out.get(name, 0.0) + (s1 - e0) * 1e-6
    return out
