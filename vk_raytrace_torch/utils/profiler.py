"""Profiling utilities (counterpart of the reference's ``utils/profiler.py``).

* :class:`Profiler`: named wall-clock scopes with count, mean, min, max and
  total; the caller synchronises the device inside a scope whose time
  should include its work.
* :func:`device_memory_stats`: per-card memory use from
  ``torch.cuda.memory_stats``, with the reference's keys.
* :func:`trace`: a ``torch.profiler`` trace of the CPU and the card, written
  for TensorBoard / Perfetto.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class Profiler:
    """Named wall-clock scopes with aggregation::

        prof = Profiler()
        with prof.scope("frame"):
            r.step()
            torch.cuda.synchronize()
        print(prof.report())
    """

    def __init__(self) -> None:
        self._times: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def scope(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._times[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self._times[name].append(seconds)

    def samples(self, name: str) -> list[float]:
        """Every recorded duration of ``name``, in seconds."""
        return list(self._times.get(name, []))

    def stats(self, name: str):
        v = self._times.get(name, [])
        if not v:
            return None
        return {
            "count": len(v),
            "mean_ms": 1e3 * sum(v) / len(v),
            "min_ms": 1e3 * min(v),
            "max_ms": 1e3 * max(v),
            "total_s": sum(v),
        }

    def report(self) -> str:
        lines = []
        for name in sorted(self._times):
            s = self.stats(name)
            lines.append(
                f"{name:>16}: {s['mean_ms']:8.2f} ms avg "
                f"({s['min_ms']:.2f}..{s['max_ms']:.2f}, n={s['count']})"
            )
        return "\n".join(lines)

    def reset(self) -> None:
        self._times.clear()


def device_memory_stats():
    """Memory use of each visible card (an empty list without one): bytes
    in use, the card's total, and the peak in use, from the caching
    allocator's statistics."""
    out = []
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out.append(
            {
                "device": f"cuda:{i}",
                "bytes_in_use": s.get("allocated_bytes.all.current", -1),
                "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
                "peak_bytes_in_use": s.get("allocated_bytes.all.peak", -1),
            }
        )
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the CPU and (where there is one) the
    card over the scope, written to ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir
