"""The device's timeline over a traced run's measured window.

``torch.profiler`` (CUPTI) records kernels, copies and sets on the card and
the host's CUDA calls; the harness adds its own host spans around the
program's calls (``probe.py``), placed on the trace's clock by a marker
taken when the profiler starts. From the Chrome trace this reads the
union of the device's intervals (busy seconds), the window's span (window
seconds), the device operations that took most time, and the
device's idle gaps summed by what the host was doing in them: the
innermost host event or span open at the gap's middle, on any thread.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
              "python_function")
TOP = 10
_MARK = "rag_bench.clock"


class Profile:
    """The profiler over a whole measured window: started before the
    window's work begins and stopped after it has ended, from the thread
    that runs the window, so that no other thread launches work on the
    card while the profiler starts or stops."""

    def __init__(self):
        import torch

        self._prof = self._profiler()
        self._prof.__enter__()
        with torch.profiler.record_function(_MARK):
            self._mark_ns = time.perf_counter_ns()
        self._stop_ns = self._mark_ns

    @staticmethod
    def _profiler():
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        return torch.profiler.profile(activities=acts)

    @classmethod
    def warm_up(cls, device) -> None:
        """One short session in set-up: the profiler's first start takes
        seconds."""
        import torch

        with cls._profiler():
            torch.ones(1, device=device).add_(1)
            if device.type == "cuda":
                torch.cuda.synchronize(device)

    def stop(self) -> None:
        self._stop_ns = time.perf_counter_ns()
        self._prof.__exit__(None, None, None)

    def read(self, spans=()) -> dict | None:
        """``spans``: (start_ns, end_ns, name) on ``perf_counter_ns``."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self._prof = None
        mark = next((e for e in events if e.get("name") == _MARK and "ts" in e), None)
        if mark is None:
            return summarize(events)
        # the trace's clock is the marker's; the window runs from the
        # marker to the stop
        off = float(mark["ts"]) - self._mark_ns / 1e3
        lo, hi = self._mark_ns / 1e3 + off, self._stop_ns / 1e3 + off
        events = events + [
            {"ph": "X", "cat": "user_annotation", "name": name,
             "ts": a / 1e3 + off, "dur": (b - a) / 1e3} for a, b, name in spans]
        return summarize(events, lo, hi)


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(events: list[dict], lo: float | None = None,
              hi: float | None = None) -> dict | None:
    """busy_s, window_s, device_ops and idle_gaps from Chrome-trace
    events (timestamps in microseconds), each cut to [lo, hi] where
    given (else the events' own span); None where no device event is in
    the window."""
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if lo is not None:
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
        cat = e.get("cat", "")
        if cat in _DEVICE_CATS:
            dev.append((a, b, e.get("name", "?")))
        elif cat in _HOST_CATS:
            host.append((a, b, e.get("name", "?")))
    if not dev:
        return None
    if lo is None:
        lo = min(a for a, _, _ in dev + host)
        hi = max(b for _, b, _ in dev + host)
    busy = _union([(a, b) for a, b, _ in dev])
    by_op: dict[str, float] = defaultdict(float)
    for a, b, name in dev:
        by_op[name] += (b - a) * 1e-6
    # idle gaps, the window's edges included, named by the innermost host
    # event open at each gap's middle
    host.sort()
    starts = [a for a, _, _ in host]
    gaps: dict[str, float] = defaultdict(float)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for i in range(0, len(edges), 2):
        a, b = edges[i], edges[i + 1]
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        j = bisect.bisect_right(starts, mid)
        label = "host: outside every traced span"
        for k in range(j - 1, max(-1, j - 4096), -1):
            if host[k][1] >= mid:  # the latest start still open: innermost
                label = host[k][2]
                break
        gaps[label] += (b - a) * 1e-6
    rank = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "window_s": (hi - lo) * 1e-6,
        "device_ops": rank(by_op),
        "idle_gaps": rank(gaps),
    }
