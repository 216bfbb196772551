"""Host spans and the device trace of a run's measured window.

:class:`Spans` keeps the benchmark's own host-clock spans (name, start,
end) in memory; with tracing on each span is also a ``record_function``
range, so it appears in the profiler's trace beside the device records.

:class:`DeviceTrace` runs ``torch.profiler`` (CPU and CUDA activities)
over the window, after one warm-up cycle (a cold start loses the first
device records), writes the Chrome trace under ``TMPDIR``, reads it back
and deletes it. From the records it keeps the device operations
(kernels, copies, memsets) inside the window span, the union of their
intervals (``busy_s``), the idle gaps between them labelled by the
innermost host range open at the gap's middle, and the time by operation
name.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

WINDOW_SPAN = "vio_bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "python_function")


class Spans:
    """Host-clock spans by name: ``with spans("engine_step"): ...``."""

    def __init__(self, annotate: bool = False):
        self.annotate = annotate
        self.by_name: Dict[str, List[Tuple[float, float]]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        ctx = (torch.profiler.record_function(f"vio_bench.{name}") if self.annotate
               else contextlib.nullcontext())
        with ctx:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.by_name[name].append((t0, time.perf_counter()))

    def durations(self, name: str) -> List[float]:
        return [b - a for a, b in self.by_name.get(name, [])]


class DeviceTrace:
    """``start()`` before the warm-up cycle, ``step()`` after it, the window
    under ``window()``, then ``stop()`` returns the :class:`TraceSummary`."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile, schedule

        self.cuda = device.type == "cuda"
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=activities,
                            schedule=schedule(wait=0, warmup=1, active=1, repeat=1))

    def start(self):
        self.prof.start()

    def step(self):
        self.prof.step()

    def window(self):
        return torch.profiler.record_function(WINDOW_SPAN)

    def stop(self) -> "TraceSummary":
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="vio_bench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return TraceSummary(events)


class TraceSummary:
    def __init__(self, events: list):
        spans = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW_SPAN]
        if not spans:
            raise RuntimeError("the trace holds no window span")
        tid = spans[0].get("tid")
        w0 = float(spans[0]["ts"])
        w1 = w0 + float(spans[0]["dur"])
        self.window_s = (w1 - w0) / 1e6
        dev, host = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = float(e["ts"])
            b = a + float(e["dur"])
            if b <= w0 or a >= w1:
                continue
            if e.get("cat") in DEVICE_CATS:
                dev.append((max(a, w0), min(b, w1), e["name"], e["cat"]))
            elif (e.get("cat") in HOST_CATS and e.get("tid") == tid
                  and e["name"] != WINDOW_SPAN):
                host.append((a, b, e["name"]))
        dev.sort()
        self.device = dev
        merged: List[List[float]] = []
        for a, b, _, _ in dev:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) / 1e6
        edges = [w0] + [x for ab in merged for x in ab] + [w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        self.gaps_by_host = _label_gaps(gaps, host)

    def device_time_s(self, contains: str = "", cat: Optional[str] = None) -> float:
        """Device seconds of the operations whose name holds ``contains``
        (and whose category is ``cat``, where given)."""
        return sum(b - a for a, b, n, c in self.device
                   if contains in n and (cat is None or c == cat)) / 1e6

    def count(self, contains: str) -> int:
        return sum(1 for _, _, n, _ in self.device if contains in n)

    def breakdown(self, top: int = 10) -> dict:
        ops = defaultdict(float)
        for a, b, n, _ in self.device:
            ops[n[:120]] += (b - a) / 1e6
        return {"device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda kv: -kv[1])[:top],
                "idle_gaps": sorted(([k, v] for k, v in self.gaps_by_host.items()),
                                    key=lambda kv: -kv[1])[:top]}


def _label_gaps(gaps, host) -> Dict[str, float]:
    """Seconds of idle device time by the innermost host range of the
    window's thread open at each gap's middle (ranges of one thread nest:
    a sweep with a stack of open ranges finds it)."""
    host.sort(key=lambda h: (h[0], -h[1]))
    out = defaultdict(float)
    stack: List[Tuple[float, str]] = []
    i = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][0] < host[i][0]:
                stack.pop()
            stack.append((host[i][1], host[i][2]))
            i += 1
        while stack and stack[-1][0] < mid:
            stack.pop()
        label = stack[-1][1][:120] if stack else "host: outside any range"
        out[label] += (b - a) / 1e6
    return out
