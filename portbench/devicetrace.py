"""Reduction of the traced window's profile to device and host intervals.

The traced run records the window with ``torch.profiler`` (CPU and CUDA
activities), exports the Chrome trace to a temporary file and reads it
back here: device activities (kernels, copies, sets) and host ones (ops
and the benchmark's own spans), in microseconds on one clock.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Tuple

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation"}

Interval = Tuple[str, float, float]


def profile_intervals(prof) -> Dict[str, List[Interval]]:
    """``{"device": [...], "host": [...]}`` of ``(name, start_us,
    end_us)`` from a stopped profiler."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    out = {"device": [], "host": []}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        side = ("device" if cat in DEVICE_CATS
                else "host" if cat in HOST_CATS else None)
        if side:
            t0 = float(e["ts"])
            out[side].append((e.get("name", "?"), t0,
                              t0 + float(e["dur"])))
    return out


def clip(intervals: List[Interval], lo: float, hi: float
         ) -> List[Interval]:
    return [(n, max(a, lo), min(b, hi)) for n, a, b in intervals
            if b > lo and a < hi]


def union(intervals: List[Interval]) -> List[Tuple[float, float]]:
    """The merged ``(start, end)`` spans the intervals cover."""
    spans: List[List[float]] = []
    for _n, a, b in sorted(intervals, key=lambda x: x[1]):
        if spans and a <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], b)
        else:
            spans.append([a, b])
    return [(a, b) for a, b in spans]


def busy_us(intervals: List[Interval]) -> float:
    return sum(b - a for a, b in union(intervals))


def top_ops(intervals: List[Interval], n: int = 10) -> List[list]:
    """The ``n`` device operations that took most time, in seconds."""
    total: Dict[str, float] = {}
    for name, a, b in intervals:
        total[name] = total.get(name, 0.0) + (b - a)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], us / 1e6] for name, us in ranked]


def idle_gaps(device: List[Interval], host: List[Interval], lo: float,
              hi: float, n: int = 10) -> List[list]:
    """The ``n`` longest spans of ``[lo, hi]`` in which no device
    operation ran, each named by the innermost host interval around its
    middle (``"host python"`` where none is)."""
    gaps, t = [], lo
    for a, b in union(device):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:n]:
        mid = (a + b) / 2
        around = [(e - s, name) for name, s, e in host if s <= mid <= e]
        label = min(around)[1] if around else "host python"
        out.append([label[:160], (b - a) / 1e6])
    return out
