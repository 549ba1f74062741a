"""The program's spans in a traced window: which span launched each
device operation, and which span the device's idle time lies in.

The program (``repro_torch.spans``) opens ``torch.profiler.record_function``
spans named ``sweep.*``, ``session.*`` and ``graph.*`` at its layer
boundaries; in the profiler's Chrome trace they are ``user_annotation``
events on their host thread.  A device operation (``kernel``, ``gpu_memcpy``, ``gpu_memset``)
carries the ``correlation`` of the runtime call that launched it
(``cuda_runtime`` or ``cuda_driver``), which lies on the launching host
thread at its host time: the innermost program span on that thread around
that time launched the operation.  Kernel names are not matched.  Times
are microseconds on the trace's one clock.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

PROGRAM_PREFIXES = ("sweep.", "session.", "graph.")
#: the spans of the "finalize, reports" layer; every other program span
#: belongs to the sweep engine or below it
FINALIZE = ("sweep.finalize", "sweep.report")
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
#: the key of time that lies in no program span
NONE = "(no program span)"


class HostSpan(NamedTuple):
    name: str
    thread: Tuple[object, object]   # (pid, tid) of the host thread
    start: float
    end: float


class DeviceOp(NamedTuple):
    name: str
    start: float
    end: float
    correlation: Optional[int]


def read_events(prof) -> List[dict]:
    """The events of a stopped ``torch.profiler.profile``."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    return events.get("traceEvents", []) if isinstance(events, dict) \
        else events


def _complete(events: Iterable[dict], cats) -> Iterable[dict]:
    for e in events:
        if e.get("ph") == "X" and "dur" in e and e.get("cat") in cats:
            yield e


def _interval(e: dict) -> Tuple[float, float]:
    t0 = float(e["ts"])
    return t0, t0 + float(e["dur"])


def host_spans(events: Iterable[dict],
               prefixes=PROGRAM_PREFIXES) -> List[HostSpan]:
    """The ``user_annotation`` spans whose names start with ``prefixes``
    (the program's by default)."""
    return [HostSpan(e["name"], (e.get("pid"), e.get("tid")),
                     *_interval(e))
            for e in _complete(events, {"user_annotation"})
            if e["name"].startswith(prefixes)]


def device_ops(events: Iterable[dict]) -> List[DeviceOp]:
    return [DeviceOp(e.get("name", "?"), *_interval(e),
                     (e.get("args") or {}).get("correlation"))
            for e in _complete(events, DEVICE_CATS)]


def launches(events: Iterable[dict]) -> Dict[int, Tuple[tuple, float]]:
    """``correlation -> (host thread, host time)`` of each runtime call."""
    out = {}
    for e in _complete(events, LAUNCH_CATS):
        c = (e.get("args") or {}).get("correlation")
        if c is not None:
            out[c] = ((e.get("pid"), e.get("tid")), float(e["ts"]))
    return out


def clip_ops(ops: List[DeviceOp], lo: float, hi: float) -> List[DeviceOp]:
    return [o._replace(start=max(o.start, lo), end=min(o.end, hi))
            for o in ops if o.end > lo and o.start < hi]


def idle_gaps(ops: List[DeviceOp], lo: float, hi: float
              ) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` in which no device operation ran."""
    gaps, t = [], lo
    for o in sorted(ops, key=lambda o: o.start):
        if o.start > t:
            gaps.append((t, min(o.start, hi)))
        t = max(t, o.end)
    if hi > t:
        gaps.append((t, hi))
    return [(a, b) for a, b in gaps if b > a]


def _by_start(spans: List[HostSpan]):
    spans = sorted(spans, key=lambda s: s.start)
    return spans, [s.start for s in spans]


def idle_by_span(gaps: List[Tuple[float, float]],
                 spans: List[HostSpan]) -> Dict[str, float]:
    """Idle microseconds by the innermost (shortest) span around them, on
    any thread; each stretch counts once, under ``NONE`` where no span
    is."""
    spans, starts = _by_start(spans)
    out: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        over = [s for s in spans[:bisect.bisect_left(starts, b)]
                if s.end > a]
        cuts = sorted({a, b, *(t for s in over for t in (s.start, s.end)
                               if a < t < b)})
        for x, y in zip(cuts, cuts[1:]):
            around = [s for s in over if s.start <= x and s.end >= y]
            name = (min(around, key=lambda s: s.end - s.start).name
                    if around else NONE)
            out[name] += y - x
    return dict(out)


def covered(gaps: List[Tuple[float, float]],
            intervals: List[Tuple[float, float]]) -> float:
    """Idle microseconds that lie inside the union of ``intervals``."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(max(0.0, min(b, d) - max(a, c))
               for a, b in gaps for c, d in merged)


def device_by_span(ops: List[DeviceOp],
                   launched: Dict[int, Tuple[tuple, float]],
                   spans: List[HostSpan]) -> Dict[str, Dict[str, float]]:
    """``span name -> {device op name: microseconds}`` of the operations
    launched inside each span (the innermost program span on the
    launching thread); an operation with no launch in the trace, or
    launched outside every span, under ``NONE``."""
    per_thread: Dict[tuple, List[HostSpan]] = defaultdict(list)
    for s in spans:
        per_thread[s.thread].append(s)
    index = {t: _by_start(v) for t, v in per_thread.items()}
    out: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
    for o in ops:
        name = NONE
        if o.correlation in launched:
            thread, ts = launched[o.correlation]
            ss, starts = index.get(thread, ([], []))
            # spans on one thread nest: the latest-starting one that is
            # still open at ``ts`` is the innermost
            for s in reversed(ss[:bisect.bisect_right(starts, ts)]):
                if s.end >= ts:
                    name = s.name
                    break
        out[name][o.name] += o.end - o.start
    return {k: dict(v) for k, v in out.items()}


def host_ops_within(events: List[dict], name: str, top: int = 8
                    ) -> Dict[str, float]:
    """Host microseconds of the outermost ``cpu_op`` events inside the
    spans called ``name``, on the span's thread, by op name (the ``top``
    largest)."""
    per_thread: Dict[tuple, List[HostSpan]] = defaultdict(list)
    for s in host_spans(events, (name,)):
        if s.name == name:
            per_thread[s.thread].append(s)
    ops = sorted((HostSpan(e["name"], (e.get("pid"), e.get("tid")),
                           *_interval(e))
                  for e in _complete(events, {"cpu_op"})),
                 key=lambda o: o.start)
    out: Dict[str, float] = defaultdict(float)
    end: Dict[tuple, float] = defaultdict(lambda: float("-inf"))
    for o in ops:
        if o.start < end[o.thread]:
            continue          # inside an outer op on the same thread
        end[o.thread] = o.end
        if any(s.start <= o.start and o.end <= s.end
               for s in per_thread.get(o.thread, ())):
            out[o.name] += o.end - o.start
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:top])


def window_summary(events: List[dict], lo: float, hi: float, points: int,
                   calls: List[Tuple[float, float]]) -> dict:
    """The window ``[lo, hi]``'s device idle time by program span, the
    device time each span launched, and the per-point figures;
    ``calls`` are the host intervals of the window's calls.
    ``finalize_names_us`` is the window's device time of every operation
    named as one that ``sweep.finalize`` launched, launched anywhere: the
    check by name of ``finalize_device_ms_per_point``."""
    spans = [s for s in host_spans(events) if s.end > lo and s.start < hi]
    ops = clip_ops(device_ops(events), lo, hi)
    by_span = device_by_span(ops, launches(events), spans)
    gaps = idle_gaps(ops, lo, hi)
    idle = idle_by_span(gaps, spans)
    in_calls = covered(gaps, calls)
    in_program = sum(v for k, v in idle.items() if k != NONE)
    fin_idle = sum(idle.get(k, 0.0) for k in FINALIZE)
    device_us = {k: sum(v.values()) for k, v in by_span.items()}
    fin_ops = by_span.get("sweep.finalize", {})
    return {
        "points": points, "window_us": hi - lo,
        "idle_us": sum(b - a for a, b in gaps),
        "idle_us_in_calls": in_calls,
        "idle_us_by_span": idle,
        "program_idle_share_of_calls": (in_program / in_calls
                                        if in_calls else None),
        "device_us_by_span": device_us,
        "finalize_ops_us": fin_ops,
        "finalize_names_us": sum(o.end - o.start for o in ops
                                 if o.name in fin_ops),
        "finalize_idle_ms_per_point": fin_idle / 1e3 / points,
        "sweep_idle_ms_per_point": (in_program - fin_idle) / 1e3 / points,
        "finalize_device_ms_per_point": (device_us.get("sweep.finalize",
                                                       0.0) / 1e3 / points),
    }


def cold_split(records) -> dict:
    """The recorder's spans of one call (``repro_torch.spans.SpanRecord``
    values): seconds by span name (``total``), and self seconds (less the
    children on the same thread) by span and by thread, ``main`` being
    the thread of the first ``sweep.run``."""
    records = list(records)
    runs = [r for r in records if r.name == "sweep.run"]
    main = runs[0].thread if runs else None
    child = defaultdict(int)
    for r in records:
        if r.parent is not None and records[r.parent].thread == r.thread:
            child[r.parent] += r.end_ns - r.start_ns
    total: Dict[str, float] = defaultdict(float)
    own: Dict[str, float] = defaultdict(float)
    for i, r in enumerate(records):
        total[r.name] += (r.end_ns - r.start_ns) / 1e9
        role = "main" if r.thread == main else "worker"
        own[f"{r.name}@{role}"] += (r.end_ns - r.start_ns - child[i]) / 1e9
    return {"total_s": dict(total), "self_s": dict(own),
            "run_s": sum((r.end_ns - r.start_ns) / 1e9 for r in runs)}
