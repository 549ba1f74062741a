"""The reduction of a traced window to the program's spans
(``spantrace.py``) on hand-built Chrome traces, and
``tools/sweep_spans.py`` over every cell on the CPU at a tiny size."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import bench, spantrace

ROOT = Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
MAIN, OTHER = 11, 12


def _x(cat, name, ts, dur, tid=MAIN, **args):
    e = {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
         "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


def _trace():
    """A call ``[0, 100]`` us on the main thread: a serve, a finalize that
    launches two operations, a report and a pool; another thread
    launches one operation outside every span.  The kernels' names are
    the wrong way round on purpose: names are not matched."""
    return [
        _x("user_annotation", "portbench.call", 0, 100),
        _x("user_annotation", "sweep.run", 1, 98),
        _x("user_annotation", "sweep.serve", 2, 8),
        _x("user_annotation", "sweep.finalize", 20, 20),
        _x("user_annotation", "sweep.report", 40, 5),
        _x("user_annotation", "sweep.pool", 50, 40),
        _x("cpu_op", "aten::copy_", 24, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 5, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 25, 1, correlation=2),
        _x("cuda_runtime", "cudaMemcpyAsync", 30, 1, correlation=3),
        _x("cuda_driver", "cuLaunchKernel", 60, 1, tid=OTHER,
           correlation=4),
        _x("kernel", "_scatter_gather_elementwise_kernel", 6, 24, tid=7,
           correlation=1),
        _x("kernel", "serve_records_kernel", 31, 2, tid=7, correlation=2),
        _x("gpu_memcpy", "Memcpy DtoH", 33, 2, tid=7, correlation=3),
        _x("kernel", "other", 70, 1, tid=7, correlation=4),
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 1, "ts": 5},
    ]


def test_each_device_operation_goes_to_the_span_that_launched_it():
    events = _trace()
    by_span = spantrace.device_by_span(
        spantrace.device_ops(events), spantrace.launches(events),
        spantrace.host_spans(events))
    assert by_span == {
        "sweep.serve": {"_scatter_gather_elementwise_kernel": 24.0},
        "sweep.finalize": {"serve_records_kernel": 2.0,
                           "Memcpy DtoH": 2.0},
        spantrace.NONE: {"other": 1.0}}


def test_idle_time_goes_to_its_innermost_span_once():
    events = _trace()
    gaps = spantrace.idle_gaps(spantrace.device_ops(events), 0.0, 100.0)
    assert gaps == [(0.0, 6.0), (30.0, 31.0), (35.0, 70.0), (71.0, 100.0)]
    idle = spantrace.idle_by_span(gaps, spantrace.host_spans(events))
    assert idle == {spantrace.NONE: 2.0, "sweep.run": 1.0 + 5.0 + 9.0,
                    "sweep.serve": 4.0, "sweep.finalize": 1.0 + 5.0,
                    "sweep.report": 5.0, "sweep.pool": 20.0 + 19.0}
    assert sum(idle.values()) == sum(b - a for a, b in gaps)
    assert spantrace.covered(gaps, [(0.0, 50.0), (40.0, 80.0)]) == \
        6.0 + 1.0 + 35.0 + 9.0
    assert spantrace.host_ops_within(events, "sweep.finalize") == \
        {"aten::copy_": 10.0}
    assert spantrace.host_ops_within(events, "sweep.serve") == {}


def test_window_summary_per_point():
    s = spantrace.window_summary(_trace(), 0.0, 100.0, 2, [(0.0, 100.0)])
    assert s["idle_us"] == s["idle_us_in_calls"] == 71.0
    assert s["finalize_idle_ms_per_point"] == pytest.approx(11.0 / 1e3 / 2)
    assert s["sweep_idle_ms_per_point"] == pytest.approx(58.0 / 1e3 / 2)
    assert s["finalize_device_ms_per_point"] == pytest.approx(4.0 / 1e3 / 2)
    assert s["program_idle_share_of_calls"] == pytest.approx(69.0 / 71.0)
    assert s["finalize_ops_us"] == {"serve_records_kernel": 2.0,
                                    "Memcpy DtoH": 2.0}


def test_cold_split_by_span_and_thread():
    from repro_torch.spans import SpanRecord
    ms = 1_000_000
    recs = [SpanRecord("sweep.run", 0, None, MAIN, 0, 100 * ms),
            SpanRecord("sweep.pool", 0, 0, MAIN, 1 * ms, 60 * ms),
            SpanRecord("sweep.prepare", 0, 0, OTHER, 2 * ms, 58 * ms),
            SpanRecord("session.model", 0, 2, OTHER, 3 * ms, 43 * ms),
            SpanRecord("sweep.serve", 0, 0, MAIN, 61 * ms, 90 * ms)]
    split = spantrace.cold_split(recs)
    assert split["run_s"] == pytest.approx(0.1)
    assert split["total_s"]["session.model"] == pytest.approx(0.04)
    assert split["self_s"] == pytest.approx({
        "sweep.run@main": 0.1 - 0.059 - 0.029,
        "sweep.pool@main": 0.059, "sweep.prepare@worker": 0.016,
        "session.model@worker": 0.04, "sweep.serve@main": 0.029})


@pytest.mark.parametrize("workload", CELLS)
def test_the_span_tool_runs_each_cell_on_the_cpu(tiny_root, workload):
    out = subprocess.run(
        [sys.executable, "tools/sweep_spans.py", "--workload", workload,
         "--seed", "3000000001", "--seconds", "0.3", "--ab", "1",
         "--device", "cpu", "--root", str(tiny_root)], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    cold, window = line["cold"], line["window"]
    assert {"session.algorithm", "session.model", "session.program",
            "sweep.prepare"} <= set(cold["total_s"])
    assert cold["run_s"] <= cold["cold_call_s"]
    # a wait a point (the finalize's copy) and a wait a serve (its check)
    traffic = bench.load_cell(workload, tiny_root).traffic
    serves = 1 / len(traffic["grid"]) if traffic["batch_memories"] else 1
    assert window["host_waits_per_point"] == pytest.approx(1 + serves)
    assert window["points"] > 0 and window["program_idle_share_of_calls"] \
        >= 0.95
    assert len(line["ab"]) == 1 and min(line["ab"][0]) > 0
