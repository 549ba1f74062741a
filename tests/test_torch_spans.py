"""The port's spans (``repro_torch.spans``) and its host-wait counter
(``repro_torch.device``), on the CPU.

The off path is one shared null context; the recorder links parents
across ``Sweeper.run``'s worker threads under one run id; a CPU
``torch.profiler`` sees the same spans as ``user_annotation`` events; a
tiny HitGraph and AccuGraph ``Sweeper.run``, batched and per case, opens
the spans of every layer boundary and waits on the card once a case (the
finalize's copy) and once a serve (the serve's input check).
"""

import json
import os
import sys
import threading

import pytest
import torch

from repro_torch import device as device_mod
from repro_torch import spans
from repro_torch.analysis import locks
from repro_torch.core import vectorized as vec
from repro_torch.graphs.generators import rmat
from repro_torch.sim import SweepCase, Sweeper, timing_variants

CPU = "cpu"
BASES = {"hitgraph": "ddr3", "accugraph": "ddr4-8gb"}
#: the spans a cold run of the static sweep path opens, on a miss
COLD = {"sweep.run", "sweep.pool", "sweep.prepare", "session.algorithm",
        "session.model", "session.program", "sweep.serve",
        "sweep.finalize", "sweep.report"}
WARM = COLD - {"session.algorithm", "session.model", "session.program"}


@pytest.fixture(scope="module")
def graph():
    g = rmat(7, 4, seed=3).undirected_view()
    g.fingerprint       # hashed once a graph: before any test records
    return g


def _cases(graph, accelerator):
    mems = timing_variants(BASES[accelerator], kinds=("ddr3", "ddr4"))
    return [SweepCase(graph=graph, problem="wcc", accelerator=accelerator,
                      memory=m) for m in mems]


def _by_index(recs):
    return dict(enumerate(recs))


def _ancestors(recs, i):
    out = []
    while recs[i].parent is not None:
        i = recs[i].parent
        out.append(recs[i].name)
    return out


def test_off_path_is_the_shared_null_context_and_records_nothing():
    assert not torch.autograd._profiler_enabled()
    a, b = spans.span("sweep.run"), spans.span("sweep.finalize")
    assert a is b and a is spans._NULL
    with a as s:
        assert s is None
    assert spans.adopt(None) is spans._NULL
    with spans.span("sweep.prepare", timed=True) as s:
        pass
    assert s.index is None and s.seconds >= 0.0
    with spans.recording() as rec:
        pass
    assert rec.spans() == []


def test_nesting_parents_and_one_run_id_across_threads():
    with spans.recording() as rec:
        with spans.span("sweep.run") as run:
            with spans.span("sweep.pool"):
                def work():
                    with spans.adopt(run), spans.span("sweep.prepare"):
                        with spans.span("session.model"):
                            pass
                t = threading.Thread(target=work)
                t.start()
                t.join()
            with spans.span("sweep.finalize"):
                pass
        with spans.span("sweep.run"):
            pass
    recs = rec.spans()
    names = [r.name for r in recs]
    assert names == ["sweep.run", "sweep.pool", "sweep.prepare",
                     "session.model", "sweep.finalize", "sweep.run"]
    assert [r.parent for r in recs] == [None, 0, 0, 2, 0, None]
    assert len({r.run for r in recs[:5]}) == 1
    assert recs[5].run != recs[0].run
    assert recs[2].thread == recs[3].thread != recs[0].thread
    for r in recs:
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns


def test_a_graph_is_hashed_once_under_its_own_span():
    g = rmat(5, 2, seed=1)
    with spans.recording() as rec:
        first = g.fingerprint
        assert g.fingerprint == first
    assert [r.name for r in rec.spans()] == ["graph.fingerprint"]


def test_recorder_is_bounded_and_one_at_a_time():
    with spans.recording(capacity=2) as rec:
        for _ in range(5):
            with spans.span("sweep.report"):
                pass
        with pytest.raises(RuntimeError):
            with spans.recording():
                pass
    assert len(rec.spans()) == 2 and rec.dropped == 3


def test_profiler_sees_the_same_spans(tmp_path):
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof, spans.recording() as rec:
        with spans.span("sweep.run"):
            with spans.span("sweep.serve"):
                torch.ones(4).sum()
            with spans.span("sweep.finalize"):
                pass
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", events)
    ours = sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e["name"].startswith("sweep.")),
                  key=lambda e: float(e["ts"]))
    assert [e["name"] for e in ours] == ["sweep.run", "sweep.serve",
                                         "sweep.finalize"]
    run, serve, fin = ((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in ours)
    assert run[0] <= serve[0] < serve[1] <= fin[0] < fin[1] <= run[1]
    assert [r.name for r in rec.spans()] == ["sweep.run", "sweep.serve",
                                             "sweep.finalize"]


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "serial"])
@pytest.mark.parametrize("accelerator", ["hitgraph", "accugraph"])
def test_a_sweep_opens_every_layer_span_and_waits_once_a_case_and_serve(
        graph, accelerator, batched):
    cases = _cases(graph, accelerator)
    sweeper = Sweeper(batch_memories=batched, device=CPU)
    with spans.recording() as rec:
        cold_rows = sweeper.run(cases)
    cold = rec.spans()
    assert {r.name for r in cold} == COLD
    recs = _by_index(cold)
    runs = [i for i, r in recs.items() if r.name == "sweep.run"]
    assert len(runs) == 1 and {r.run for r in cold} == {cold[0].run}
    main = recs[runs[0]].thread
    for i, r in recs.items():
        if r.name == "sweep.prepare":
            assert r.parent == runs[0] and r.thread != main
        if r.name.startswith("session."):
            assert _ancestors(recs, i)[:2] == ["sweep.prepare", "sweep.run"]
            assert r.thread != main
        if r.name in ("sweep.serve", "sweep.finalize", "sweep.report"):
            assert r.parent == runs[0] and r.thread == main
    counted = {n: sum(r.name == n for r in cold) for n in COLD}
    assert counted["sweep.prepare"] == counted["sweep.finalize"] == \
        counted["sweep.report"] == len(cases)
    assert counted["sweep.serve"] == (1 if batched else len(cases))
    assert counted["session.algorithm"] == counted["session.model"] == \
        counted["session.program"] == 1
    prep = sorted(r.end_ns - r.start_ns for r in cold
                  if r.name == "sweep.prepare")
    got = sorted(round(row.report.stage_seconds["prepare"] * 1e9)
                 for row in cold_rows)
    assert all(abs(a - b) <= 1 for a, b in zip(prep, got))

    device_mod.zero_host_wait_count()
    with spans.recording() as rec:
        warm_rows = sweeper.run(cases)
    serves = 1 if batched else len(cases)
    assert device_mod.host_wait_count() == len(cases) + serves
    assert {r.name for r in rec.spans()} == WARM
    assert [r.report.runtime_ns for r in warm_rows] == \
        [r.report.runtime_ns for r in cold_rows]


def test_the_batched_serve_stage_is_the_group_serve_over_its_cases(
        graph, monkeypatch):
    cases = _cases(graph, "hitgraph")
    sweeper = Sweeper(batch_memories=True, device=CPU)
    sweeper.run(cases)
    seen = []
    real = vec.StreamTimer.seconds

    def seconds(self):
        seen.append(real(self))
        return seen[-1]
    monkeypatch.setattr(vec.StreamTimer, "seconds", seconds)
    rows = sweeper.run(cases)
    assert len(seen) == 1 and seen[0] > 0
    for row in rows:
        assert row.report.stage_seconds["serve"] == seen[0] / len(cases)


def test_fused_scan_waits_only_when_timed(graph):
    sweeper = Sweeper(device=CPU)
    case = _cases(graph, "hitgraph")[0]
    _model, _run, packed, _cs, _dram = sweeper._prepare_case(case)
    carry = vec.init_lean_carry(packed.issue.shape[1], packed.n_banks,
                                packed.banks_per_rank, torch.device(CPU))
    args = (packed.issue, packed.meta, packed.boundary, packed.timing,
            carry, CPU)
    device_mod.zero_host_wait_count()
    plain, _ = vec.fused_scan(*args)
    assert device_mod.host_wait_count() == 1      # the serve's input check
    stages = {}
    timed, _ = vec.fused_scan(*args, stage_seconds=stages)
    assert device_mod.host_wait_count() == 1 + 3
    assert set(stages) == {"h2d", "serve"}
    assert torch.equal(plain, timed)


def test_counter_and_recorder_lose_nothing_across_threads():
    """Spans and counted waits from more threads than cores, the
    interpreter switching threads as often as it can: not one record or
    count is lost, and the lock witness records nothing."""
    threads, per = 4 * (os.cpu_count() or 4), 300
    start = threading.Barrier(threads)
    t = torch.zeros(2)

    def work():
        start.wait(timeout=30)
        for _ in range(per):
            with spans.span("sweep.report"):
                device_mod.to_host(t)

    device_mod.zero_host_wait_count()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with spans.recording(capacity=threads * per) as rec:
            ts = [threading.Thread(target=work) for _ in range(threads)]
            for th in ts:
                th.start()
            for th in ts:
                th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in ts)
    device_mod.wait(torch.device(CPU))
    assert device_mod.host_wait_count() == threads * per + 1
    recs = rec.spans()
    assert len(recs) == threads * per and rec.dropped == 0
    assert len({r.run for r in recs}) == threads * per
    assert len({r.thread for r in recs}) == threads
    locks.assert_clean()
