"""The plain reference against the program's CPU path and against the
edge-by-edge definitions it computes in bulk (tiny graphs, the CPU)."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import compare, graphgen
from portbench.reference import algorithms, dram, expected_reports

HERE = Path(__file__).resolve().parent


def config(name: str, vertices: int = 300, edges: int = 700, **acc):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg["graph"].update(vertices=vertices, edges=edges)
    cfg["accelerator_config"].update(acc)
    return cfg


def grid(name: str, points: int = 3):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text()
                      )["grid"][:points]


def program_reports(cfg, graph, pts, batched):
    """The program's reports of the grid on the CPU, through the sweep
    engine as a cell drives it."""
    import dataclasses

    from repro_torch.core.dram import DRAMTiming
    from repro_torch.graphs.formats import Graph
    from repro_torch.sim.registry import get_accelerator
    from repro_torch.sim.sweep import SweepCase, Sweeper
    g = Graph(graph.n, graph.src.copy(), graph.dst.copy(),
              directed=graph.directed, name=graph.name)
    acc = get_accelerator(cfg["accelerator"]).config_cls(
        **cfg["accelerator_config"])
    base = acc.dram_config()
    cases = [SweepCase(graph=g, problem=cfg["problem"],
                       accelerator=cfg["accelerator"], config=acc,
                       memory=None if "timing" not in pt else
                       dataclasses.replace(base,
                                           timing=DRAMTiming(**pt["timing"])))
             for pt in pts]
    rows = Sweeper(batch_memories=batched, device="cpu").run(cases)
    return [compare.as_fields(r.report) for r in rows]


@pytest.mark.parametrize("name,mix,acc", [
    ("hitgraph-wt-wcc", "ddr3-grid", {}),
    ("hitgraph-wt-wcc", "ddr3-grid", {"partition_elements": 64}),
    ("hitgraph-wt-wcc", "ddr3-grid",
     {"partition_elements": 50, "update_merging": False,
      "partition_skipping": False}),
    ("accugraph-wt-wcc", "ddr4-grid", {}),
    ("accugraph-wt-wcc", "ddr4-grid",
     {"partition_elements": 100, "prefetch_skipping": True,
      "partition_skipping": True}),
])
def test_reference_equals_program_on_cpu(name, mix, acc):
    cfg = config(name, **acc)
    graph = graphgen.make_graph(cfg["graph"], 7)
    pts = grid(mix)
    want = expected_reports(cfg, graph, pts, processes=1)
    got = program_reports(cfg, graph, pts, batched=True)
    v = compare.judge([got], want)
    assert v.correct, v.first_diffs
    assert v.reports == len(pts)
    # the points differ from one another: the timing is read
    assert len({r["runtime_ns"] for r in want}) == len(pts)


def test_reference_in_processes_equals_in_process():
    cfg = config("hitgraph-wt-wcc", partition_elements=64)
    graph = graphgen.make_graph(cfg["graph"], 3)
    pts = grid("ddr3-grid", 2)
    assert (expected_reports(cfg, graph, pts, processes=2)
            == expected_reports(cfg, graph, pts, processes=1))


def test_edge_order_from_seed_keeps_every_report():
    cfg = config("accugraph-wt-wcc", vertices=500, edges=1500)
    pts = grid("ddr4-grid", 2)
    reports = [expected_reports(cfg, graph, pts, processes=1)
               for graph in (graphgen.make_graph(cfg["graph"], s)
                             for s in (1, 2**31 + 9))]
    assert reports[0] == reports[1]
    a, b = (graphgen.make_graph(cfg["graph"], s) for s in (1, 2))
    assert not np.array_equal(a.src, b.src)
    assert sorted(zip(a.src, a.dst)) == sorted(zip(b.src, b.dst))


def sequential_sweep(values, src, dst, add):
    vals = values.tolist()
    for s, d in zip(src.tolist(), dst.tolist()):
        vals[d] = min(vals[d], vals[s] + add)
    return np.array(vals, dtype=np.int32)


@pytest.mark.parametrize("seed", range(6))
def test_sweep_rounds_equal_the_edge_by_edge_sweep(seed):
    rng = np.random.default_rng(seed)
    n, m = 60, 200
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    add = seed % 2
    values = rng.integers(0, 50, n).astype(np.int32)
    np.testing.assert_array_equal(
        algorithms.sweep_rounds(values, src, dst, add),
        sequential_sweep(values, src, dst, add))


def test_serve_program_follows_the_timing_rules():
    """Two requests to one bank of one channel: a closed bank, then
    another row (a conflict), worked by hand."""
    dev = dram.Device(channels=1, ranks=1, banks=2, rows=4,
                      row_bytes=128, clock_ghz=1.0,
                      order=("column", "rank", "bank", "row", "channel"))
    # line = column + 2 * (bank + 2 * row): lines 0 and 4 are bank 0,
    # rows 0 and 1
    t = dict(tCL=3, tRCD=2, tRP=2, tRAS=6, tBL=1, tRRD=1, tFAW=100)
    prog = dram.decode_program(dev, [("p", np.array([0, 4]),
                                      np.array([0, 0]))])
    (ph,) = dram.serve_program(dev, prog, t)
    # act 0, col 2, done 6; pre max(0, 3, 0 + 6) = 6, act 8, col 10,
    # done max(13, 6) + 1 = 14
    assert (ph.end, ph.hits, ph.conflicts) == (14, 0, 1)
    # two phases: the second finds row 1 open, unless the state is
    # forgotten at the barrier (the control), where it activates again:
    # act 14, col 16, done 20
    two = dram.decode_program(dev, [("a", np.array([0, 4]),
                                     np.array([0, 0])),
                                    ("b", np.array([4]), np.array([0]))])
    kept, cold = (dram.serve_program(dev, two, t, carry_state=c)[1]
                  for c in (True, False))
    # kept: col max(14, 11) = 14, done max(17, 14) + 1 = 18, a hit
    assert (kept.start, kept.end, kept.hits) == (14, 18, 1)
    assert (cold.start, cold.end, cold.hits) == (14, 20, 0)


def test_control_fails_the_comparison():
    """The reference that forgets the banks' state at every phase
    barrier, in the program's place, is not correct."""
    from portbench.control import control_verdict
    from portbench.bench import Cell
    cfg = config("hitgraph-wt-wcc", vertices=2000, edges=5000)
    traffic = json.loads((HERE / "traffic" / "ddr3-grid.json").read_text())
    cell = Cell("x", HERE, 1, cfg, traffic, [], [])
    v = control_verdict(cell, 5, processes=1)
    assert not v.correct
    assert v.mismatched_fields > 0 and v.max_runtime_rel_gap > 0

