"""The harness on the CPU: the contract's shape of ``BENCHMARK.json``,
cells, configurations, mixes and metrics found by name, a new one picked
up from files alone, the import rule, and the byte count."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import bench, devicetrace, roofline

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert 0 < len(c["source"]) <= 200 and 0 < len(c["why"]) <= 200
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert 0 < len(w["why"]) <= 200
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and 0 < len(m["layer"]) <= 200
        cells = m.get("workloads", CELLS)
        moved = next(e for e in BENCH["end_to_end"]
                     if e["name"] == m["moves"])
        assert set(cells) <= set(moved.get("workloads", CELLS))
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_found_by_name(workload):
    cell = bench.load_cell(workload)
    assert cell.config["memory"]["standard"] == \
        cell.traffic["memory_standard"]
    names = {m["name"] for m in cell.end_to_end}
    assert {"setup_s", "points_per_s"} <= names
    for m in cell.per_layer:
        assert callable(bench.load_reader(m["name"]))


def test_unknown_cell_is_refused():
    with pytest.raises(bench.BenchError):
        bench.load_cell("no-such-cell")


def test_new_config_mix_and_metric_are_files_and_entries(tiny_root,
                                                         run_cpu):
    """A configuration, a mix and a per-layer metric added as new files
    and new entries run with no edit to a file that is there."""
    folder = tiny_root / "portbench"
    cfg = json.loads((folder / "configs" / "accugraph-wt-wcc.json")
                     .read_text())
    cfg.update(name="accugraph-tiny-bfs", problem="bfs", root=3)
    (folder / "configs" / "accugraph-tiny-bfs.json").write_text(
        json.dumps(cfg))
    mix = json.loads((folder / "traffic" / "ddr4-grid.json").read_text())
    mix.update(name="ddr4-loop", entry="session", grid=mix["grid"][:2])
    (folder / "traffic" / "ddr4-loop.json").write_text(json.dumps(mix))
    (folder / "metrics" / "calls_seen.py").write_text(
        "def read(r):\n    return float(r['points'])\n")
    b = json.loads((tiny_root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "accugraph-tiny-bfs", "source": "x",
                         "file": "portbench/configs/accugraph-tiny-bfs.json",
                         "reduced": [], "why": "x"})
    cell = "accugraph-tiny-bfs.ddr4-loop"
    b["workloads"].append({"name": cell, "config": "accugraph-tiny-bfs",
                           "traffic": "ddr4-loop", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "calls_seen", "unit": "points",
                           "better": "higher", "source": "host_clock",
                           "layer": "x", "moves": "points_per_s",
                           "workloads": [cell]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(b))
    plain = run_cpu(tiny_root, cell)
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {"points_per_s", "setup_s"}
    traced = run_cpu(tiny_root, cell, trace=True)
    assert traced["correct"]
    assert traced["metrics"]["calls_seen"]["value"] >= 2
    assert list(traced)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_runs_on_the_cpu_at_a_tiny_size(tiny_root, run_cpu,
                                                 workload):
    out = run_cpu(tiny_root, workload)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert out["attempted"] >= len(bench.load_cell(workload)
                                   .traffic["grid"])
    want = {m["name"] for m in bench.load_cell(workload).end_to_end}
    assert set(out["metrics"]) == want
    assert list(out)[-1] == "checks"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(bench.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    judged = [*(HERE / "reference").glob("*.py"),
              *(HERE / n for n in ("graphgen.py", "compare.py",
                                   "control.py", "roofline.py"))]
    for path in judged:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert "repro_torch" not in tops and "torch" not in tops, path
    code = ("import sys; import portbench.control, portbench.reference; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'torch', 'repro_torch', 'repro', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no CUDA device" in out.stderr


def test_a_checkout_without_the_program_is_refused(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from portbench import bench; bench.import_program()")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and "BenchError" in out.stderr


def test_serve_bytes_worked_by_hand():
    # S=2, C=1, K=1, B=2, R=1: program 2 * 8 + 2 * 4 = 24; a case's timing
    # 28, finishes 2 * 4 = 8, carry 2 * 4 * (2 + 2 + 2 + 5) = 88
    assert roofline.serve_bytes(2, 1, 1, 2, 1) == 24 + 28 + 8 + 88
    # three cases: the shared program once, or once a case
    assert roofline.serve_bytes(2, 1, 1, 2, 1, M=3) == 24 + 3 * 124
    assert roofline.serve_bytes(2, 1, 1, 2, 1, M=3, shared=False) == \
        3 * (24 + 124)
    # the full HitGraph program of 4 timing cases: the bound the kernel
    # table gives, 0.1718 ms at 3.35 TB/s
    ms = roofline.serve_bytes(745472, 4, 8, 16, 2, M=4) / 3.35e12 * 1e3
    assert abs(ms - 0.1718) < 5e-4
    assert roofline.peak("NVIDIA H100 80GB HBM3", "hbm_bytes_per_s") == \
        3.35e12
    assert roofline.peak("some other card", "hbm_bytes_per_s") is None


def test_p90_of_calls():
    assert bench.p90([1.0]) == 1.0
    assert bench.p90([float(i) for i in range(1, 12)]) == pytest.approx(10)


def test_device_trace_reduction():
    dev = [("k", 0.0, 2.0), ("k", 1.0, 3.0), ("j", 5.0, 6.0)]
    host = [("portbench.call", 0.0, 10.0), ("aten::item", 3.0, 5.0)]
    assert devicetrace.busy_us(dev) == 4.0
    assert devicetrace.top_ops(dev) == [["k", 4e-6], ["j", 1e-6]]
    gaps = devicetrace.idle_gaps(dev, host, 0.0, 10.0)
    assert gaps == [["portbench.call", 4e-6], ["aten::item", 2e-6]]
    assert devicetrace.clip(dev, 1.5, 5.5) == [("k", 1.5, 2.0),
                                              ("k", 1.5, 3.0),
                                              ("j", 5.0, 5.5)]
