"""Shared pieces of the benchmark's own tests (run on the CPU with the
program's plain versions, at tiny sizes; the ``cuda`` ones on the card)."""

import json
import shutil
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device and nvcc; skips without them")


@pytest.fixture(autouse=True)
def one_thread():
    """The suite runs several workers at once: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of ``BENCHMARK.json`` and the benchmark's folder in which
    every configuration's graph is cut to 300 vertices and 700 edges
    (HitGraph's partitions to 64 vertices, so that there are several)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    folder = tmp_path / HERE.name
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(HERE / sub, folder / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for path in (folder / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["graph"].update(vertices=300, edges=700)
        if cfg["accelerator"] == "hitgraph":
            cfg["accelerator_config"]["partition_elements"] = 64
        path.write_text(json.dumps(cfg))
    return tmp_path


@pytest.fixture
def run_cpu():
    """``run_cpu(root, workload, trace=False, seed=5)``: one run of the
    harness on the CPU, 0.3 s of window."""
    from portbench import bench

    def run(root, workload, trace=False, seed=5):
        return bench.run(workload, seed, 0.3, trace, time.perf_counter(),
                         device="cpu", root=root, reference_processes=1)
    return run
