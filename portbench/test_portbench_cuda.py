"""The harness on the card at a tiny size: every cell is correct there,
and its result line names the card (marked ``cuda``: skips without one;
run on the card with ``pytest -m cuda portbench``)."""

import json
import time
from pathlib import Path

import pytest
import torch

from portbench import bench

pytestmark = pytest.mark.cuda

CELLS = [w["name"] for w in json.loads(
    (Path(__file__).resolve().parents[1] / "BENCHMARK.json").read_text()
)["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.cuda.get_device_name(0)


@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_is_correct_on_the_card(tiny_root, card, workload):
    out = bench.run(workload, 7, 0.5, True, time.perf_counter(),
                    root=tiny_root, reference_processes=1)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert out["device"]["kind"] == card and out["device"]["platform"] == \
        "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert "serve_kernel_ms_per_point" in out["metrics"]
