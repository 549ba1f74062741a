"""A whole run of each cell on the CPU, the card's look skipped, with the
timed path broken underneath: ``correct`` has to come out false for
every fault the cells can have.  (No cell runs on more than one chip, so
none can leave out an exchange between chips.)"""

import json
from pathlib import Path

import pytest
import torch

from portbench import bench

CELLS = [w["name"] for w in json.loads(
    (Path(__file__).resolve().parents[1] / "BENCHMARK.json").read_text()
)["workloads"]]
BATCHED = [c for c in CELLS if bench.load_cell(c).traffic["batch_memories"]]


def serve_returns_state_unchanged(monkeypatch):
    """The serve hands back its carry as it came and no finishes."""
    from repro_torch.kernels.dram_timing import ops

    def batch(issue, meta, boundary, timing, state):
        M = timing.shape[0]
        return (torch.zeros((M,) + tuple(issue.shape[-3:]),
                            dtype=torch.int32), state)

    def single(issue, meta, boundary, timing, state):
        return torch.zeros(issue.shape, dtype=torch.int32), state
    batch.launches = single.launches = 0      # read by launch_counts()
    monkeypatch.setattr(ops, "dram_serve_batch", batch)
    monkeypatch.setattr(ops, "dram_serve", single)


def half_the_batch_served(monkeypatch):
    """The batched serve serves the first half of its cases and hands
    their mean finishes to the rest."""
    from repro_torch.core import vectorized as vec
    real = vec.fused_scan_batch

    def batch(issue, meta, boundary, timing, *rest):
        half = max(len(timing) // 2, 1)
        fins, state = real(issue, meta, boundary, timing[:half], *rest)
        mean = fins.float().mean(0).round().to(fins.dtype)
        rest_fins = mean.expand((len(timing) - half,) + mean.shape)
        return torch.cat([fins, rest_fins]), state
    monkeypatch.setattr(vec, "fused_scan_batch", batch)


def one_answer_altered(monkeypatch):
    """Every serve's last case finishes one cycle later where the serve
    writes it."""
    from repro_torch.core import vectorized as vec
    real_batch, real_single = vec.fused_scan_batch, vec.fused_scan

    def batch(*args):
        fins, state = real_batch(*args)
        fins = fins.clone()
        fins[-1] += 1
        return fins, state

    def single(*args, **kw):
        fin, state = real_single(*args, **kw)
        return fin + 1, state
    monkeypatch.setattr(vec, "fused_scan_batch", batch)
    monkeypatch.setattr(vec, "fused_scan", single)


FAULTS = [(c, f) for c in CELLS
          for f in (serve_returns_state_unchanged, one_answer_altered)]
FAULTS += [(c, half_the_batch_served) for c in BATCHED]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_makes_the_run_incorrect(tiny_root, run_cpu, monkeypatch,
                                       workload, fault):
    fault(monkeypatch)
    out = run_cpu(tiny_root, workload)
    assert out["correct"] is False
    checks = out["checks"]
    assert any(c["value"] > c["limit"] for c in checks.values()), checks


def test_the_unbroken_run_is_correct(tiny_root, run_cpu):
    out = run_cpu(tiny_root, CELLS[0], trace=True)
    assert out["correct"] is True
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
