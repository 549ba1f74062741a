"""The port's CUDA kernels on the card, against their plain versions and
against the CPU run.  Marked ``cuda``: they skip where there is no CUDA
device.  On a machine with the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import accel, vectorized as vec
from repro_torch.core.dram import PRESETS, ddr4_2400r
from repro_torch.core.trace import SegmentedTrace, Trace
from repro_torch.graphs.generators import rmat
from repro_torch.kernels.dram_timing.ops import dram_serve, dram_timing
from repro_torch.kernels.dram_timing.ref import (dram_serve_ref,
                                                 dram_timing_ref)
from repro_torch.kernels.sweep_min.ops import sweep_min, sweep_min_ref
from repro_torch.sim import run_dynamic, simulate

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _program(seed, hit_heavy, n_phases=4, max_n=300):
    rng = np.random.default_rng(seed)
    phases = []
    for p in range(n_phases):
        n = int(rng.integers(1, max_n))
        lines = rng.integers(0, 64 if hit_heavy else 1 << 16, n)
        if hit_heavy:
            lines = np.sort(lines)
        issue = np.sort(rng.integers(0, 4 * n, n))
        phases.append((f"p{p}", lines, np.zeros(n, dtype=bool), issue))
    return SegmentedTrace.from_phases(phases)


@pytest.mark.parametrize("preset", ["hitgraph", "accugraph", "hbm2",
                                    "hbm2e"])
@pytest.mark.parametrize("hit_heavy", [False, True])
def test_dram_serve_kernel_equals_plain(cuda, preset, hit_heavy):
    cfg = PRESETS[preset]()
    packed = accel.pack_program(_program(7, hit_heavy), cfg)
    args = [torch.as_tensor(np.asarray(a, dtype=np.int32), device=cuda)
            for a in (packed.issue, packed.meta, packed.boundary,
                      packed.timing)]
    C = cfg.channels
    state = tuple(vec.init_lean_carry(C, packed.n_banks,
                                      packed.banks_per_rank, cuda)) + (
        torch.zeros(C, dtype=torch.int32, device=cuda),)
    before = dram_serve.launches
    fin_k, st_k = dram_serve(*args, state)
    torch.cuda.synchronize()
    assert dram_serve.launches == before + 1
    fin_p, st_p = dram_serve_ref(*args, state)
    assert torch.equal(fin_k, fin_p)
    for a, b in zip(st_k, st_p):
        assert torch.equal(a, b)


def test_sweep_min_kernel_equals_plain(cuda):
    g = rmat(10, 4, seed=3).undirected_view()
    order = np.argsort(g.dst, kind="stable")
    src = torch.as_tensor(g.src[order].astype(np.int32), device=cuda)
    dst = torch.as_tensor(g.dst[order].astype(np.int32), device=cuda)
    for add in (0, 1):
        vals_k = torch.arange(g.n, dtype=torch.int32, device=cuda)
        vals_p = vals_k.clone()
        sweep_min(vals_k, src, dst, add)
        sweep_min_ref(vals_p, src, dst, add)
        assert torch.equal(vals_k, vals_p)


@pytest.mark.parametrize("accelerator", ["hitgraph", "accugraph"])
def test_simulate_on_card_equals_cpu(cuda, accelerator):
    g = rmat(8, 5, seed=102).undirected_view()
    a = simulate(g, "wcc", accelerator=accelerator, partition_elements=64)
    b = simulate(g, "wcc", accelerator=accelerator, partition_elements=64,
                 device="cpu")
    assert a == b


def _channel_streams(cfg, seed, n=3000, span=1 << 16, bulk=False):
    """Per-channel streams of a random trace; ``bulk`` issues every
    request at cycle 0 over many rows, so the ACT window (tFAW) binds."""
    rng = np.random.default_rng(seed)
    lines = rng.integers(0, span, n)
    issue = (np.zeros(n, dtype=np.int64) if bulk
             else np.sort(rng.integers(0, 4 * n, n)))
    return vec.pack_channels(Trace(lines, np.zeros(n, bool), issue), cfg)


@pytest.mark.parametrize("memory", ["ddr3", "ddr4", "hbm2", "ddr4-2rank",
                                    "ddr4-faw"])
def test_dram_timing_kernel_equals_plain(cuda, memory):
    """Kernel against plain on the card, bit for bit, with the carry
    chained across two kernel calls; ``ddr4-faw`` trips the tFAW
    window."""
    cfg = {"ddr3": PRESETS["hitgraph"], "ddr4": PRESETS["accugraph"],
           "hbm2": PRESETS["hbm2"],
           "ddr4-2rank": lambda: ddr4_2400r(channels=2, ranks=2),
           "ddr4-faw": PRESETS["accugraph"]}[memory]()
    packed = _channel_streams(cfg, seed=len(memory),
                              bulk=memory == "ddr4-faw",
                              span=1 << 24 if memory == "ddr4-faw"
                              else 1 << 16)
    args = [torch.as_tensor(a, device=cuda) for a in
            (packed.issue, packed.bank, packed.row, packed.valid)]
    timing = torch.as_tensor(vec.timing_params(cfg.timing), device=cuda)
    carry = vec.init_channel_carry(cfg.channels, cfg.banks_per_channel,
                                   cfg.org.banks, cuda)
    h = packed.issue.shape[1] // 2
    before = dram_timing.launches
    fins, kinds, st = [], [], carry
    for lo, hi in ((0, h), (h, packed.issue.shape[1])):
        f, k, st = dram_timing(*(a[:, lo:hi].contiguous() for a in args),
                               timing, st)
        fins.append(f)
        kinds.append(k)
    torch.cuda.synchronize()
    assert dram_timing.launches == before + 2
    fin_p, kind_p, st_p = dram_timing_ref(*args, timing, carry)
    assert torch.equal(torch.cat(fins, 1), fin_p)
    assert torch.equal(torch.cat(kinds, 1), kind_p)
    for a, b in zip(st, st_p):
        assert torch.equal(a, b)


@pytest.mark.parametrize("accelerator", ["hitgraph", "accugraph"])
def test_run_dynamic_on_card_equals_cpu(cuda, accelerator):
    g = rmat(8, 5, seed=102).undirected_view()
    kw = dict(updates="uniform-churn", accelerator=accelerator,
              partition_elements=64)
    a = run_dynamic(g, "wcc", verify=True, **kw)
    b = run_dynamic(g, "wcc", device="cpu", **kw)
    assert a.epochs == b.epochs and a.report == b.report
    assert np.array_equal(a.final_values, b.final_values)
    assert all(ep.report.kernel_launches.get("dram_timing", 0) == 1
               for ep in a.epochs[1:])
