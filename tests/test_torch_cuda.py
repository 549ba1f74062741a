"""The port's CUDA kernels on the card, against their plain versions and
against the CPU run.  Marked ``cuda``: they skip where there is no CUDA
device.  On a machine with the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import accel, vectorized as vec
from repro_torch.core.dram import PRESETS
from repro_torch.core.trace import SegmentedTrace
from repro_torch.graphs.generators import rmat
from repro_torch.kernels.dram_timing.ops import dram_serve
from repro_torch.kernels.dram_timing.ref import dram_serve_ref
from repro_torch.kernels.sweep_min.ops import sweep_min, sweep_min_ref
from repro_torch.sim import simulate

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
