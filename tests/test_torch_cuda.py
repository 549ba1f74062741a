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
from repro_torch.kernels.edge_scatter.ops import edge_scatter
from repro_torch.kernels.edge_scatter.ref import edge_scatter_ref
from repro_torch.kernels.segment_reduce.ops import segment_reduce
from repro_torch.kernels.segment_reduce.ref import segment_reduce_ref
from repro_torch.kernels.spmv_ell.ops import (pack_in_edges, spmv_ell,
                                              spmv_sell)
from repro_torch.kernels.spmv_ell.ref import spmv_ell_ref, spmv_sell_ref
from repro_torch.kernels.dram_timing.ops import (CHUNK_LENS, chunk_steps,
                                                 dram_timing_chunks,
                                                 dram_timing_serial,
                                                 serve_prepass,
                                                 serve_records)
from repro_torch.kernels.dram_timing.ops import dram_serve_batch
from repro_torch.kernels.dram_timing.ref import (dram_serve_batch_ref,
                                                 serve_prepass_ref)
from repro_torch.kernels.sweep_min import ops as sweep_ops
from repro_torch.kernels.sweep_min.ops import (pack_sweep_block, sweep_min,
                                               sweep_min_block,
                                               sweep_min_ref,
                                               sweep_min_rounds,
                                               sweep_min_rounds_ref)
from repro_torch.algorithms import edge_centric, vertex_centric
from repro_torch.algorithms.common import Problem
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


@pytest.mark.parametrize("channels", [1, 2, 4, 8])
@pytest.mark.parametrize("hit_heavy", [False, True])
def test_dram_serve_channels_equal_plain(cuda, channels, hit_heavy):
    """The pre-pass and the warp-a-channel serve on C = 1, 2, 4 and 8
    DDR4 channels of 2 ranks, bit for bit against the plain serve, with
    the carry chained across a split; the pre-pass's records equal their
    plain version's."""
    cfg = ddr4_2400r(channels=channels, ranks=2)
    packed = accel.pack_program(_program(11 + channels, hit_heavy,
                                         n_phases=6), cfg)
    args = [torch.as_tensor(np.asarray(a, dtype=np.int32), device=cuda)
            for a in (packed.issue, packed.meta, packed.boundary,
                      packed.timing)]
    S, C, K = packed.issue.shape
    state = tuple(vec.init_lean_carry(C, packed.n_banks,
                                      packed.banks_per_rank, cuda)) + (
        torch.zeros(C, dtype=torch.int32, device=cuda),)
    B, R = state[0].shape[1], state[3].shape[1]
    T = chunk_steps(C, K)
    before = (dram_serve.launches, serve_prepass.launches)
    rec = serve_prepass(*args, B // R, R, T)
    assert torch.equal(rec, serve_prepass_ref(
        *args, B // R, R, rec.shape[1]))
    split = packed.n_steps // 2 + 1
    fins, st = [], state
    for lo, hi in ((0, split), (split, S)):
        f, st = dram_serve(*(a[lo:hi].contiguous() for a in args[:3]),
                           args[3], st)
        fins.append(f)
    fin_r, st_r = serve_records(rec, args[3], state, S)
    torch.cuda.synchronize()
    assert (dram_serve.launches, serve_prepass.launches) == (
        before[0] + 3, before[1] + 3)
    fin_p, st_p = dram_serve_ref(*args, state)
    assert torch.equal(torch.cat(fins), fin_p)
    assert torch.equal(fin_r, fin_p)
    for a, b, c in zip(st, st_r, st_p):
        assert torch.equal(a, c) and torch.equal(b, c)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dram_serve_any_meta_equals_plain(cuda, seed):
    """Blocks the packer never makes (several misses, invalid miss lanes,
    banks past the channel's) on 4 channels of 2 ranks, K = 8: the kernel
    keeps the plain step's semantics bit for bit."""
    rng = np.random.default_rng(seed)
    S, C, K, B, R = 300, 4, 8, 8, 2
    issue = rng.integers(0, 500, (S, C, K))
    meta = (rng.integers(0, B + 2, (S, C, K))
            | rng.choice([0, vec.META_MISS], (S, C, K))
            | rng.choice([0, vec.META_CONFL], (S, C, K))
            | rng.choice([0, vec.META_VALID, vec.META_VALID], (S, C, K))
            | (rng.integers(0, K, (S, C, K)) << vec.META_RB_SHIFT))
    args = [torch.as_tensor(np.asarray(a, dtype=np.int32), device=cuda)
            for a in (issue, meta, rng.random(S) < 0.1,
                      vec.timing_params(PRESETS["accugraph"]().timing))]
    state = tuple(vec.init_lean_carry(C, B, B // R, cuda)) + (
        torch.zeros(C, dtype=torch.int32, device=cuda),)
    fin_k, st_k = dram_serve(*args, state)
    fin_p, st_p = dram_serve_ref(*args, state)
    assert torch.equal(fin_k, fin_p)
    for a, b in zip(st_k, st_p):
        assert torch.equal(a, b)


def _path_block(n, ascending, device):
    v = np.arange(1, n)
    src, dst = (v - 1, v) if ascending else (v, v - 1)
    order = np.argsort(dst, kind="stable")
    return pack_sweep_block(src[order], dst[order], n, device=device)


@pytest.mark.parametrize("add", [0, 1])
@pytest.mark.parametrize("start", ["arange", "warm"])
def test_sweep_min_block_equals_plain(cuda, add, start):
    """The round kernel against the sequential sweep and the synchronous
    rounds on rmat(12, 4) (destination-sorted, self-loops and duplicate
    edges kept), from the WCC start values and from a warm start; it runs
    at most as many rounds as the synchronous version, one launch a
    sweep, never the serial route."""
    g = rmat(12, 4, seed=9)
    order = np.argsort(g.dst, kind="stable")
    block = pack_sweep_block(g.src[order], g.dst[order], g.n, device=cuda)
    rng = np.random.default_rng(add)
    x0 = (np.arange(g.n) if start == "arange"
          else rng.integers(0, 2**31 - 2**24, g.n))
    vals_k = torch.as_tensor(x0.astype(np.int32), device=cuda)
    vals_p, vals_r = vals_k.clone(), vals_k.clone()
    before = (sweep_min_rounds.launches, sweep_min.launches)
    res = sweep_min_block(vals_k, block, add)
    assert (sweep_min_rounds.launches, sweep_min.launches) == (
        before[0] + 1, before[1])
    assert res.route == "rounds"
    sweep_min_ref(vals_p, block.src, block.dst, add)
    rounds = sweep_min_rounds_ref(vals_r, block, add)
    assert torch.equal(vals_k, vals_p) and torch.equal(vals_r, vals_p)
    assert 1 <= res.rounds <= rounds


@pytest.mark.parametrize("ascending", [True, False])
def test_sweep_min_block_paths(cuda, monkeypatch, ascending):
    """Paths of 4,096 vertices from the WCC start: descending converges in
    one round; ascending needs many, and with a budget of 3 rounds the
    wrapper restores the values and takes the serial route, still exact."""
    n = 4096
    block = _path_block(n, ascending, cuda)
    for budget in (None, 3):
        if budget is not None:
            monkeypatch.setattr(sweep_ops, "round_budget",
                                lambda block: budget)
        vals = torch.arange(n, dtype=torch.int32, device=cuda)
        want = vals.clone()
        sweep_min_ref(want, block.src, block.dst, 0)
        before = sweep_min.launches
        res = sweep_min_block(vals, block, 0)
        assert torch.equal(vals, want)
        if not ascending:
            assert res == (1, "rounds")
        elif budget == 3:
            assert res == (3, "serial")
            assert sweep_min.launches == before + 1
        else:
            assert res.route in ("rounds", "serial") and res.rounds > 3


def test_sweep_min_rounds_status_and_overflow(cuda):
    """The round kernel's status words on an ascending path of 64
    vertices (64 rounds at most; cut at 3 it has not converged, and the
    values lie between the serial result and the start), one launch each;
    and ``sweep_min_block`` on the card rejecting values whose peak + add
    wraps, after the launch, with the values restored."""
    n = 64
    block = _path_block(n, True, cuda)
    x0 = torch.arange(n, dtype=torch.int32, device=cuda)
    want = x0.clone()
    sweep_min_ref(want, block.src, block.dst, 0)
    for max_rounds in (3, 1000):
        vals = x0.clone()
        status = torch.zeros(3, dtype=torch.int32, device=cuda)
        before = sweep_min_rounds.launches
        sweep_min_rounds(vals, x0.clone(), block, 0, max_rounds, status)
        assert sweep_min_rounds.launches == before + 1
        last, rounds, done = status.tolist()
        if max_rounds == 3:
            assert (last, rounds, done) == (3, 3, 0)
            assert bool((vals >= want).all() & (vals <= x0).all())
        else:
            assert done == 1 and last == rounds - 1 and 1 <= rounds <= n
            assert torch.equal(vals, want)
    vals = x0.clone()
    vals[5] = 2**31 - 1
    kept = vals.clone()
    with pytest.raises(ValueError, match="2\\*\\*31"):
        sweep_min_block(vals, block, 1)
    assert torch.equal(vals, kept)


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


_TIMING_MEMORIES = {"ddr3": PRESETS["hitgraph"], "ddr4": PRESETS["accugraph"],
                    "hbm2": PRESETS["hbm2"],
                    "ddr4-2rank": lambda: ddr4_2400r(channels=2, ranks=2)}


def _same_timing(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))


@pytest.mark.parametrize("memory", sorted(_TIMING_MEMORIES))
def test_dram_timing_chunked_equals_plain_and_serial(cuda, memory):
    """The chunked scan against the plain version and the serial kernel,
    bit for bit, at every chunk length it is built for, with the carry
    scan's groups of 1, 7 and 64 chunks, and as the wrapper picks them,
    with the carry chained across two calls; one launch counted a call."""
    cfg = _TIMING_MEMORIES[memory]()
    packed = _channel_streams(cfg, seed=60 + len(memory), n=5000)
    args = [torch.as_tensor(a, device=cuda) for a in
            (packed.issue, packed.bank, packed.row, packed.valid)]
    timing = torch.as_tensor(vec.timing_params(cfg.timing), device=cuda)
    cold = vec.init_channel_carry(cfg.channels, cfg.banks_per_channel,
                                  cfg.org.banks, cuda)
    h = packed.issue.shape[1] // 3
    first = [a[:, :h].contiguous() for a in args]
    rest = [a[:, h:].contiguous() for a in args]
    warm = dram_timing_ref(*first, timing, cold)[2]
    want = dram_timing_ref(*rest, timing, warm)
    before = (dram_timing.launches, dram_timing_serial.launches)
    _same_timing(dram_timing(*rest, timing, warm), want)
    _same_timing(dram_timing_serial(*rest, timing, warm), want)
    for T in CHUNK_LENS:
        _same_timing(dram_timing_chunks(*rest, timing, warm, T)[:3], want)
    # the carry scan as one serial walk, and in groups that split unevenly
    for group in (1, 7, 64):
        _same_timing(dram_timing_chunks(*rest, timing, warm, 64, group)[:3],
                     want)
    torch.cuda.synchronize()
    assert (dram_timing.launches, dram_timing_serial.launches) == (
        before[0] + 4 + len(CHUNK_LENS), before[1] + 1)
    fin1, kind1, st = dram_timing(*first, timing, cold)
    fin2, kind2, st = dram_timing(*rest, timing, st)
    _same_timing((torch.cat([fin1, fin2], 1), torch.cat([kind1, kind2], 1),
                  st), dram_timing_ref(*args, timing, cold))



@pytest.mark.parametrize("memory", sorted(_TIMING_MEMORIES))
def test_timing_kernels_equal_their_named_plain_versions(cuda, memory):
    """Each timing kernel against the plain version named for it, bit for
    bit, with a warm carry: the serial kernel against
    ``dram_timing_serial_ref``, the chunked scan at every chunk length
    against ``dram_timing_chunked_ref`` (the card's passes in torch at
    the same chunk length)."""
    from repro_torch.kernels.dram_timing.ref import (dram_timing_chunked_ref,
                                                     dram_timing_serial_ref)
    cfg = _TIMING_MEMORIES[memory]()
    packed = _channel_streams(cfg, seed=80 + len(memory), n=4000)
    args = [torch.as_tensor(a, device=cuda) for a in
            (packed.issue, packed.bank, packed.row, packed.valid)]
    timing = torch.as_tensor(vec.timing_params(cfg.timing), device=cuda)
    cold = vec.init_channel_carry(cfg.channels, cfg.banks_per_channel,
                                  cfg.org.banks, cuda)
    h = packed.issue.shape[1] // 4
    warm = dram_timing_ref(*(a[:, :h].contiguous() for a in args), timing,
                           cold)[2]
    rest = [a[:, h:].contiguous() for a in args]
    _same_timing(dram_timing_serial(*rest, timing, warm),
                 dram_timing_serial_ref(*rest, timing, warm))
    for T in CHUNK_LENS:
        _same_timing(dram_timing_chunks(*rest, timing, warm, T)[:3],
                     dram_timing_chunked_ref(*rest, timing, warm, T))


def test_dram_timing_single_slot_and_all_invalid_on_card(cuda):
    cfg = PRESETS["accugraph"]()
    timing = torch.as_tensor(vec.timing_params(cfg.timing), device=cuda)
    carry = vec.init_channel_carry(1, 16, 16, cuda)
    one = [torch.tensor([[5]], dtype=torch.int32, device=cuda),
           torch.tensor([[3]], dtype=torch.int32, device=cuda),
           torch.tensor([[9]], dtype=torch.int32, device=cuda),
           torch.tensor([[True]], device=cuda)]
    none = [a.repeat(1, 3000) for a in one[:3]] + [
        torch.zeros((1, 3000), dtype=torch.bool, device=cuda)]
    for args in (one, none):
        want = dram_timing_ref(*args, timing, carry)
        _same_timing(dram_timing(*args, timing, carry), want)
        for T in CHUNK_LENS:
            _same_timing(dram_timing_chunks(*args, timing, carry, T)[:3],
                         want)
        carry = want[2]


def test_dram_timing_wrap_raises_on_card(cuda):
    """Where the int32 scan would wrap (a bus time just below 2**31), the
    chunked scan raises instead of returning other cycles."""
    cfg = PRESETS["accugraph"]()
    timing = torch.as_tensor(vec.timing_params(cfg.timing), device=cuda)
    carry = list(vec.init_channel_carry(1, 16, 16, cuda))
    carry[3] = torch.tensor([2**31 - 3], dtype=torch.int32, device=cuda)
    args = [torch.tensor([[0, 1]], dtype=torch.int32, device=cuda),
            torch.tensor([[0, 1]], dtype=torch.int32, device=cuda),
            torch.tensor([[7, 7]], dtype=torch.int32, device=cuda),
            torch.tensor([[True, True]], device=cuda)]
    with pytest.raises(ValueError, match="int32"):
        dram_timing(*args, timing, tuple(carry))
    assert int(dram_timing_serial(*args, timing, tuple(carry))[0].min()) < 0


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
               and ep.report.kernel_launches.get("dram_timing_serial", 0) == 0
               for ep in a.epochs[1:])


@pytest.mark.parametrize("op,dtype", [("sum", torch.float32),
                                      ("min", torch.float32),
                                      ("max", torch.float32),
                                      ("sum", torch.bfloat16)])
@pytest.mark.parametrize("m,n,d", [(1000, 300, 1), (513, 128, 4),
                                   (128, 700, 2), (200_000, 50, 1)])
def test_segment_reduce_kernel_equals_plain(cuda, op, dtype, m, n, d):
    """Sum to the f32/bf16 tolerances of the JAX package's kernel tests,
    min/max exactly; some ids lie outside [0, n) and match nothing."""
    rng = np.random.default_rng(m + n)
    ids = torch.as_tensor(rng.integers(-3, n + 3, m).astype(np.int32),
                          device=cuda)
    vals = torch.as_tensor(rng.normal(size=(m, d)).astype(np.float32),
                           device=cuda).to(dtype)
    if d == 1:
        vals = vals[:, 0].contiguous()
    before = segment_reduce.launches
    out = segment_reduce(ids, vals, n, op)
    torch.cuda.synchronize()
    assert segment_reduce.launches == before + 1
    ref = segment_reduce_ref(ids, vals, n, op)
    assert out.dtype == dtype and out.shape == ref.shape
    if op == "sum":
        tol = 1e-5 if dtype == torch.float32 else 5e-2
        atol = 1e-4 if dtype == torch.float32 else 5e-2
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                   atol=atol)
    else:
        assert torch.equal(out, ref)


def _run_ids(layout, rng):
    """Segment ids of a run layout, and the segment count: ``sorted``
    (destination order, a long hub run), ``unsorted`` (the same ids
    shuffled), ``one-run`` (one id over many 4,096-update tiles) and
    ``edges`` (runs ending one before, at and one after the 16-update
    thread, 512-update warp and 4,096-update tile boundaries); out-of-
    range ids lie inside runs."""
    n = 300
    if layout == "one-run":
        ids = np.full(50_000, 7)
    elif layout == "edges":
        lengths = np.array([15, 1, 16, 17, 511, 1, 513, 4095, 2, 4097,
                            8192, 3, 4096])
        ids = np.repeat(rng.permutation(n)[:len(lengths)], lengths)
    else:
        lengths = rng.integers(0, 60, n)
        lengths[5] = 20_000
        ids = np.repeat(np.arange(n), lengths)
    ids = ids.astype(np.int32)
    inside = rng.random(len(ids)) < 0.002
    ids[inside] = rng.choice([-1, n, n + 9], size=int(inside.sum()))
    if layout == "unsorted":
        ids = rng.permutation(ids)
    return ids, n


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("layout", ["sorted", "unsorted", "one-run",
                                    "edges"])
def test_segment_reduce_kernel_runs_equal_plain(cuda, layout, op, dtype, d):
    """The run-combining kernel on sorted and unsorted ids: sums to the
    tolerances of the JAX package's kernel tests, min/max exactly."""
    rng = np.random.default_rng(len(layout) * 10 + d)
    ids_np, n = _run_ids(layout, rng)
    ids = torch.as_tensor(ids_np, device=cuda)
    vals = torch.as_tensor(rng.normal(size=(len(ids_np), d)).astype(
        np.float32), device=cuda).to(dtype)
    if d == 1:
        vals = vals[:, 0].contiguous()
    before = segment_reduce.launches
    out = segment_reduce(ids, vals, n, op)
    torch.cuda.synchronize()
    assert segment_reduce.launches == before + 1
    ref = segment_reduce_ref(ids, vals, n, op)
    assert out.dtype == dtype and out.shape == ref.shape
    if op == "sum":
        tol = 1e-5 if dtype == torch.float32 else 5e-2
        atol = 1e-4 if dtype == torch.float32 else 5e-2
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                   atol=atol)
    else:
        assert torch.equal(out, ref)


@pytest.mark.parametrize("op", ["copy", "add", "mul"])
@pytest.mark.parametrize("m,q", [(500, 256), (77, 33), (300_000, 1000)])
def test_edge_scatter_kernel_equals_plain(cuda, op, m, q):
    """Bit for bit, out-of-range sources included."""
    rng = np.random.default_rng(m)
    src = torch.as_tensor(rng.integers(-2, q + 5, m).astype(np.int32),
                          device=cuda)
    w = torch.as_tensor(rng.normal(size=m).astype(np.float32), device=cuda)
    vals = torch.as_tensor(rng.normal(size=q).astype(np.float32),
                           device=cuda)
    act = torch.as_tensor((rng.random(q) < 0.5).astype(np.float32),
                          device=cuda)
    upd, valid = edge_scatter(src, w, vals, act, op)
    torch.cuda.synchronize()
    upd_p, valid_p = edge_scatter_ref(src, w, vals, act, op)
    assert torch.equal(upd, upd_p) and torch.equal(valid, valid_p)


@pytest.mark.parametrize("n,k,nx", [(256, 4, 256), (100, 7, 333),
                                    (513, 2, 128), (1000, 1, 500),
                                    (300, 16, 900), (70, 33, 400),
                                    (5, 1000, 3000), (3, 9000, 5000),
                                    (4, 0, 10)])
def test_spmv_ell_kernel_equals_plain(cuda, n, k, nx):
    """The row-major entry point (the kernel's uniform layout: a slice of
    32 rows, one thread a row) at narrow and wide k, a partly full slice
    and k = 0; padding ids with nonzero values add nothing."""
    rng = np.random.default_rng(n * 7 + k)
    cols = rng.integers(0, nx, (n, k)).astype(np.int32)
    pad = rng.random((n, k)) < 0.2
    cols[pad] = rng.choice([nx, nx + 7, -1], size=int(pad.sum()))
    vals = rng.normal(size=(n, k)).astype(np.float32)
    x = rng.normal(size=nx).astype(np.float32)
    args = [torch.as_tensor(a, device=cuda) for a in (cols, vals, x)]
    before = spmv_ell.launches
    y = spmv_ell(*args)
    torch.cuda.synchronize()
    assert spmv_ell.launches == before + 1
    torch.testing.assert_close(y, spmv_ell_ref(*args), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("heavy,chunk", [(32, 4096), (256, 100), (4, 3)])
def test_spmv_ell_buckets_equal_dense_on_card(cuda, heavy, chunk):
    """The one-launch pull over a sliced ELL packed on the card: the
    packer's tensors equal the CPU packer's, one launch a call, and y
    equals the plain version and a float64 product (heavy rows, rows with
    no in-edge and a partly full slice included)."""
    g = rmat(12, 8, seed=5)
    w = np.random.default_rng(1).random(g.m).astype(np.float32)
    x = np.random.default_rng(2).random(g.n).astype(np.float32)
    a = pack_in_edges(g.src, g.dst, g.n, w, device=cuda, heavy=heavy,
                      chunk=chunk)
    b = pack_in_edges(g.src, g.dst, g.n, w, heavy=heavy, chunk=chunk)
    for name in ("cols", "vals", "slice_ptr", "slice_rows", "chunk_ptr",
                 "chunk_rows"):
        assert torch.equal(getattr(a, name).cpu(), getattr(b, name)), name
    assert a.n_chunks > 0 and (g.in_degrees() == 0).any()
    xt = torch.as_tensor(x, device=cuda)
    before = spmv_ell.launches
    y = spmv_sell(a, xt)
    torch.cuda.synchronize()
    assert spmv_ell.launches == before + 1
    torch.testing.assert_close(y, spmv_sell_ref(a, xt), rtol=1e-5,
                               atol=1e-6)
    want = np.zeros(g.n)
    np.add.at(want, g.dst, w.astype(np.float64) * x[g.src])
    np.testing.assert_allclose(y.cpu().numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("accelerator", ["hitgraph", "accugraph"])
@pytest.mark.parametrize("problem", ["pr", "spmv"])
def test_stationary_simulate_on_card_equals_cpu(cuda, accelerator,
                                                problem):
    """The report is equal field for field; the values (the engines'
    float sums, in another order on the card) to rtol 1e-5; one gather
    (HitGraph) or one pull launch (AccuGraph) an iteration."""
    g = rmat(8, 5, seed=102).undirected_view()
    kw = dict(accelerator=accelerator, partition_elements=64,
              fixed_iters=3)
    assert simulate(g, problem, **kw) == simulate(g, problem,
                                                  device="cpu", **kw)
    engine, kernel = ((edge_centric.run, segment_reduce)
                      if accelerator == "hitgraph"
                      else (vertex_centric.run, spmv_ell))
    gw = g.with_unit_weights()
    before = kernel.launches
    a = engine(gw, Problem(problem), fixed_iters=3)
    assert kernel.launches == before + 3
    b = engine(gw, Problem(problem), fixed_iters=3, device="cpu")
    np.testing.assert_allclose(a.values, b.values, rtol=1e-5)


def _lookup_inputs(seed, U, W, n, big_tags, hot, device):
    """A set-sorted read stream over ``U`` sets (``hot`` of it on set 0)
    and a warm state, as ``lookup_reads`` builds them."""
    rng = np.random.default_rng(seed)
    row = np.where(rng.random(n) < hot, 0, rng.integers(0, U, n))
    base = 2**31 + 5 if big_tags else 0
    tag = base + rng.integers(0, 3 * W, n)
    order = np.argsort(row, kind="stable")
    seg_ptr = np.concatenate([[0], np.cumsum(np.bincount(row,
                                                         minlength=U))])
    tags = np.where(rng.random((U, W)) < 0.5, -1,
                    base + rng.permutation(3 * W)[:W][None, :])
    age = np.argsort(rng.random((U, W)), axis=1)
    return [torch.as_tensor(a, device=device) for a in (
        seg_ptr.astype(np.int64), tag[order].astype(np.int64),
        order.astype(np.int32), tags.astype(np.int64),
        age.astype(np.int64))]


@pytest.mark.parametrize("W", [1, 16, 64])
@pytest.mark.parametrize("big_tags", [False, True])
@pytest.mark.parametrize("hot", [0.0, 0.9])
def test_cache_lookup_kernel_equals_plain(cuda, W, big_tags, hot):
    """Hits and the updated state exact, at 1, 16 and 64 ways (one and
    two register slots a lane), with one hot set and tags >= 2**31."""
    from repro_torch.kernels.cache_lookup.ops import cache_lookup
    from repro_torch.kernels.cache_lookup.ref import cache_lookup_ref
    seg_ptr, tag, pos, tags, age = _lookup_inputs(W + int(big_tags), 37, W,
                                                  3000, big_tags, hot, cuda)
    tags_p, age_p = tags.cpu().clone(), age.cpu().clone()
    before = cache_lookup.launches
    hit = cache_lookup(seg_ptr, tag, pos, tags, age)
    torch.cuda.synchronize()
    assert cache_lookup.launches == before + 1
    want = cache_lookup_ref(seg_ptr.cpu(), tag.cpu(), pos.cpu(), tags_p,
                            age_p)
    assert torch.equal(hit.cpu(), want)
    assert torch.equal(tags.cpu(), tags_p) and torch.equal(age.cpu(), age_p)
    assert 0 < int(want.sum()) < len(want)


def test_cache_filter_on_card_equals_cpu(cuda):
    """``filter_program`` with the state on the card (the kernel) equals
    the CPU run, the chained state too."""
    from repro_torch.core import cache
    rng = np.random.default_rng(4)
    phases = []
    for p in range(5):
        n = int(rng.integers(50, 400))
        lines = np.where(rng.random(n) < 0.5, rng.integers(0, 300, n),
                         rng.integers(0, 1 << 14, n))
        phases.append((f"p{p}", lines, rng.random(n) < 0.2,
                       np.sort(rng.integers(0, 4 * n, n))))
    prog = SegmentedTrace.from_phases(phases)
    cfg = cache.CacheConfig(lines=256, ways=16, prefetch_degree=4)
    a, sa, st_a = cache.filter_program(prog, cfg, device=cuda)
    b, sb, st_b = cache.filter_program(prog, cfg, device="cpu")
    assert sa == sb and a.names == b.names
    for f in ("line_addr", "is_write", "issue", "offsets"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    assert torch.equal(st_a.tags.cpu(), st_b.tags)
    assert torch.equal(st_a.age.cpu(), st_b.age)
    ranges = [(10, 40), (1000, 300)]
    assert cache.invalidate_lines(st_a, cfg, ranges) == \
        cache.invalidate_lines(st_b, cfg, ranges)
    assert torch.equal(st_a.age.cpu(), st_b.age)


@pytest.mark.parametrize("preset", ["hitgraph", "accugraph", "hbm2"])
@pytest.mark.parametrize("hit_heavy", [False, True])
def test_device_pack_on_card_equals_host(cuda, preset, hit_heavy):
    cfg = PRESETS[preset]()
    prog = _program(7, hit_heavy)
    host = accel.pack_program(prog, cfg)
    dev = accel.pack_program_device(prog, cfg, device=cuda)
    assert dev.issue.device.type == "cuda"
    assert np.array_equal(dev.issue.cpu().numpy(), host.issue)
    assert np.array_equal(dev.meta.cpu().numpy(), host.meta)
    assert np.array_equal(dev.boundary.cpu().numpy(), host.boundary)
    assert np.array_equal(dev.kind.cpu().numpy()[:len(prog)], host.kind)
    assert np.array_equal(dev.open_row_final.cpu().numpy(),
                          host.open_row_final)
    assert dev.n_steps == host.n_steps
    assert accel.serve_packed(dev)[0] == accel.serve_packed(host,
                                                            device=cuda)[0]


@pytest.mark.parametrize("accelerator", ["hitgraph", "accugraph"])
def test_routes_and_launches_on_card(cuda, accelerator):
    """A run on the card packs on the card (never on the host), and a
    cached run goes through the lookup kernel (AccuGraph's vertex cache)
    and equals the CPU run."""
    from repro_torch.kernels import launch_counts, zero_launch_counts
    g = rmat(8, 5, seed=102).undirected_view()
    kw = dict(accelerator=accelerator, partition_elements=64,
              cache="default")
    accel.zero_pack_route_counts()
    zero_launch_counts()
    a = simulate(g, "wcc", **kw)
    routes, launches = accel.pack_route_counts(), launch_counts()
    assert routes == {"device_pack": 1, "host_pack": 0}
    assert launches["dram_serve"] == 1
    assert launches["cache_lookup"] == (accelerator == "accugraph")
    assert a == simulate(g, "wcc", device="cpu", **kw)
    accel.zero_pack_route_counts()
    res = run_dynamic(g, "wcc", updates="pa-growth", **kw)
    assert accel.pack_route_counts() == {"device_pack": res.n_epochs,
                                         "host_pack": 0}
    assert res.epochs == run_dynamic(g, "wcc", updates="pa-growth",
                                     device="cpu", **kw).epochs


@pytest.mark.parametrize("memory", ["ddr3", "ddr4", "hbm2", "ddr4-2rank",
                                    "ddr4-faw"])
def test_simulate_trace_device_equals_oracle_on_card(cuda, memory):
    """``simulate_trace_device`` on the card (one chunked ``dram_timing``
    launch) equals the host's element replay ``simulate_trace``: the
    finishes, the three kind counts and each channel's makespan."""
    from repro_torch.core.timing import simulate_trace
    from repro_torch.kernels import launch_counts, zero_launch_counts
    cfg = {"ddr3": PRESETS["hitgraph"], "ddr4": PRESETS["accugraph"],
           "hbm2": PRESETS["hbm2"],
           "ddr4-2rank": lambda: ddr4_2400r(channels=2, ranks=2),
           "ddr4-faw": PRESETS["accugraph"]}[memory]()
    bulk = memory == "ddr4-faw"
    rng = np.random.default_rng(len(memory) + 31)
    n = 20_000
    lines = rng.integers(0, 1 << 24 if bulk else 1 << 18, n)
    issue = (np.zeros(n, dtype=np.int64) if bulk
             else np.sort(rng.integers(0, 4 * n, n)))
    zero_launch_counts()
    got = vec.simulate_trace_device(Trace(lines, np.zeros(n, bool), issue),
                                    cfg, keep_finish=True)
    assert launch_counts()["dram_timing"] == 1
    want = simulate_trace(lines, issue, cfg, keep_finish=True)
    assert np.array_equal(got.finish, want.finish)
    assert (got.row_hits, got.row_empty, got.row_conflicts, got.cycles,
            got.per_channel_cycles) == (want.row_hits, want.row_empty,
                                        want.row_conflicts, want.cycles,
                                        want.per_channel_cycles)


@pytest.mark.parametrize("accelerator", ["hitgraph", "accugraph"])
@pytest.mark.parametrize("cache", [None, "vertex-1m"])
def test_event_backend_on_card_equals_vectorized(cuda, accelerator, cache):
    """``backend="event"`` with its cache state on the card (the lookup
    kernel) equals the vectorized run on the card and the CPU's event run;
    it launches no serve."""
    from repro_torch.kernels import launch_counts, zero_launch_counts
    g = rmat(8, 5, seed=102).undirected_view()
    kw = dict(accelerator=accelerator, partition_elements=64, cache=cache)
    zero_launch_counts()
    ev = simulate(g, "wcc", backend="event", **kw)
    launches = launch_counts()
    assert launches["dram_serve"] == launches["serve_prepass"] == 0
    assert (launches["cache_lookup"] > 0) == (cache is not None)
    assert ev == simulate(g, "wcc", **kw)
    assert ev == simulate(g, "wcc", backend="event", device="cpu", **kw)
    res = run_dynamic(g, "wcc", updates="pa-growth", backend="event", **kw)
    assert res.epochs == run_dynamic(g, "wcc", updates="pa-growth",
                                     device="cpu", **kw).epochs


@pytest.mark.parametrize("problem", ["wcc", "bfs"])
def test_reference_on_card_equals_cpu(cuda, problem):
    """The reference machine's algorithm runs on the card (the round
    sweep, never the serial one) and its report equals the CPU run."""
    from repro_torch.kernels import launch_counts, zero_launch_counts
    g = rmat(8, 5, seed=102).undirected_view()
    zero_launch_counts()
    r = simulate(g, problem, accelerator="reference")
    launches = launch_counts()
    assert launches["sweep_min_rounds"] > 0 and launches["sweep_min"] == 0
    assert r == simulate(g, problem, accelerator="reference", device="cpu")


def test_run_study_on_card_equals_cpu(cuda):
    from repro_torch.core import accugraph, optimizations
    g = rmat(8, 5, seed=102).undirected_view()
    base = accugraph.AccuGraphConfig(partition_elements=64)
    a = optimizations.run_study(g, Problem.WCC, base)
    b = optimizations.run_study(g, Problem.WCC, base, device="cpu")
    assert [(r.variant, r.report, r.speedup) for r in a] == \
        [(r.variant, r.report, r.speedup) for r in b]


def _batch_timings(M, seed):
    rng = np.random.default_rng(seed)
    t = rng.integers(1, 40, size=(M, 7)).astype(np.int32)
    t[:, 4] = rng.integers(1, 5, size=M)
    return torch.from_numpy(t)


@pytest.mark.parametrize("preset", ["hitgraph", "accugraph"])
@pytest.mark.parametrize("hit_heavy", [False, True])
@pytest.mark.parametrize("M", [1, 3, 133])
@pytest.mark.parametrize("shared", [True, False])
def test_dram_serve_batch_equals_plain(cuda, preset, hit_heavy, M, shared):
    """The batched serve against its plain version on the card, bit for
    bit: one shared program, or M stacked programs whose phase boundaries
    fall on different steps, each case with its own timing vector."""
    from repro_torch.kernels.dram_timing.ops import (dram_serve_batch,
                                                     serve_prepass_batch)
    from repro_torch.kernels.dram_timing.ref import dram_serve_batch_ref
    cfg = PRESETS[preset]()
    n = 1 if shared else min(M, 5)
    packs = [accel.pack_program(_program(11 + i, hit_heavy, 3, 60), cfg)
             for i in range(n)]
    assert len({p.issue.shape for p in packs}) == 1
    if shared:
        streams = [torch.as_tensor(np.asarray(getattr(packs[0], f),
                                              dtype=np.int32), device=cuda)
                   for f in ("issue", "meta", "boundary")]
    else:
        assert len({tuple(np.flatnonzero(p.boundary)) for p in packs}) == n
        packs = [packs[i % n] for i in range(M)]
        streams = [torch.as_tensor(np.stack([np.asarray(getattr(p, f),
                                                        dtype=np.int32)
                                             for p in packs]), device=cuda)
                   for f in ("issue", "meta", "boundary")]
    timing = _batch_timings(M, len(preset) + M).to(cuda)
    state = vec._cold_batch_state(M, cfg.channels, packs[0].n_banks,
                                  packs[0].banks_per_rank, cuda)
    before = (dram_serve_batch.launches, serve_prepass_batch.launches,
              dram_serve.launches)
    fin_k, st_k = dram_serve_batch(*streams, timing, state)
    torch.cuda.synchronize()
    assert (dram_serve_batch.launches, serve_prepass_batch.launches,
            dram_serve.launches) == (before[0] + 1, before[1] + 1,
                                     before[2])
    fin_p, st_p = dram_serve_batch_ref(*streams, timing, state)
    assert torch.equal(fin_k, fin_p)
    for a, b in zip(st_k, st_p):
        assert torch.equal(a, b)



@pytest.mark.parametrize("preset", ["hitgraph", "accugraph"])
@pytest.mark.parametrize("M", [1, 3])
def test_serve_records_equal_plain(cuda, preset, M):
    """The serve's carry chain alone, single and batched, against its
    plain record walk (``serve_records_ref``, ``serve_records_batch_ref``)
    on the card's own records, bit for bit, from a warm carry, one launch
    counted a call."""
    from repro_torch.kernels.dram_timing.ops import (serve_prepass_batch,
                                                     serve_records_batch)
    from repro_torch.kernels.dram_timing.ref import (serve_records_batch_ref,
                                                     serve_records_ref)
    cfg = PRESETS[preset]()
    packed = accel.pack_program(_program(21 + M, False, 4, 200), cfg)
    streams = [torch.as_tensor(np.asarray(a, dtype=np.int32), device=cuda)
               for a in (packed.issue, packed.meta, packed.boundary)]
    S, C, K = packed.issue.shape
    B, Rk = packed.n_banks, packed.n_banks // packed.banks_per_rank
    T = chunk_steps(C, K)
    timing = _batch_timings(M, 5 + M).to(cuda)
    cold = vec._cold_batch_state(M, C, B, packed.banks_per_rank, cuda)
    half = S // 2
    warm = dram_serve_batch_ref(*(x[:half].contiguous() for x in streams),
                                timing, cold)[1]
    rest = [x[half:].contiguous() for x in streams]
    rec = serve_prepass_batch(*rest, timing, packed.banks_per_rank, Rk, T)
    before = (dram_serve.launches, dram_serve_batch.launches)
    fin_k, st_k = serve_records_batch(rec, timing, warm, S - half)
    fin_p, st_p = serve_records_batch_ref(rec, timing, warm, S - half)
    assert torch.equal(fin_k, fin_p)
    assert all(torch.equal(a, b) for a, b in zip(st_k, st_p))
    case = tuple(x[M - 1] for x in warm)
    fin_k, st_k = serve_records(rec[M - 1], timing[M - 1], case, S - half)
    fin_p, st_p = serve_records_ref(rec[M - 1], timing[M - 1], case,
                                    S - half)
    torch.cuda.synchronize()
    assert (dram_serve.launches, dram_serve_batch.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(fin_k, fin_p)
    assert all(torch.equal(a, b) for a, b in zip(st_k, st_p))


def test_dram_serve_batch_checks_on_card(cuda):
    from repro_torch.kernels.dram_timing.ops import dram_serve_batch
    cfg = PRESETS["hitgraph"]()
    p = accel.pack_program(_program(3, False, 2, 60), cfg)
    issue, meta, bnd = (torch.as_tensor(np.asarray(a, dtype=np.int32),
                                        device=cuda)
                        for a in (p.issue, p.meta, p.boundary))
    timing = _batch_timings(2, 0).to(cuda)
    state = vec._cold_batch_state(2, cfg.channels, p.n_banks,
                                  p.banks_per_rank, cuda)
    bad = issue.clone()
    bad[0, 0, 0] = vec.MAX_PHASE_ISSUE
    with pytest.raises(ValueError, match="int32 range"):
        dram_serve_batch(bad, meta, bnd, timing, state)
    ptr = tuple(x.clone() for x in state)
    ptr[4][0, 0, 0] = -1
    with pytest.raises(ValueError, match="pointers"):
        dram_serve_batch(issue, meta, bnd, timing, ptr)
    with pytest.raises(ValueError, match="cases"):
        dram_serve_batch(issue[None].expand(3, -1, -1, -1).contiguous(),
                         meta[None].expand(3, -1, -1, -1).contiguous(),
                         bnd[None].expand(3, -1).contiguous(), timing,
                         state)
    with pytest.raises(ValueError, match="tensors on"):
        dram_serve_batch(issue, meta, bnd.cpu(), timing, state)


@pytest.mark.parametrize("batch_memories", [True, False])
def test_sweep_on_card_equals_cpu(cuda, batch_memories):
    """A timing grid (one shared pack an accelerator), a density grid and
    a clock pair (HitGraph's default memory and DDR3-1333H, stacked packs
    of one shape) on the card, rows equal to the CPU sweep's; the batched
    sweep serves through ``dram_serve_batch`` alone."""
    import dataclasses
    from repro_torch.kernels import launch_counts, zero_launch_counts
    from repro_torch.sim import (TIMING_PRESETS, Sweeper, get_accelerator,
                                 sweep, timing_variants)
    from repro_torch.sim.session import resolve_run_config
    g = rmat(8, 5, seed=7).undirected_view()
    default = resolve_run_config(get_accelerator("hitgraph")).dram_config()
    slower = dataclasses.replace(default, clock_ghz=2 / 3,
                                 timing=TIMING_PRESETS["ddr3-1333"],
                                 name=f"{default.name}@ddr3-1333")
    grids = [dict(accelerators=["hitgraph", "accugraph"],
                  memories=[None] + timing_variants(
                      "ddr4", kinds=("ddr3", "hbm2"))),
             dict(accelerators=["accugraph"], memories=[None, "ddr4-8gb"]),
             dict(accelerators=["hitgraph"], memories=[None, slower])]
    for kw in grids:
        zero_launch_counts()
        sw = Sweeper(batch_memories=batch_memories, workers=2)
        rows = sweep(graphs=[g], problems=["wcc"], sweeper=sw, **kw)
        launches = launch_counts()
        want = sweep(graphs=[g], problems=["wcc"], device="cpu",
                     batch_memories=batch_memories, **kw)
        assert [r.report for r in rows] == [r.report for r in want]
        if batch_memories:
            assert launches["dram_serve_batch"] == \
                sw.stats.batch_dispatches
            assert launches["dram_serve"] == 0
        else:
            assert launches["dram_serve_batch"] == 0
            assert launches["dram_serve"] == len(rows)


def test_corpus_names_on_card_equal_cpu(cuda, monkeypatch):
    """Corpus names on the card: ``simulate("karate", "wcc")`` and a sweep
    over two presets (one with an ordering suffix) equal the CPU port's
    reports, and the card's run launched the serve."""
    from repro_torch.kernels import launch_counts, zero_launch_counts
    from repro_torch.sim import ScenarioSpec, sweep
    monkeypatch.setenv("REPRO_GRAPH_CACHE", "0")
    zero_launch_counts()
    a = simulate("karate", "wcc")
    assert launch_counts()["dram_serve"] == 1
    assert a == simulate("karate", "wcc", device="cpu")
    assert simulate(ScenarioSpec("karate", "wcc")) == a
    kw = dict(graphs=["karate", "road-grid:bfs"], problems=["wcc", "pr"],
              accelerators=["hitgraph", "accugraph"], graph_scale=0.01)
    rows = sweep(**kw)
    want = sweep(device="cpu", **kw)
    assert [r.graph_name for r in rows] == [r.graph_name for r in want]
    assert [r.report for r in rows] == [r.report for r in want]


def test_service_on_card_equals_cpu(cuda, monkeypatch):
    """A karate job through ``SimService()`` on the card launches the serve
    and its rows equal the ``device="cpu"`` service's; a small search
    through ``SearchDriver(space)`` on the card finds the CPU's front."""
    from repro_torch.kernels import launch_counts, zero_launch_counts
    from repro_torch.serve import SimService
    from repro_torch.sim import SweepCase, get_accelerator
    from repro_torch.tune import HalvingBudget, SearchDriver
    monkeypatch.setenv("REPRO_GRAPH_CACHE", "0")
    cases = [SweepCase("karate", p) for p in ("wcc", "bfs", "pr")]
    zero_launch_counts()
    with SimService(workers=2) as svc:
        rows = svc.result(svc.submit(cases), timeout=120)
    launches = launch_counts()
    with SimService(workers=2, device="cpu") as svc:
        want = svc.result(svc.submit(cases), timeout=120)
    assert launches["dram_serve"] == len(cases)
    assert [r.report for r in rows] == [r.report for r in want]
    space = get_accelerator("hitgraph").design_space().restrict(
        n_pes=["1", "4"], pipelines=["8"], memory=["ddr3", "hbm2"],
        cache=["none", "prefetch-8"])
    budget = HalvingBudget(rungs=(1, 2), initial=6, keep=0.5)
    zero_launch_counts()
    res = SearchDriver(space, seed=7, budget=budget).search("karate", "bfs")
    assert launch_counts()["dram_serve_batch"] > 0
    cpu = SearchDriver(space, seed=7, budget=budget,
                       device="cpu").search("karate", "bfs")
    assert res.front_keys() == cpu.front_keys()
    assert [e.objectives for e in res.front] == [e.objectives
                                                for e in cpu.front]


def test_threaded_session_under_the_witness_on_card(cuda, monkeypatch):
    """chip_smoke's phase 13 part (a) at a small size: a cold session on
    rmat(10, 4) taking 16 WCC runs (HitGraph and AccuGraph, mixed order)
    from 8 threads under ``REPRO_ANALYSIS_LOCKS=1``; every report equal to
    a serial run's, one serve launch (and one pre-pass) a run, no hazard
    recorded."""
    import sys
    from pathlib import Path
    from repro_torch.analysis import locks
    from repro_torch.kernels import launch_counts, zero_launch_counts
    from repro_torch.sim import SimSession
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    g = rmat(10, 4, seed=12).undirected_view()
    want = {acc: SimSession(g).run("wcc", acc, device=cuda)
            for acc in ("hitgraph", "accugraph")}
    monkeypatch.setenv(locks.ENV_FLAG, "1")
    locks.reset()
    zero_launch_counts()
    out = chip_smoke.threaded_session_runs(g, want, cuda, runs=16,
                                           threads=8)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert (counts["dram_serve"], counts["serve_prepass"]) == (16, 16)
    assert out["algo_runs"] == 2 and locks.made() == {"session": 1}
    assert locks.findings() == []
    locks.reset()
