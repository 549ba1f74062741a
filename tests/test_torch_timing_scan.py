"""The chunked max-plus form of the per-channel DRAM timing scan
(``repro_torch.kernels.dram_timing.ref.dram_timing_chunked_ref``, the plain
version of ``csrc/dram_timing.cu``) against the plain per-slot scan
``dram_timing_ref`` and the JAX package's ``_channel_scan`` (through
``repro.core.vectorized._simulate_packed``), bit for bit: every preset, two
ranks, the bulk trace that binds the four-ACT window, invalid holes,
chunks without a valid slot, chunk lengths T in {1, 2, 7, 64}, warm
carries chained across two calls; and the int32 range check."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import vectorized as r_vec
from repro.core.dram import PRESETS as R_PRESETS
from repro.core.dram import ddr3_1600k as r_ddr3
from repro.core.dram import ddr4_2400r as r_ddr4
from repro.core.trace import Trace as RTrace

from repro_torch import interop
from repro_torch.core import vectorized as vec
from repro_torch.kernels.dram_timing.ops import (dram_timing,
                                                 dram_timing_chunks)
from repro_torch.kernels.dram_timing.ref import (dram_timing_chunked_ref,
                                                 dram_timing_ref,
                                                 timing_state_width)

MEMORIES = dict(R_PRESETS, **{
    "ddr3-1ch-2rank": lambda: r_ddr3(channels=1, ranks=2),
    "ddr4-2ch-2rank": lambda: r_ddr4(channels=2, ranks=2)})
CHUNKS = (1, 2, 7, 64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _streams(r_cfg, rng, n=400, bulk=False, holes=0.0):
    """Per-channel streams of a random trace; ``bulk`` issues everything
    at cycle 0 over many rows (the tFAW window binds); ``holes`` drops
    that share of the valid slots."""
    span = 1 << 24 if bulk else 1 << 14
    lines = rng.integers(0, span, n)
    issue = (np.zeros(n, dtype=np.int64) if bulk
             else np.sort(rng.integers(0, 4 * n, n)))
    packed = vec.pack_channels(
        interop.trace(RTrace(lines, np.zeros(n, dtype=bool), issue)),
        interop.dram_config(r_cfg))
    valid = packed.valid & (rng.random(packed.valid.shape) >= holes)
    return [packed.issue, packed.bank, packed.row, valid]


def _cold(r_cfg):
    return vec.init_channel_carry(r_cfg.channels, r_cfg.banks_per_channel,
                                  r_cfg.org.banks, "cpu")


def _timing(r_cfg):
    return vec.timing_params(interop.dram_config(r_cfg).timing)


def _assert_same(got, want):
    fin, kind, carry = got
    assert fin.dtype == torch.int32 and kind.dtype == torch.int8
    assert torch.equal(fin, want[0]) and torch.equal(kind, want[1])
    assert len(carry) == 7
    for a, b in zip(carry, want[2]):
        assert a.dtype == torch.int32 and torch.equal(a, b)


def _jax(r_cfg, arrays, t, carry=None):
    B, bpr = r_cfg.banks_per_channel, r_cfg.org.banks
    fin, kind, carry = r_vec._simulate_packed(
        *(jnp.asarray(a) for a in arrays), jnp.asarray(t), B, bpr, carry)
    return (_t(fin), _t(kind), tuple(_t(x) for x in carry))


@pytest.mark.parametrize("memory", sorted(MEMORIES))
@pytest.mark.parametrize("T", CHUNKS)
def test_chunked_vs_plain_and_jax(memory, T):
    """Every preset and two 2-rank memories, with invalid holes: the
    chunked form equals the per-slot scan and the JAX scan."""
    r_cfg = MEMORIES[memory]()
    rng = np.random.default_rng(sum(map(ord, memory)) + T)
    arrays = _streams(r_cfg, rng, holes=0.15)
    t = _timing(r_cfg)
    args = [_t(a) for a in arrays]
    got = dram_timing_chunked_ref(*args, _t(t), _cold(r_cfg), T)
    _assert_same(got, dram_timing_ref(*args, _t(t), _cold(r_cfg)))
    _assert_same(got, _jax(r_cfg, arrays, t))


@pytest.mark.parametrize("T", CHUNKS)
def test_chunked_faw_window(T):
    """The bulk trace, whose ACTs queue on the four-ACT window: equal to
    the JAX scan, and tFAW really binds (without it the finishes
    change)."""
    r_cfg = r_ddr4(ranks=2)
    arrays = _streams(r_cfg, np.random.default_rng(8), n=300, bulk=True)
    t = _timing(r_cfg)
    args = [_t(a) for a in arrays]
    got = dram_timing_chunked_ref(*args, _t(t), _cold(r_cfg), T)
    _assert_same(got, _jax(r_cfg, arrays, t))
    no_faw = t.copy()
    no_faw[6] = 0
    other = dram_timing_chunked_ref(*args, _t(no_faw), _cold(r_cfg), T)
    assert not torch.equal(got[0], other[0])


@pytest.mark.parametrize("T", CHUNKS)
def test_chunked_empty_chunks(T):
    """Long runs of invalid slots (whole chunks with no valid slot, a
    phase whose length is no multiple of T) and a rank with no slot in
    some chunks."""
    r_cfg = r_ddr3(channels=2, ranks=2)
    arrays = _streams(r_cfg, np.random.default_rng(21), n=200)
    L = arrays[0].shape[1]
    keep = np.zeros(L, dtype=bool)
    keep[:L // 5] = True
    keep[L // 2:L // 2 + 9] = True
    arrays[3] = arrays[3] & keep
    # channel 1's slots all go to rank 0's banks
    arrays[1][1] %= r_cfg.org.banks
    t = _timing(r_cfg)
    args = [_t(a) for a in arrays]
    got = dram_timing_chunked_ref(*args, _t(t), _cold(r_cfg), T)
    _assert_same(got, _jax(r_cfg, arrays, t))


@pytest.mark.parametrize("T", CHUNKS)
@pytest.mark.parametrize("memory", ["hitgraph", "accugraph"])
def test_chunked_warm_carry_chained(memory, T):
    """Two phases, the second entered with the first's carry (open rows,
    ACT ring mid-way), each split in two chained calls: equal to the JAX
    scan carried across the phases."""
    r_cfg = MEMORIES[memory]()
    rng = np.random.default_rng(40 + T)
    t = _timing(r_cfg)
    carry, r_carry = _cold(r_cfg), None
    for span_holes in (0.0, 0.3):
        arrays = _streams(r_cfg, rng, n=300, holes=span_holes)
        want = _jax(r_cfg, arrays, t, r_carry)
        r_carry = tuple(jnp.asarray(x.numpy()) for x in want[2])
        h = arrays[0].shape[1] // 2 + 1
        fins, kinds = [], []
        for lo, hi in ((0, h), (h, arrays[0].shape[1])):
            f, k, carry = dram_timing_chunked_ref(
                *(_t(a[:, lo:hi]) for a in arrays), _t(t), carry, T)
            fins.append(f)
            kinds.append(k)
        _assert_same((torch.cat(fins, 1), torch.cat(kinds, 1), carry), want)


def test_chunked_single_slot_and_all_invalid():
    r_cfg = r_ddr4()
    t = _t(_timing(r_cfg))
    one = [np.array([[5]], np.int32), np.array([[3]], np.int32),
           np.array([[9]], np.int32), np.array([[True]])]
    none = [a.repeat(6, 1) for a in one[:3]] + [np.zeros((1, 6), bool)]
    carry = _cold(r_cfg)
    for arrays in (one, none):
        args = [_t(a) for a in arrays]
        for T in CHUNKS:
            got = dram_timing_chunked_ref(*args, t, carry, T)
            _assert_same(got, dram_timing_ref(*args, t, carry))
            _assert_same(got, _jax(r_cfg, arrays, t.numpy(), tuple(
                jnp.asarray(x.numpy()) for x in carry)))
        carry = got[2]
    # the all-invalid phase leaves the carry as it was
    _assert_same(dram_timing_chunked_ref(*args, t, carry, 7),
                 (torch.zeros((1, 6), dtype=torch.int32),
                  torch.full((1, 6), -1, dtype=torch.int8), carry))


def test_chunked_range_check_raises():
    """A carry whose bus time sits just below 2**31: the int32 scan wraps
    the finish to a negative cycle, the chunked form (int64) raises."""
    r_cfg = r_ddr4()
    carry = list(_cold(r_cfg))
    carry[3] = torch.tensor([2**31 - 3], dtype=torch.int32)
    arrays = [_t(a) for a in (np.array([[0, 1]], np.int32),
                              np.array([[0, 1]], np.int32),
                              np.array([[7, 7]], np.int32),
                              np.array([[True, True]]))]
    t = _t(_timing(r_cfg))
    fin, _, _ = dram_timing_ref(*arrays, t, tuple(carry))
    assert int(fin.min()) < 0
    for T in (1, 64):
        with pytest.raises(ValueError, match="int32"):
            dram_timing_chunked_ref(*arrays, t, tuple(carry), T)
    with pytest.raises(ValueError, match="int32"):
        dram_timing_chunks(*arrays, t, tuple(carry), 64)
    # a warm carry that stays in range does not trip it
    carry[3] = torch.tensor([2**31 - 2**26], dtype=torch.int32)
    _assert_same(dram_timing_chunked_ref(*arrays, t, tuple(carry), 1),
                 dram_timing_ref(*arrays, t, tuple(carry)))


def test_dram_timing_chunks_cpu_path_is_the_plain_version():
    """For CPU tensors ``dram_timing_chunks`` runs the plain chunked
    version and counts no launch; ``dram_timing`` the per-slot one; a
    chunk length the kernel is not built for is refused."""
    r_cfg = MEMORIES["hitgraph"]()
    args = [_t(a) for a in _streams(r_cfg, np.random.default_rng(2))]
    t = _t(_timing(r_cfg))
    before = dram_timing.launches
    fin, kind, carry, ms = dram_timing_chunks(*args, t, _cold(r_cfg), 64,
                                              time_passes=True)
    assert ms is None and dram_timing.launches == before
    _assert_same((fin, kind, carry), dram_timing(*args, t, _cold(r_cfg)))
    with pytest.raises(ValueError):
        dram_timing_chunks(*args, t, _cold(r_cfg), 100)


def test_state_width():
    """D = 2 * banks_per_rank + 6: 22 for DDR3, 38 for DDR4 and HBM2."""
    assert [timing_state_width(R_PRESETS[k]().org.banks)
            for k in ("hitgraph", "accugraph", "hbm2")] == [22, 38, 38]


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), T=st.sampled_from([1, 3, 8, 64]),
       channels=st.integers(1, 2), ranks=st.integers(1, 2),
       n=st.integers(1, 250), span=st.sampled_from([1 << 6, 1 << 12,
                                                     1 << 20]),
       holes=st.sampled_from([0.0, 0.5]),
       timing=st.tuples(*(st.integers(0, 40) for _ in range(7))))
def test_property_chunked_any_timing(seed, T, channels, ranks, n, span,
                                     holes, timing):
    """Any timing parameters (0..40 cycles each), trace shape, chunk
    length and valid mask, from a warm carry left by a first phase: the
    chunked form equals the per-slot scan."""
    base = r_ddr4(channels=channels, ranks=ranks)
    r_cfg = dataclasses.replace(base, timing=dataclasses.replace(
        base.timing, **dict(zip(vec.TIMING_FIELDS, timing))))
    rng = np.random.default_rng(seed)
    t = _t(np.array(timing, dtype=np.int32))
    lines = rng.integers(0, span, n)
    issue = np.sort(rng.integers(0, 4 * n, n))
    packed = vec.pack_channels(
        interop.trace(RTrace(lines, np.zeros(n, dtype=bool), issue)),
        interop.dram_config(r_cfg))
    args = [_t(a) for a in (packed.issue, packed.bank, packed.row,
                            packed.valid & (rng.random(packed.valid.shape)
                                            >= holes))]
    warm = dram_timing_ref(*args, t, _cold(r_cfg))[2]
    _assert_same(dram_timing_chunked_ref(*args, t, warm, T),
                 dram_timing_ref(*args, t, warm))


def _growth(t):
    """The most one request can add to a channel's makespan, from a state
    the scan itself produced: a conflict (tRAS or tRCD + tBL, then tRP),
    the four-ACT window, or a hit."""
    return max(t.tRAS + t.tRP, t.tRP + t.tRCD + t.tBL, t.tFAW, t.tRRD,
               t.tBL)


@pytest.mark.parametrize("memory", sorted(R_PRESETS))
def test_paths_phase_lengths_cannot_wrap(memory):
    """Where the per-phase path can reach the int32 range check: a phase
    starts below ``MAX_PHASE_ISSUE`` (issues and carry, else the path
    re-bases), and each request adds at most ``_growth`` cycles, so a
    channel needs more than ``2**26 / _growth`` requests to wrap, beyond
    the paths' largest rewrite phase (2**20 slots a channel).  Checked on
    the worst chain the bound allows: every request a conflict on one
    bank, all issued at once, from a warm carry just below the limit."""
    r_cfg = R_PRESETS[memory]()
    t = interop.dram_config(r_cfg).timing
    g = _growth(t)
    assert (1 << 20) * g + t.tCL < (1 << 31) - vec.MAX_PHASE_ISSUE
    n = 300
    start = vec.MAX_PHASE_ISSUE - 1
    arrays = [np.full((1, n), start, np.int32), np.zeros((1, n), np.int32),
              (np.arange(n, dtype=np.int32) % 2)[None] + 1,
              np.ones((1, n), bool)]
    B, bpr = r_cfg.banks_per_channel, r_cfg.org.banks
    carry = list(vec.init_channel_carry(1, B, bpr, "cpu"))
    carry[3] = torch.tensor([start], dtype=torch.int32)
    fin, kind, _ = dram_timing_chunked_ref(*(_t(a) for a in arrays),
                                           _t(_timing(r_cfg)), tuple(carry),
                                           64)
    assert int((kind == 2).sum()) == n - 1
    assert int(fin.max()) - start <= n * g + t.tCL
