"""The port's element-granular DRAM timing oracle (``repro_torch.core.
timing``) and its kernel-backed counterpart ``simulate_trace_device``
against the JAX package, on the CPU.

* ``ChannelState.serve``, ``simulate_channel`` and ``simulate_trace``
  (``keep_finish`` included) against ``repro.core.timing`` on seeded
  DDR3, DDR4, HBM2 and two-rank traces, and on the traces of
  ``tests/test_dram_timing.py``'s oracle properties;
* ``ChannelState.serve_many`` (the event backend's loop) against
  ``serve``, state included; ``DRAMConfig.line_decoder`` (the abstraction
  graph's scalar decode) against ``decode_lines``;
* ``simulate_trace_device(device="cpu")`` (one ``dram_timing`` call)
  against ``repro``'s ``simulate_trace_jax`` and the port's
  ``simulate_trace``.

Every field is an integer or the same float operation on equal integers:
all comparisons are exact.
"""

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import timing as r_timing
from repro.core.dram import PRESETS as R_PRESETS
from repro.core.dram import ddr3_1600k as r_ddr3
from repro.core.dram import ddr4_2400r as r_ddr4
from repro.core.dram import hbm2 as r_hbm2
from repro.core.trace import Trace as RTrace
from repro.core.vectorized import simulate_trace_jax

from repro_torch import interop
from repro_torch.core import timing
from repro_torch.core.dram import PRESETS, ddr3_1600k, ddr4_2400r, hbm2e
from repro_torch.core.trace import Trace, bulk_issue
from repro_torch.core.vectorized import simulate_trace_device

#: DDR3 (4 channels, 2 ranks), DDR4, HBM2 (8 channels) and two-rank DDR4
MEMORIES = {"ddr3": lambda: r_ddr3(), "ddr4": lambda: r_ddr4(),
            "hbm2": lambda: r_hbm2(),
            "ddr4-2rank": lambda: r_ddr4(channels=2, ranks=2)}

_FIELDS = [f.name for f in dataclasses.fields(timing.TraceResult)
           if f.name != "finish"]


def _random(rng, n, span=1 << 20, bulk=False):
    lines = rng.integers(0, span, n)
    issue = (np.zeros(n, dtype=np.int64) if bulk
             else np.sort(rng.integers(0, 4 * n, n)))
    return lines, issue


def _assert_result_equal(got, want):
    """Every field of two TraceResults, the finishes too."""
    for f in _FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    if want.finish is None:
        assert got.finish is None
    else:
        assert got.finish.dtype == np.int64
        np.testing.assert_array_equal(got.finish, want.finish)


@pytest.mark.parametrize("mem", sorted(MEMORIES))
@pytest.mark.parametrize("bulk", [False, True])
def test_simulate_trace_vs_jax(mem, bulk):
    r_cfg = MEMORIES[mem]()
    cfg = interop.dram_config(r_cfg)
    lines, issue = _random(np.random.default_rng(len(mem) + 7 * bulk),
                           1500, span=1 << 24 if bulk else 1 << 20,
                           bulk=bulk)
    for keep in (False, True):
        got = timing.simulate_trace(lines, issue, cfg, keep_finish=keep)
        want = interop.trace_result(r_timing.simulate_trace(
            lines, issue, r_cfg, keep_finish=keep))
        _assert_result_equal(got, want)
    assert got.peak_gbps == r_cfg.peak_gbps
    assert got.hit_rate == want.hit_rate
    assert got.bandwidth_fraction == want.bandwidth_fraction


@pytest.mark.parametrize("mem", sorted(MEMORIES))
def test_channel_state_and_simulate_channel_vs_jax(mem):
    """One channel's stream request by request: finish, kind and every
    state array after each request."""
    r_cfg = MEMORIES[mem]()
    cfg = interop.dram_config(r_cfg)
    rng = np.random.default_rng(3)
    n = 600
    issue = np.sort(rng.integers(0, 3 * n, n))
    bank = rng.integers(0, cfg.banks_per_channel, n)
    row = rng.integers(0, 6, n)
    st_ = timing.ChannelState(cfg.timing, cfg.banks_per_channel,
                              cfg.org.banks)
    r_st = r_timing.ChannelState(r_cfg.timing, r_cfg.banks_per_channel,
                                 r_cfg.org.banks)
    for i in range(n):
        args = (int(issue[i]), int(bank[i]), int(row[i]))
        assert st_.serve(*args) == r_st.serve(*args)
    for f in ("open_row", "act_time", "bank_avail", "act_hist", "act_ptr",
              "last_act_rank"):
        np.testing.assert_array_equal(getattr(st_, f), getattr(r_st, f))
    assert st_.bus_free == r_st.bus_free
    fin, kind = timing.simulate_channel(issue, bank, row, cfg.timing,
                                        cfg.banks_per_channel,
                                        cfg.org.banks)
    r_fin, r_kind = r_timing.simulate_channel(
        issue, bank, row, r_cfg.timing, r_cfg.banks_per_channel,
        r_cfg.org.banks)
    assert fin.dtype == r_fin.dtype and kind.dtype == r_kind.dtype
    np.testing.assert_array_equal(fin, r_fin)
    np.testing.assert_array_equal(kind, r_kind)


@pytest.mark.parametrize("mem", sorted(MEMORIES))
def test_serve_many_equals_serve(mem):
    """The event backend's stream loop: the same finishes, kinds and
    state as ``serve`` request by request, chained across two calls from
    a warm state."""
    cfg = interop.dram_config(MEMORIES[mem]())
    rng = np.random.default_rng(11)
    a = timing.ChannelState(cfg.timing, cfg.banks_per_channel,
                            cfg.org.banks)
    b = timing.ChannelState(cfg.timing, cfg.banks_per_channel,
                            cfg.org.banks)
    start = 0
    for n in (700, 500):
        issue = start + np.sort(rng.integers(0, 2 * n, n))
        bank = rng.integers(0, cfg.banks_per_channel, n)
        row = rng.integers(0, 8, n)
        want = [a.serve(int(i), int(k), int(r))
                for i, k, r in zip(issue, bank, row)]
        fin, kind = b.serve_many(issue.tolist(), bank.tolist(), row.tolist())
        assert list(zip(fin, kind)) == want
        start = int(issue[-1])
    for f in ("open_row", "act_time", "bank_avail", "act_hist", "act_ptr",
              "last_act_rank"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(b, f).dtype == np.int64
    assert a.bus_free == b.bus_free


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_line_decoder_equals_decode_lines(preset):
    cfg = PRESETS[preset]()
    for order in (cfg.order, ("row", "bank", "column", "rank", "channel")):
        c = dataclasses.replace(cfg, order=order)
        lines = np.concatenate([
            np.arange(5000),
            np.random.default_rng(1).integers(0, 1 << 40, 5000),
            np.array([(1 << 62) + 12345, -1, -77])])
        comps = c.decode_lines(lines)
        decode = c.line_decoder()
        got = np.array([decode(int(x)) for x in lines])
        np.testing.assert_array_equal(got[:, 0], comps["channel"])
        np.testing.assert_array_equal(got[:, 1], comps["bank_in_channel"])
        np.testing.assert_array_equal(got[:, 2], comps["row"])


def test_line_decoder_non_power_of_two():
    cfg = dataclasses.replace(
        ddr4_2400r(), channels=3,
        org=dataclasses.replace(ddr4_2400r().org, rows=1000))
    lines = np.random.default_rng(2).integers(0, 1 << 36, 4000)
    comps = cfg.decode_lines(lines)
    got = np.array([cfg.line_decoder()(int(x)) for x in lines])
    np.testing.assert_array_equal(got[:, 0], comps["channel"])
    np.testing.assert_array_equal(got[:, 1], comps["bank_in_channel"])
    np.testing.assert_array_equal(got[:, 2], comps["row"])


@pytest.mark.parametrize("preset", sorted(R_PRESETS))
def test_simulate_trace_device_vs_jax(preset):
    r_cfg = R_PRESETS[preset]()
    cfg = interop.dram_config(r_cfg)
    rng = np.random.default_rng(42)
    n = 1200
    lines, issue = _random(rng, n)
    r_tr = RTrace(lines, np.zeros(n, bool), issue)
    got = simulate_trace_device(interop.trace(r_tr), cfg, keep_finish=True,
                                device="cpu")
    want = interop.trace_result(simulate_trace_jax(r_tr, r_cfg,
                                                   keep_finish=True))
    _assert_result_equal(got, want)
    _assert_result_equal(got, timing.simulate_trace(lines, issue, cfg,
                                                    keep_finish=True))


@pytest.mark.parametrize("mem", sorted(MEMORIES))
def test_simulate_trace_device_vs_oracle(mem):
    """Both halves of the trace line of chip_smoke at a small size: the
    bulk trace that trips tFAW and a random one, with and without the
    finishes."""
    cfg = interop.dram_config(MEMORIES[mem]())
    for bulk in (False, True):
        lines, issue = _random(np.random.default_rng(5 + bulk), 900,
                               span=1 << 24 if bulk else 1 << 16, bulk=bulk)
        tr = Trace(lines, np.zeros(len(lines), bool), issue)
        for keep in (False, True):
            _assert_result_equal(
                simulate_trace_device(tr, cfg, keep_finish=keep,
                                      device="cpu"),
                timing.simulate_trace(lines, issue, cfg, keep_finish=keep))


def test_simulate_trace_device_empty_trace():
    cfg = ddr3_1600k()
    z = np.zeros(0, dtype=np.int64)
    got = simulate_trace_device(Trace(z, z.astype(bool), z), cfg,
                                keep_finish=True, device="cpu")
    want = interop.trace_result(simulate_trace_jax(
        RTrace(z, z.astype(bool), z), r_ddr3(), keep_finish=True))
    _assert_result_equal(got, want)
    assert got.cycles == 0 and got.per_channel_cycles == {0: 0, 1: 0, 2: 0,
                                                          3: 0}


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 300),
       span=st.sampled_from([1 << 8, 1 << 14, 1 << 20]))
def test_property_device_equals_oracle(seed, n, span):
    """The JAX package's property test, on the port's two forms."""
    cfg = ddr4_2400r()
    rng = np.random.default_rng(seed)
    lines, issue = _random(rng, n, span=span)
    tr = Trace(lines, np.zeros(n, bool), issue)
    a = timing.simulate_trace(lines, issue, cfg, keep_finish=True)
    b = simulate_trace_device(tr, cfg, keep_finish=True, device="cpu")
    np.testing.assert_array_equal(a.finish, b.finish)
    assert (a.row_hits, a.row_empty, a.row_conflicts) == \
        (b.row_hits, b.row_empty, b.row_conflicts)


class TestOracleProperties:
    """``tests/test_dram_timing.py``'s oracle properties, on the port."""

    def test_sequential_near_peak(self):
        r = timing.simulate_trace(np.arange(20000), bulk_issue(20000, 0),
                                  ddr3_1600k())
        assert r.bandwidth_fraction > 0.95 and r.hit_rate > 0.95

    def test_random_degrades(self):
        lines = np.random.default_rng(0).integers(0, 1 << 22, 20000)
        r = timing.simulate_trace(lines, bulk_issue(20000, 0), ddr4_2400r())
        assert r.bandwidth_fraction < 0.5
        assert r.row_conflicts > 0.9 * r.total_requests

    def test_same_row_pingpong_worst_case(self):
        cfg = ddr4_2400r()
        b = cfg.org.lines_per_row * cfg.banks_per_channel
        r = timing.simulate_trace(np.array([0, b] * 1000),
                                  bulk_issue(2000, 0), cfg)
        t = cfg.timing
        assert r.row_conflicts >= 2 * 1000 - 2
        assert r.cycles >= (2000 - 2) * min(t.tRAS + t.tRP,
                                            t.tRP + t.tRCD + t.tBL)

    def test_channel_parallelism(self):
        lines = np.arange(16000)
        r4 = timing.simulate_trace(lines, bulk_issue(16000, 0),
                                   ddr3_1600k(channels=4))
        r1 = timing.simulate_trace(lines, bulk_issue(16000, 0),
                                   ddr3_1600k(channels=1))
        assert r1.cycles > 3.5 * r4.cycles

    def test_issue_lower_bound_respected(self):
        r = timing.simulate_trace(np.arange(10), np.full(10, 5000),
                                  ddr4_2400r(), keep_finish=True)
        assert (r.finish > 5000).all()

    def test_peak(self):
        assert abs(ddr4_2400r(density="8Gb").peak_gbps - 19.2) < 0.01
        assert abs(ddr3_1600k().peak_gbps - 51.2) < 0.01
        assert abs(hbm2e(16).peak_gbps - 819.2) < 0.1
