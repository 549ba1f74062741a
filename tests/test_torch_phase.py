"""The port's per-phase path against the JAX package's: the plain
per-channel scan (``repro_torch.kernels.dram_timing.ref.dram_timing_ref``,
also what the wrapper runs for CPU tensors) against the XLA scan
``repro.core.vectorized._simulate_packed`` and the JAX package's
``dram_timing_ref``; ``simulate_trace`` against ``simulate_trace_jax``;
and ``VectorizedDRAM.run_phase`` against the JAX package's, alone,
interleaved with ``run_program`` and across the int32 re-base.  The JAX
package's Pallas ``dram_timing`` kernel does not run on this JAX
(``pl.load``), so its ``ref.py`` is the reference, as in its own tests.
Every value is an integer: all comparisons are exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import vectorized as r_vec
from repro.core.accel import VectorizedDRAM as RVectorizedDRAM
from repro.core.dram import PRESETS as R_PRESETS
from repro.core.dram import ddr3_1600k as r_ddr3
from repro.core.dram import ddr4_2400r as r_ddr4
from repro.core.dram import hbm2 as r_hbm2
from repro.core.trace import SegmentedTrace as RSegmentedTrace
from repro.core.trace import Trace as RTrace
from repro.core.trace import bulk_issue
from repro.kernels.dram_timing.ref import dram_timing_ref as r_timing_ref

from repro_torch import interop
from repro_torch.core import accel, vectorized as vec
from repro_torch.core.trace import Trace, group_ranks
from repro_torch.kernels.dram_timing.ops import dram_timing, simulate_trace
from repro_torch.kernels.dram_timing.ref import dram_timing_ref

MEMORIES = {
    "ddr3": lambda: r_ddr3(channels=4, ranks=2),
    "ddr4": lambda: r_ddr4(),
    "ddr4-8gb": lambda: r_ddr4(density="8Gb"),
    "ddr4-2rank": lambda: r_ddr4(channels=2, ranks=2),
    "hbm2": lambda: r_hbm2(),
    "hbm2e": R_PRESETS["hbm2e"],
}


def _random_trace(rng, n=600, span=1 << 16, bulk=False):
    """A program-order trace; ``bulk`` issues everything at cycle 0 over
    a wide row span, so back-to-back ACTs hit the tFAW window."""
    lines = rng.integers(0, span, n)
    issue = (np.zeros(n, dtype=np.int64) if bulk
             else np.sort(rng.integers(0, 4 * n, n)))
    return RTrace(lines, np.zeros(n, dtype=bool), issue)


def _random_program(rng, n_phases=6, span=1 << 18, max_n=400):
    """The generator of tests/test_fused_pipeline.py."""
    phases = []
    for p in range(n_phases):
        n = int(rng.integers(1, max_n))
        lines = rng.integers(0, span, n)
        issue = np.sort(rng.integers(0, 4 * n, n))
        phases.append((f"p{p}", lines, np.zeros(n, dtype=bool), issue))
    return RSegmentedTrace.from_phases(phases)


def _r_cold_carry(r_cfg, C):
    single = r_vec.init_channel_carry(r_cfg.banks_per_channel,
                                      r_cfg.org.banks)
    return tuple(jnp.broadcast_to(x, (C,) + x.shape) for x in single)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _streams(r_cfg, trace):
    packed = vec.pack_channels(interop.trace(trace),
                               interop.dram_config(r_cfg))
    return packed, [_t(packed.issue), _t(packed.bank), _t(packed.row),
                    _t(packed.valid)]


def _assert_carry_equal(carry, r_carry):
    assert len(carry) == len(r_carry) == 7
    for a, b in zip(carry, r_carry):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---- the plain per-channel scan --------------------------------------

@pytest.mark.parametrize("memory", sorted(MEMORIES))
@pytest.mark.parametrize("bulk", [False, True])
def test_dram_timing_ref_vs_jax(memory, bulk):
    """Carry chained across two calls of the port's plain scan equals one
    XLA scan (finish, kind and the 7-tuple carry) and the JAX package's
    ``dram_timing_ref``."""
    r_cfg = MEMORIES[memory]()
    rng = np.random.default_rng(len(memory) + 7 * bulk)
    trace = _random_trace(rng, bulk=bulk,
                          span=1 << 24 if bulk else 1 << 16)
    packed, args = _streams(r_cfg, trace)
    t = vec.timing_params(interop.dram_config(r_cfg).timing)
    B, bpr = r_cfg.banks_per_channel, r_cfg.org.banks
    fin_r, kind_r, carry_r = r_vec._simulate_packed(
        *(jnp.asarray(a) for a in (packed.issue, packed.bank, packed.row,
                                   packed.valid)),
        jnp.asarray(t), B, bpr)
    carry = vec.init_channel_carry(r_cfg.channels, B, bpr, "cpu")
    h = packed.issue.shape[1] // 2
    fins, kinds = [], []
    for lo, hi in ((0, h), (h, packed.issue.shape[1])):
        f, k, carry = dram_timing_ref(*(a[:, lo:hi].contiguous()
                                        for a in args), _t(t), carry)
        fins.append(f)
        kinds.append(k)
    fin, kind = torch.cat(fins, 1), torch.cat(kinds, 1)
    assert kind.dtype == torch.int8 and np.asarray(kind_r).dtype == np.int8
    np.testing.assert_array_equal(fin.numpy(), np.asarray(fin_r))
    np.testing.assert_array_equal(kind.numpy(), np.asarray(kind_r))
    _assert_carry_equal(carry, carry_r)
    fin_o, kind_o = r_timing_ref(packed.issue, packed.bank, packed.row,
                                 packed.valid, t, n_banks=B,
                                 banks_per_rank=bpr)
    np.testing.assert_array_equal(fin.numpy(), np.asarray(fin_o))
    np.testing.assert_array_equal(kind.numpy().astype(np.int32),
                                  np.asarray(kind_o))


def test_faw_window_binds():
    """The bulk trace really is limited by the four-ACT window: without
    tFAW its finishes change."""
    r_cfg = r_ddr4()
    packed, args = _streams(r_cfg, _random_trace(
        np.random.default_rng(8), bulk=True, span=1 << 24))
    t = vec.timing_params(interop.dram_config(r_cfg).timing)
    no_faw = t.copy()
    no_faw[6] = 0
    carry = vec.init_channel_carry(1, r_cfg.banks_per_channel,
                                   r_cfg.org.banks, "cpu")
    with_faw = dram_timing_ref(*args, _t(t), carry)[0]
    without = dram_timing_ref(*args, _t(no_faw), carry)[0]
    assert not torch.equal(with_faw, without)


def test_dram_timing_ref_from_warm_carry():
    """A carry left by one phase (open rows, ACT history) feeds the next
    exactly as the XLA scan carries it."""
    r_cfg = MEMORIES["ddr3"]()
    rng = np.random.default_rng(31)
    B, bpr = r_cfg.banks_per_channel, r_cfg.org.banks
    t = vec.timing_params(interop.dram_config(r_cfg).timing)
    r_carry = _r_cold_carry(r_cfg, r_cfg.channels)
    carry = vec.init_channel_carry(r_cfg.channels, B, bpr, "cpu")
    for span in (1 << 10, 1 << 20):
        trace = _random_trace(rng, n=400, span=span)
        packed, args = _streams(r_cfg, trace)
        fin_r, kind_r, r_carry = r_vec._simulate_packed(
            *(jnp.asarray(a) for a in (packed.issue, packed.bank,
                                       packed.row, packed.valid)),
            jnp.asarray(t), B, bpr, r_carry)
        fin, kind, carry = dram_timing_ref(*args, _t(t), carry)
        np.testing.assert_array_equal(fin.numpy(), np.asarray(fin_r))
        np.testing.assert_array_equal(kind.numpy(), np.asarray(kind_r))
        _assert_carry_equal(carry, r_carry)


@pytest.mark.parametrize("memory", ["ddr3", "ddr4", "hbm2"])
def test_simulate_trace_vs_jax(memory):
    r_cfg = MEMORIES[memory]()
    trace = _random_trace(np.random.default_rng(3), n=800)
    finish, kind, makespan = simulate_trace(
        interop.trace(trace), interop.dram_config(r_cfg), device="cpu")
    want = r_vec.simulate_trace_jax(trace, r_cfg, keep_finish=True)
    packed = r_vec.pack_channels(trace, r_cfg)
    assert makespan == want.cycles
    flat = np.zeros(len(trace), dtype=np.int64)
    flat[packed.scatter_index[packed.valid]] = finish[packed.valid]
    np.testing.assert_array_equal(flat, want.finish)
    assert [int((kind == k).sum()) for k in (0, 1, 2)] == [
        want.row_hits, want.row_empty, want.row_conflicts]
    assert int((kind == -1).sum()) == int((~packed.valid).sum())


def test_pack_channels_and_group_ranks_vs_jax():
    from repro.core.trace import group_ranks as r_group_ranks
    r_cfg = MEMORIES["hbm2e"]()
    trace = _random_trace(np.random.default_rng(4), n=1000)
    got = vec.pack_channels(interop.trace(trace),
                            interop.dram_config(r_cfg))
    want = r_vec.pack_channels(trace, r_cfg)
    for f in dataclasses.fields(vec.PackedChannels):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    key = np.random.default_rng(5).integers(0, 7, 300)
    counts = np.bincount(key, minlength=7)
    np.testing.assert_array_equal(group_ranks(counts, key),
                                  r_group_ranks(counts, key))


def test_dram_timing_wrapper_rejects_bad_input():
    r_cfg = MEMORIES["ddr4-2rank"]()
    packed, args = _streams(r_cfg, _random_trace(np.random.default_rng(1),
                                                 n=50))
    t = _t(vec.timing_params(interop.dram_config(r_cfg).timing))
    carry = vec.init_channel_carry(2, r_cfg.banks_per_channel,
                                   r_cfg.org.banks, "cpu")
    with pytest.raises(TypeError):
        dram_timing(args[0].long(), *args[1:], t, carry)
    with pytest.raises(TypeError):
        dram_timing(*args[:3], args[3].int(), t, carry)
    with pytest.raises(ValueError):
        dram_timing(*args, t, carry[:6])
    bad = args[0].clone()
    bad[0, 0] = vec.MAX_PHASE_ISSUE
    with pytest.raises(ValueError):
        dram_timing(bad, *args[1:], t, carry)
    bad = args[1].clone()
    bad[0, 0] = r_cfg.banks_per_channel
    with pytest.raises(ValueError):
        dram_timing(args[0], bad, *args[2:], t, carry)
    # neither a CPU nor a CUDA tensor: no plain-version fallback
    with pytest.raises((ValueError, NotImplementedError, RuntimeError)):
        dram_timing(*(a.to("meta") for a in args), t.to("meta"),
                    tuple(x.to("meta") for x in carry))


def test_dram_timing_cpu_path_is_the_plain_version():
    """For CPU tensors the wrapper runs the plain version and counts no
    kernel launch."""
    r_cfg = MEMORIES["hbm2"]()
    packed, args = _streams(r_cfg, _random_trace(np.random.default_rng(2)))
    t = _t(vec.timing_params(interop.dram_config(r_cfg).timing))
    carry = vec.init_channel_carry(8, 16, 16, "cpu")
    before = dram_timing.launches
    a = dram_timing(*args, t, carry)
    b = dram_timing_ref(*args, t, carry)
    assert dram_timing.launches == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))


# ---- VectorizedDRAM.run_phase ----------------------------------------

def _phase_tuples(backend):
    return [dataclasses.astuple(p) for p in backend.phases]


def _assert_same(port, ref):
    """Clock, totals, every phase's statistics and the carry."""
    assert port.now == ref.now
    assert port.total_requests == ref.total_requests
    assert port.total_row_hits == ref.total_row_hits
    assert port.total_row_conflicts == ref.total_row_conflicts
    assert _phase_tuples(port) == _phase_tuples(ref)
    _assert_carry_equal(port.carry, ref.carry)


def _pair(r_cfg):
    return (accel.VectorizedDRAM(interop.dram_config(r_cfg), device="cpu"),
            RVectorizedDRAM(r_cfg))


@pytest.mark.parametrize("preset", sorted(R_PRESETS))
def test_run_phase_random_programs_all_presets(preset):
    """Per-phase serving equals the JAX package's per-phase path and the
    port's own fused ``run_program`` (tests/test_fused_pipeline.py:52)."""
    r_cfg = R_PRESETS[preset]()
    rng = np.random.default_rng(sum(map(ord, preset)))
    prog = _random_program(rng)
    port, ref = _pair(r_cfg)
    for p in range(prog.n_phases):
        end = port.run_phase(interop.trace(prog.phase(p)), prog.names[p])
        assert end == ref.run_phase(prog.phase(p), prog.names[p])
    _assert_same(port, ref)
    fused = accel.VectorizedDRAM(interop.dram_config(r_cfg), device="cpu")
    fused.run_program(interop.segmented_trace(prog))
    assert fused.now == port.now
    assert _phase_tuples(fused) == _phase_tuples(port)
    assert set(port.stage_seconds) >= {"phase_pack", "phase_serve",
                                       "phase_finalize"}


def test_mixed_phase_and_program_calls():
    """run_phase and run_program interleave on one backend: the carry
    (open rows, bank/bus state, ACT history) flows across both ways
    (tests/test_fused_pipeline.py:102)."""
    r_cfg = r_ddr3(channels=2)
    rng = np.random.default_rng(5)
    progs = [_random_program(rng, n_phases=3) for _ in range(3)]
    port, ref = _pair(r_cfg)
    for backend, conv in ((port, interop.segmented_trace),
                          (ref, lambda x: x)):
        backend.run_program(conv(progs[0]))
        for p in range(progs[1].n_phases):
            tr = progs[1].phase(p)
            backend.run_phase(interop.trace(tr) if backend is port else tr,
                              progs[1].names[p])
        backend.run_program(conv(progs[2]))
    _assert_same(port, ref)


def test_threshold_crossing_flushes_and_keeps_stats():
    """Crossing ``MAX_PHASE_ISSUE`` flushes the carry (as the JAX package
    does) and keeps the phases, totals and absolute clock
    (tests/test_fused_pipeline.py:140)."""
    port, ref = _pair(r_ddr4())
    n = 64
    tr = RTrace(np.arange(n, dtype=np.int64), np.zeros(n, dtype=bool),
                bulk_issue(n, 2**30))
    for name in ("a", "b"):
        assert port.run_phase(interop.trace(tr), name) == \
            ref.run_phase(tr, name)
    assert port.now >= vec.MAX_PHASE_ISSUE
    assert len(port.phases) == 2
    _assert_same(port, ref)


def test_long_run_monotonic_clock():
    port, ref = _pair(r_hbm2(channels=2))
    n = 32
    tr = RTrace(np.arange(n, dtype=np.int64) * 7, np.zeros(n, dtype=bool),
                bulk_issue(n, 2**30))
    ends = [port.run_phase(interop.trace(tr), f"p{i}") for i in range(6)]
    for i in range(6):
        ref.run_phase(tr, f"p{i}")
    assert ends == sorted(ends) and ends[-1] > 2**32
    _assert_same(port, ref)


def test_program_after_rebase():
    """run_program continues from a re-based run_phase exactly as the
    JAX package does (tests/test_fused_pipeline.py:171)."""
    port, ref = _pair(r_ddr4())
    n = 64
    tr = RTrace(np.arange(n, dtype=np.int64), np.zeros(n, bool),
                bulk_issue(n, 2**30))
    prog = _random_program(np.random.default_rng(0), n_phases=2)
    for name in ("a", "b"):
        port.run_phase(interop.trace(tr), name)
        ref.run_phase(tr, name)
    port.run_program(interop.segmented_trace(prog))
    ref.run_program(prog)
    assert len(port.phases) == 4
    _assert_same(port, ref)


def test_carry_after_phase_round_trips_lean():
    """After run_phase the carried ``last_act`` is what the lean carry
    derives from the ACT history, so ``lean_from_full``/``full_from_lean``
    give back the state the JAX package holds."""
    r_cfg = r_ddr3()
    port, ref = _pair(r_cfg)
    prog = _random_program(np.random.default_rng(9), n_phases=3)
    for p in range(prog.n_phases):
        port.run_phase(interop.trace(prog.phase(p)), prog.names[p])
        ref.run_phase(prog.phase(p), prog.names[p])
    back = vec.full_from_lean(vec.lean_from_full(port.carry),
                              port.carry[0].numpy())
    _assert_carry_equal(back, ref.carry)


def test_empty_phase_is_noop():
    port, _ = _pair(r_ddr4())
    z = np.empty(0, dtype=np.int64)
    assert port.run_phase(Trace(z, z.astype(bool), z)) == 0
    assert port.phases == []


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 2**31 - 1),
       span=st.sampled_from([1 << 8, 1 << 14, 1 << 20]),
       tRRD=st.integers(1, 8), tFAW=st.integers(4, 40))
def test_property_phases_traced_timing(seed, span, tRRD, tFAW):
    """Arbitrary ACT rate limits: per-phase serving stays bit-identical
    to the JAX package's, carry included."""
    base = r_ddr4(ranks=2)
    r_cfg = dataclasses.replace(
        base, timing=dataclasses.replace(base.timing, tRRD=tRRD,
                                         tFAW=tFAW))
    prog = _random_program(np.random.default_rng(seed), n_phases=3,
                           span=span, max_n=200)
    port, ref = _pair(r_cfg)
    for p in range(prog.n_phases):
        port.run_phase(interop.trace(prog.phase(p)), prog.names[p])
        ref.run_phase(prog.phase(p), prog.names[p])
    _assert_same(port, ref)
