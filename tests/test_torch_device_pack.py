"""The port's device pack against its host pack and the JAX package's.

``repro_torch.core.accel.pack_program_device`` (torch code, forced here
onto the CPU) must equal the port's NumPy ``pack_program`` and
``repro.core.accel.pack_program_device`` (JAX on the CPU) array for
array: issue, meta, boundary, kind, the per-phase step counts, hits and
conflicts, the step count, the block width and the row state after the
program.  Covers the ``ddr3``, ``ddr4``, ``ddr4-8gb`` and ``hbm2``
memories, hypothesis programs, a warm ``open_row``, a program whose
leading phase is empty (its boundary index is -1 and wraps, as in JAX),
``device_pack_supported``'s false cases, ``finalize_program_device``
against ``finalize_program``, ``open_row`` chained across programs, and
the route ``pack_program_auto`` picks (the tests that drive the device
pack through a CPU run patch its policy, ``_auto_pack_prefers_device``).  All integers: every comparison is exact.
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import accel as r_accel
from repro.core.trace import SegmentedTrace as RSegmentedTrace
from repro.sim.memory import resolve_memory as r_resolve_memory

from repro_torch import interop
from repro_torch.core import accel, vectorized as vec
from repro_torch.core.dram import ddr4_2400r
from repro_torch.core.trace import SegmentedTrace
from repro_torch.sim.memory import resolve_memory

MEMORIES = ("ddr3", "ddr4", "ddr4-8gb", "hbm2")


def _random_program(rng, n_phases=5, span=1 << 18, max_n=300,
                    sequential=False):
    """The generator of tests/test_device_pack.py."""
    phases = []
    base = 0
    for p in range(n_phases):
        n = int(rng.integers(16, max_n))
        if sequential:                    # hit-dominated (wide blocks)
            lines = base + np.arange(n)
            base += n // 2
        else:
            lines = rng.integers(0, span, n)
        phases.append((f"p{p}", lines, np.zeros(n, dtype=bool),
                       np.sort(rng.integers(0, 4 * n, n))))
    return SegmentedTrace.from_phases(phases)


def _r_program(prog: SegmentedTrace) -> RSegmentedTrace:
    return RSegmentedTrace(prog.line_addr, prog.is_write, prog.issue,
                           prog.offsets, list(prog.names))


def _assert_packs_equal(prog, mem, open_row=None):
    """Port device pack == port host pack == JAX device pack."""
    cfg = resolve_memory(mem)
    host = accel.pack_program(prog, cfg, open_row=open_row)
    dev = accel.pack_program_device(prog, cfg, open_row=open_row,
                                    device="cpu")
    jax_dev = interop.device_packed_program(r_accel.pack_program_device(
        _r_program(prog), r_resolve_memory(mem), open_row=open_row))
    assert np.array_equal(dev.issue.numpy(), host.issue)
    assert np.array_equal(dev.meta.numpy(), host.meta)
    assert np.array_equal(dev.boundary.numpy(), host.boundary)
    assert np.array_equal(dev.kind.numpy()[:len(prog)], host.kind)
    assert np.array_equal(dev.open_row_final.numpy(), host.open_row_final)
    assert dev.n_steps == host.n_steps
    assert dev.K == host.issue.shape[2]
    P = prog.n_phases
    steps = np.diff(np.append(host.step_starts, host.n_steps))
    assert np.array_equal(dev.L_p.numpy()[:P], steps)
    assert not dev.L_p.numpy()[P:].any()
    off = host.offsets[:-1]
    assert np.array_equal(dev.hits_p.numpy()[:P], np.add.reduceat(
        (host.kind == 0).astype(np.int64), off))
    assert np.array_equal(dev.confl_p.numpy()[:P], np.add.reduceat(
        (host.kind == 2).astype(np.int64), off))
    for field in ("issue", "meta", "boundary", "kind", "L_p", "hits_p",
                  "confl_p", "open_row_final"):
        got, want = getattr(dev, field), getattr(jax_dev, field)
        assert got.dtype == want.dtype, field
        assert torch.equal(got, want), field
    assert (dev.n_steps, dev.K) == (jax_dev.n_steps, jax_dev.K)
    return host, dev


@pytest.mark.parametrize("mem", MEMORIES)
@pytest.mark.parametrize("sequential", [False, True])
def test_packed_arrays_match(mem, sequential):
    rng = np.random.default_rng(len(mem) * 2 + sequential)
    prog = _random_program(rng, sequential=sequential)
    assert accel.device_pack_supported(prog, resolve_memory(mem))
    _assert_packs_equal(prog, mem)


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2**16), mem=st.sampled_from(MEMORIES),
       n_phases=st.integers(1, 6), max_n=st.integers(17, 500),
       sequential=st.booleans())
def test_packed_arrays_match_hypothesis(seed, mem, n_phases, max_n,
                                        sequential):
    rng = np.random.default_rng(seed)
    prog = _random_program(rng, n_phases=n_phases, max_n=max_n,
                           sequential=sequential)
    _assert_packs_equal(prog, mem)


@pytest.mark.parametrize("mem", ["ddr3", "ddr4"])
def test_warm_open_row(mem):
    """A warm row state entering the program: the first access of each
    bank classifies against it."""
    cfg = resolve_memory(mem)
    rng = np.random.default_rng(11)
    prog = _random_program(rng, span=1 << 14)
    open_row = rng.integers(-1, 4, (cfg.channels, cfg.banks_per_channel))
    host, dev = _assert_packs_equal(prog, mem, open_row=open_row)
    cold = accel.pack_program(prog, cfg)
    assert not np.array_equal(host.kind, cold.kind)


def test_leading_empty_phase_wraps_boundary():
    """A program built with an empty leading phase (``L_p = 0``): the
    boundary index ``cumsum(L_p) - 1`` is -1 and wraps to the last padded
    step, in the host pack, the JAX device pack and the port's."""
    rng = np.random.default_rng(5)
    full = _random_program(rng, n_phases=3)
    prog = SegmentedTrace(full.line_addr, full.is_write, full.issue,
                          np.concatenate([[0], full.offsets]),
                          ["empty"] + list(full.names))
    host, dev = _assert_packs_equal(prog, "ddr4")
    assert int(dev.L_p[0]) == 0
    assert bool(dev.boundary[-1]) and host.boundary[-1]


def test_device_pack_supported_false_cases():
    prog = _random_program(np.random.default_rng(1))
    three_ch = dataclasses.replace(ddr4_2400r(), channels=3)
    assert three_ch.decode_spec() is None
    assert not accel.device_pack_supported(prog, three_ch)
    wide = ddr4_2400r(ranks=32)           # 512 banks a channel
    assert not accel.device_pack_supported(prog, wide)
    far = SegmentedTrace.from_phases(
        [("p", np.array([5, 2**31]), np.zeros(2, bool), np.zeros(2))])
    assert not accel.device_pack_supported(far, ddr4_2400r())

    class Huge:                           # n * B >= 2**31
        line_addr = np.array([0])

        def __len__(self):
            return 2**27

    assert not accel.device_pack_supported(Huge(), ddr4_2400r())
    assert accel.device_pack_supported(prog, ddr4_2400r())
    with pytest.raises(ValueError, match="device pack"):
        accel.pack_program_device(prog, three_ch, device="cpu")
    # forced onto the device pack, out-of-range inputs raise (checked on
    # the device, read with the step count)
    with pytest.raises(ValueError, match="beyond int32"):
        accel.pack_program_device(far, ddr4_2400r(), device="cpu")
    late = SegmentedTrace.from_phases(
        [("p", np.array([1, 2]), np.zeros(2, bool),
          np.array([0, vec.MAX_PHASE_ISSUE]))])
    with pytest.raises(ValueError, match="issue cycles"):
        accel.pack_program_device(late, ddr4_2400r(), device="cpu")
    with pytest.raises(ValueError, match="issue cycles"):
        accel.pack_program(late, ddr4_2400r())
    # "auto" keeps the host packer where the device pack does not apply
    accel.zero_pack_route_counts()
    packed = accel.pack_program_auto(prog, three_ch, device="cpu")
    assert isinstance(packed, accel.PackedProgram)
    assert accel.pack_route_counts() == {"device_pack": 0, "host_pack": 1}


def test_finish_times_and_stats_match():
    cfg = resolve_memory("ddr4-8gb")
    prog = _random_program(np.random.default_rng(7), sequential=True)
    host = accel.pack_program(prog, cfg)
    dev = accel.pack_program_device(prog, cfg, device="cpu")
    got_h = accel.serve_packed(host, device="cpu")
    got_d = accel.serve_packed(dev, device="cpu")
    assert got_h[0] == got_d[0]
    assert all(torch.equal(a, b) for a, b in zip(got_h[1], got_d[1]))
    fin = vec.fused_scan(host.issue, host.meta, host.boundary, host.timing,
                         vec.init_lean_carry(cfg.channels, host.n_banks,
                                             host.banks_per_rank, "cpu"),
                         "cpu")[0]
    assert accel.finalize_program(host, fin, origin=17) == \
        accel.finalize_program_device(dev, fin, origin=17)


def test_open_row_chaining_across_programs(monkeypatch):
    """Carry (open rows + timing state) flows identically whether programs
    are packed on the host or on the device (the route policy patched to
    pick the device pack on the CPU)."""
    cfg = resolve_memory("ddr3")
    rng = np.random.default_rng(3)
    progs = [_random_program(rng, sequential=bool(i % 2))
             for i in range(3)]
    accel.zero_pack_route_counts()
    a = accel.VectorizedDRAM(cfg, device="cpu")
    for prog in progs:
        a.run_program(prog)
    assert accel.pack_route_counts() == {"device_pack": 0, "host_pack": 3}
    monkeypatch.setattr(accel, "_auto_pack_prefers_device", lambda d: True)
    b = accel.VectorizedDRAM(cfg, device="cpu")
    for prog in progs:
        b.run_program(prog)
    assert accel.pack_route_counts() == {"device_pack": 3, "host_pack": 3}
    assert a.now == b.now
    assert a.phases == b.phases
    assert (a.total_requests, a.total_row_hits, a.total_row_conflicts) == \
        (b.total_requests, b.total_row_hits, b.total_row_conflicts)
    assert all(torch.equal(x, y) for x, y in zip(a.carry, b.carry))


def test_auto_route(monkeypatch):
    """The route follows what the code observes: the device pack for a
    run on the card where :func:`device_pack_supported` holds, the host
    pack for a CPU run or an unsupported program."""
    prog = _random_program(np.random.default_rng(2))
    cfg = resolve_memory("ddr4")
    assert not accel._auto_pack_prefers_device(torch.device("cpu"))
    assert accel._auto_pack_prefers_device(torch.device("cuda"))
    assert isinstance(accel.pack_program_auto(prog, cfg, device="cpu"),
                      accel.PackedProgram)
    monkeypatch.setattr(accel, "_auto_pack_prefers_device", lambda d: True)
    assert isinstance(accel.pack_program_auto(prog, cfg, device="cpu"),
                      accel.DevicePackedProgram)
    three_ch = dataclasses.replace(cfg, channels=3)
    assert not accel.device_pack_supported(prog, three_ch)
    assert isinstance(accel.pack_program_auto(prog, three_ch, device="cpu"),
                      accel.PackedProgram)


def test_simulate_device_pack_equals_repro(monkeypatch):
    """Whole runs packed on the device equal the JAX package's reports."""
    from repro.graphs.generators import rmat as r_rmat
    from repro.sim import simulate as r_simulate
    from repro_torch.sim import simulate

    monkeypatch.setattr(accel, "_auto_pack_prefers_device", lambda d: True)
    g = r_rmat(8, 5, seed=1).undirected_view()
    accel.zero_pack_route_counts()
    for acc, mem in (("hitgraph", "hbm2"), ("accugraph", None)):
        want = interop.sim_report(r_simulate(g, "wcc", accelerator=acc,
                                             memory=mem))
        got = simulate(interop.graph(g), "wcc", accelerator=acc, memory=mem,
                       device="cpu")
        assert got == want, acc
    assert accel.pack_route_counts() == {"device_pack": 2, "host_pack": 0}
