"""The port's serve path against the JAX package's: the plain torch serve
(``repro_torch.kernels.dram_timing.ref.dram_serve_ref``, also what the
wrapper runs for CPU tensors) against the XLA-scan reference
``repro.kernels.dram_timing.ref.dram_serve_ref``, plus the host packer
and finalizer.  Every value is an integer: all comparisons are exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import accel as r_accel
from repro.core import vectorized as r_vec
from repro.core.dram import PRESETS as R_PRESETS
from repro.core.dram import ddr4_2400r as r_ddr4
from repro.core.trace import SegmentedTrace as RSegmentedTrace
from repro.kernels.dram_timing.ref import dram_serve_ref as r_serve_ref

from repro_torch import interop
from repro_torch.core import accel, vectorized as vec
from repro_torch.kernels.dram_timing import ops
from repro_torch.kernels.dram_timing.ops import chunk_steps, dram_serve
from repro_torch.kernels.dram_timing.ref import (
    REC_BOUNDARY, REC_EMPTY, dram_serve_ref, serve_prepass_batch_ref,
    serve_prepass_ref, serve_records_batch_ref,
    serve_records_chunked_batch_ref, serve_records_chunked_ref,
    serve_records_ref)


def _random_serve_program(rng, n_phases=5, span=1 << 16, max_n=400,
                          hit_heavy=False):
    """The generator of tests/test_kernels.py (same draws)."""
    phases = []
    for p in range(n_phases):
        n = int(rng.integers(1, max_n))
        pool = 64 if hit_heavy else span
        lines = rng.integers(0, pool, n)
        if hit_heavy:
            lines = np.sort(lines)
        issue = np.sort(rng.integers(0, 4 * n, n))
        phases.append((f"p{p}", lines, np.zeros(n, dtype=bool), issue))
    return RSegmentedTrace.from_phases(phases)


def _cold_state(packed, C):
    lean = vec.init_lean_carry(C, packed.n_banks, packed.banks_per_rank,
                               "cpu")
    return tuple(lean) + (torch.zeros(C, dtype=torch.int32),)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def _assert_serve_parity(r_cfg, r_prog, split=None):
    """Pack with both packers (fields equal), serve with both serves
    (finishes and the full 6-tuple carry equal).  ``split`` serves the
    port's side as two calls with the carry chained across them."""
    r_packed = r_accel.pack_program(r_prog, r_cfg)
    packed = accel.pack_program(interop.segmented_trace(r_prog),
                                interop.dram_config(r_cfg))
    _assert_packed_equal(packed, r_packed)
    C = r_cfg.channels
    r_state = tuple(r_vec.init_lean_carry(C, r_packed.n_banks,
                                          r_packed.banks_per_rank)) + (
        jnp.zeros((C,), dtype=jnp.int32),)
    t = r_vec.timing_params(r_cfg.timing)
    fin_r, st_r = r_serve_ref(r_packed.issue, r_packed.meta,
                              r_packed.boundary, t, *r_state,
                              banks_per_rank=r_packed.banks_per_rank)
    streams = [_t(packed.issue), _t(packed.meta), _t(packed.boundary)]
    state = _cold_state(packed, C)
    if split is None:
        fin, state = dram_serve(*streams, _t(packed.timing), state)
    else:
        fins = []
        for lo, hi in ((0, split), (split, len(packed.boundary))):
            f, state = dram_serve(*(s[lo:hi].contiguous() for s in streams),
                                  _t(packed.timing), state)
            fins.append(f)
        fin = torch.cat(fins)
    np.testing.assert_array_equal(fin.numpy(), np.asarray(fin_r))
    assert len(state) == len(st_r) == 6
    for a, b in zip(state, st_r):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return packed, fin


def _assert_packed_equal(packed, r_packed):
    for f in dataclasses.fields(accel.PackedProgram):
        a, b = getattr(packed, f.name), getattr(r_packed, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == np.asarray(b).dtype, f.name
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("preset", ["hitgraph", "accugraph", "hbm2",
                                    "hbm2e"])
@pytest.mark.parametrize("hit_heavy", [False, True])
def test_serve_and_pack_vs_jax(preset, hit_heavy):
    """Both block widths (K=8 hit chains, K=1 serialized misses) across
    channel counts 1/4/8/16 and one or two ranks per channel."""
    r_cfg = R_PRESETS[preset]()
    rng = np.random.default_rng(5 + hit_heavy)
    packed, _ = _assert_serve_parity(
        r_cfg, _random_serve_program(rng, hit_heavy=hit_heavy))
    assert packed.issue.shape[2] == (8 if hit_heavy else 1)


@pytest.mark.parametrize("preset", ["hitgraph", "accugraph"])
def test_serve_carry_chains_across_calls(preset):
    """Serving a program in two calls, the carry handed from one to the
    next, equals the JAX package's single scan — the split falls inside
    a phase, before the padded tail."""
    r_cfg = R_PRESETS[preset]()
    rng = np.random.default_rng(23)
    prog = _random_serve_program(rng, n_phases=4, hit_heavy=True)
    packed = accel.pack_program(interop.segmented_trace(prog),
                                interop.dram_config(r_cfg))
    _assert_serve_parity(r_cfg, prog, split=packed.n_steps // 2 + 1)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10**6), tRRD=st.integers(1, 8),
       tFAW=st.integers(4, 40))
def test_property_timing(seed, tRRD, tFAW):
    """Arbitrary ACT rate limits: the plain serve stays bit-identical to
    the XLA scan, multi-phase carries included."""
    base = r_ddr4()
    r_cfg = dataclasses.replace(
        base, timing=dataclasses.replace(base.timing, tRRD=tRRD, tFAW=tFAW))
    rng = np.random.default_rng(seed)
    _assert_serve_parity(r_cfg, _random_serve_program(
        rng, n_phases=4, max_n=200, hit_heavy=bool(seed % 2)))


def test_padded_tail_clamps_bus_and_makespan():
    """Steps past the program are not no-ops: they clamp a negative bus
    time at 0.  The plain serve skips them but must return the carry a
    step-by-step run over the full padded stream gives."""
    r_cfg = R_PRESETS["hitgraph"]()
    rng = np.random.default_rng(3)
    packed, _ = _assert_serve_parity(r_cfg, _random_serve_program(
        rng, n_phases=3, max_n=50))
    assert len(packed.boundary) > packed.n_steps


def test_classify_rows_vs_jax():
    rng = np.random.default_rng(7)
    bank = rng.integers(0, 32, 5000)
    row = rng.integers(0, 6, 5000)
    open_row = rng.integers(-1, 6, (2, 16))
    kind, flat = accel.classify_rows(bank, row, open_row)
    r_kind, r_flat = r_accel.classify_rows(bank, row, open_row)
    np.testing.assert_array_equal(kind, r_kind)
    np.testing.assert_array_equal(flat, r_flat)


@pytest.mark.parametrize("origin", [0, 123_456_789_012])
def test_finalize_program_vs_jax(origin):
    r_cfg = R_PRESETS["hbm2"]()
    rng = np.random.default_rng(11)
    r_prog = _random_serve_program(rng, n_phases=6, hit_heavy=True)
    packed, fin = _assert_serve_parity(r_cfg, r_prog)
    r_packed = r_accel.pack_program(r_prog, r_cfg)
    got = accel.finalize_program(interop.packed_program(r_packed), fin,
                                 origin=origin)
    want = r_accel.finalize_program(r_packed, fin.numpy(), origin=origin)
    for f in ("now", "total_requests", "total_row_hits",
              "total_row_conflicts"):
        assert getattr(got, f) == getattr(want, f), f
    assert ([dataclasses.astuple(p) for p in got.phases]
            == [dataclasses.astuple(p) for p in want.phases])


def test_wrapper_rejects_bad_input():
    r_cfg = R_PRESETS["accugraph"]()
    prog = _random_serve_program(np.random.default_rng(1), n_phases=1)
    packed = accel.pack_program(interop.segmented_trace(prog),
                                interop.dram_config(r_cfg))
    streams = [_t(packed.issue), _t(packed.meta), _t(packed.boundary),
               _t(packed.timing)]
    state = _cold_state(packed, 1)
    with pytest.raises(TypeError):
        dram_serve(streams[0].long(), *streams[1:], state)
    with pytest.raises(ValueError):
        dram_serve(*streams, state[:5])
    bad_issue = streams[0].clone()
    bad_issue[0, 0, 0] = vec.MAX_PHASE_ISSUE
    with pytest.raises(ValueError):
        dram_serve(bad_issue, *streams[1:], state)
    # neither a CPU nor a CUDA tensor: no plain-version fallback
    meta_dev = [s.to("meta") for s in streams]
    with pytest.raises((ValueError, NotImplementedError, RuntimeError)):
        dram_serve(*meta_dev, tuple(x.to("meta") for x in state))


def test_dram_serve_ref_is_the_cpu_path():
    """For CPU tensors the wrapper runs the plain version and counts no
    kernel launch."""
    r_cfg = R_PRESETS["hbm2e"]()
    prog = _random_serve_program(np.random.default_rng(2), n_phases=2,
                                 hit_heavy=True)
    packed = accel.pack_program(interop.segmented_trace(prog),
                                interop.dram_config(r_cfg))
    args = [_t(packed.issue), _t(packed.meta), _t(packed.boundary),
            _t(packed.timing)]
    before = dram_serve.launches
    fin_a, st_a = dram_serve(*args, _cold_state(packed, 16))
    fin_b, st_b = dram_serve_ref(*args, _cold_state(packed, 16))
    assert dram_serve.launches == before
    assert torch.equal(fin_a, fin_b)
    assert all(torch.equal(a, b) for a, b in zip(st_a, st_b))


def _serve_by_records(streams, timing, state, splits):
    """The card's decomposition in plain torch: the carry-free pre-pass
    and the record walk, in calls split at ``splits`` with the carry
    chained from one to the next."""
    S, C, K = streams[0].shape
    B, R = state[0].shape[1], state[3].shape[1]
    T = chunk_steps(C, K)
    fins = []
    for lo, hi in zip([0, *splits], [*splits, S]):
        part = [x[lo:hi].contiguous() for x in streams]
        rec = serve_prepass_ref(*part, timing, B // R, R,
                                -(-(hi - lo) // T) * T)
        assert rec.shape == (C, -(-(hi - lo) // T) * T, K, 2)
        assert bool((rec[:, hi - lo:, :, 1] == REC_EMPTY).all())
        f, state = serve_records_ref(rec, timing, state, hi - lo)
        fins.append(f)
    return torch.cat(fins), state


@pytest.mark.parametrize("preset", ["hitgraph", "accugraph", "hbm2",
                                    "hbm2e"])
@pytest.mark.parametrize("hit_heavy", [False, True])
def test_prepass_and_record_walk_vs_jax(preset, hit_heavy):
    """The pre-pass composed with the record walk, over several phase
    boundaries and with the carry chained across two splits, equals the
    JAX package's ``make_serve_step`` scan and ``dram_serve_ref`` bit for
    bit (finishes and the whole 6-tuple carry)."""
    r_cfg = R_PRESETS[preset]()
    r_prog = _random_serve_program(np.random.default_rng(31 + hit_heavy),
                                   n_phases=6, hit_heavy=hit_heavy)
    r_packed = r_accel.pack_program(r_prog, r_cfg)
    C = r_cfg.channels
    r_state = tuple(r_vec.init_lean_carry(C, r_packed.n_banks,
                                          r_packed.banks_per_rank)) + (
        jnp.zeros((C,), dtype=jnp.int32),)
    fin_r, st_r = r_serve_ref(r_packed.issue, r_packed.meta,
                              r_packed.boundary,
                              r_vec.timing_params(r_cfg.timing), *r_state,
                              banks_per_rank=r_packed.banks_per_rank)
    packed = interop.packed_program(r_packed)
    streams = [_t(packed.issue), _t(packed.meta), _t(packed.boundary)]
    timing = _t(packed.timing)
    state = _cold_state(packed, C)
    assert int(streams[2].sum()) >= 6
    n = packed.n_steps
    fin, st_ = _serve_by_records(streams, timing, state, [n // 3 + 1,
                                                          2 * n // 3])
    fin_p, st_p = dram_serve_ref(*streams, timing, state)
    np.testing.assert_array_equal(fin.numpy(), np.asarray(fin_r))
    assert torch.equal(fin, fin_p)
    for a, b, c in zip(st_, st_r, st_p):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert torch.equal(a, c)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**20), C=st.sampled_from([1, 2, 4]),
       K=st.sampled_from([1, 4, 8]), R=st.sampled_from([1, 2]))
def test_record_walk_exact_on_any_meta(seed, C, K, R):
    """Blocks ``pack_program`` never makes — several misses in a block,
    invalid lanes flagged as misses, banks past the channel's, hits after
    a miss — still serve bit for bit like the plain step: the pre-pass
    and record walk hold the step's semantics, not the packer's
    guarantee."""
    rng = np.random.default_rng(seed)
    S, B = 40, 8
    issue = rng.integers(0, 500, (S, C, K))
    meta = (rng.integers(0, B + 2, (S, C, K))
            | rng.choice([0, vec.META_MISS], (S, C, K))
            | rng.choice([0, vec.META_CONFL], (S, C, K))
            | rng.choice([0, vec.META_VALID, vec.META_VALID], (S, C, K))
            | (rng.integers(0, K, (S, C, K)) << vec.META_RB_SHIFT))
    boundary = rng.random(S) < 0.15
    streams = [_t(issue), _t(meta), _t(boundary)]
    timing = _t(vec.timing_params(R_PRESETS["accugraph"]().timing))
    lean = vec.init_lean_carry(C, B, B // R, "cpu")
    state = tuple(lean) + (torch.zeros(C, dtype=torch.int32),)
    fin, st_ = _serve_by_records(streams, timing, state, [S // 2])
    fin_p, st_p = dram_serve_ref(*streams, timing, state)
    assert torch.equal(fin, fin_p)
    for a, b in zip(st_, st_p):
        assert torch.equal(a, b)
    rec = serve_prepass_ref(*streams, timing, B // R, R, S)
    assert bool(((rec[:, :, 0, 1] & REC_BOUNDARY) != 0).any(dim=0).eq(
        torch.as_tensor(boundary)).all())


# ---- the chunked route's plain version --------------------------------

#: the tile length and group of the chunked tests: many tiles, and runs
#: that cross a group's end
TILE, GROUP = 8, 3


def _phase_ends(layout, S, rng):
    """Phase ends (a bool a step) placed against tiles of ``TILE``:
    inside tiles, on a tile's last step, on its first step (a one-step
    piece), one every few whole tiles, or on runs of consecutive steps."""
    b = np.zeros(S + TILE, dtype=bool)
    if layout == "inside":
        for t0 in range(0, S, TILE):
            b[t0 + rng.integers(1, TILE - 1, 2)] = True
    elif layout == "edge":
        b[TILE - 1::TILE] = True
    elif layout == "first":
        b[TILE::TILE] = True
    elif layout == "between":
        b[3 * TILE - 1::3 * TILE] = True
    elif layout == "dense":
        b[TILE + 2:3 * TILE + 5] = True
    return b[:S]


def _any_program(rng, S, C, K, B):
    """Blocks of any meta (the shapes ``test_record_walk_exact_on_any_meta``
    draws), then: empty blocks (no valid lane), a tile with no miss, and a
    tile whose rank-0 ring wraps (a valid miss on a rank-0 bank in six of
    its steps)."""
    issue = rng.integers(0, 500, (S, C, K))
    meta = (rng.integers(0, B + 2, (S, C, K))
            | rng.choice([0, vec.META_MISS], (S, C, K), p=[0.8, 0.2])
            | rng.choice([0, vec.META_CONFL], (S, C, K))
            | rng.choice([0, vec.META_VALID, vec.META_VALID], (S, C, K))
            | (rng.integers(0, K, (S, C, K)) << vec.META_RB_SHIFT))
    meta[rng.random(S) < 0.1] &= ~vec.META_VALID
    meta[TILE:2 * TILE] &= ~vec.META_MISS
    wrap = 2 * TILE + np.arange(6)
    meta[wrap, :, 0] = (rng.integers(0, 2, (6, C)) | vec.META_MISS
                        | vec.META_VALID)
    return issue, meta


def _warm_state(rng, C, B, R):
    lo = vec.NEG_INF32
    return (_t(rng.integers(lo, 300, (C, B))), _t(rng.integers(lo, 300, (C, B))),
            _t(rng.integers(lo, 300, (C,))), _t(rng.integers(lo, 300, (C, R, 4))),
            _t(rng.integers(0, 4, (C, R))), _t(rng.integers(0, 300, (C,))))


LAYOUTS = ["inside", "edge", "first", "between", "dense"]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("K", [1, 8, 32])
@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("C", [1, 4])
def test_chunked_ref_equals_record_walk(C, R, K, layout):
    """The chunked serve's plain version (tiles of 8 steps, groups of 3
    pieces) against the record walk, bit for bit (finishes and the whole
    carry), from a warm carry: phase ends inside, on the edges of and
    across tiles, empty blocks, a tile with no miss and one whose ring
    wraps past 4, on blocks of any meta."""
    rng = np.random.default_rng([C, R, K, LAYOUTS.index(layout)])
    S, B = 5 * TILE + 3, 8
    issue, meta = _any_program(rng, S, C, K, B)
    streams = [_t(issue), _t(meta), _t(_phase_ends(layout, S, rng))]
    timing = _t(vec.timing_params(R_PRESETS["hitgraph"]().timing))
    state = _warm_state(rng, C, B, R)
    rec = serve_prepass_ref(*streams, timing, B // R, R, S + 1)
    assert int(((rec[:, 2 * TILE:3 * TILE, :, 1] & vec.META_MISS) != 0)
               .sum()) >= 6
    fin_w, st_w = serve_records_ref(rec, timing, state, S)
    fin_c, st_c = serve_records_chunked_ref(rec, timing, state, S, TILE,
                                            GROUP)
    assert torch.equal(fin_c, fin_w)
    for a, b in zip(st_c, st_w):
        assert torch.equal(a, b)


@pytest.mark.parametrize("preset", ["hitgraph", "accugraph"])
@pytest.mark.parametrize("shared", [True, False])
def test_chunked_batch_ref_shared_and_stacked(preset, shared):
    """Packed programs served for three timing cases, the program shared
    by every case or stacked (a program a case, phase ends on different
    steps): the chunked plain version equals the record walk case by
    case."""
    r_cfg = R_PRESETS[preset]()
    cfg = interop.dram_config(r_cfg)
    packs = [accel.pack_program(interop.segmented_trace(
        _random_serve_program(np.random.default_rng(41 + i), n_phases=4,
                              max_n=60, hit_heavy=True)), cfg)
             for i in range(1 if shared else 3)]
    S = min(p.n_steps for p in packs)
    fields = [[_t(getattr(p, f)[:S]) for p in packs]
              for f in ("issue", "meta", "boundary")]
    streams = [f[0] if shared else torch.stack(f) for f in fields]
    timing = _t(np.stack([vec.timing_params(r_cfg.timing)] * 3)
                + np.arange(3)[:, None])
    C, B, bpr = r_cfg.channels, packs[0].n_banks, packs[0].banks_per_rank
    state = vec._cold_batch_state(3, C, B, bpr, "cpu")
    rec = serve_prepass_batch_ref(*streams, timing, bpr, B // bpr, S)
    fin_w, st_w = serve_records_batch_ref(rec, timing, state, S)
    fin_c, st_c = serve_records_chunked_batch_ref(rec, timing, state, S,
                                                  TILE, GROUP)
    assert torch.equal(fin_c, fin_w)
    for a, b in zip(st_c, st_w):
        assert torch.equal(a, b)


HITGRAPH_TIMING = [list(vec.timing_params(R_PRESETS["hitgraph"]().timing))]


@pytest.mark.parametrize("args, route", [
    # HitGraph's full program from a cold carry
    ((745472, 4, 8, 16, 2, 10**6, 0, HITGRAPH_TIMING), "chunked"),
    # issues near the top of int32: a step could wrap
    ((745472, 4, 8, 16, 2, vec.MAX_PHASE_ISSUE - 1, 0, HITGRAPH_TIMING),
     "walk"),
    # too short to spread
    ((ops.CHUNKED_MIN_STEPS - 1, 4, 8, 16, 2, 0, 0, HITGRAPH_TIMING),
     "walk"),
    # a negative timing parameter or phase makespan
    ((8192, 1, 8, 16, 1, 0, 0, [[11, 11, 11, 28, -4, 5, 24]]), "walk"),
    ((8192, 1, 8, 16, 1, 0, -1, HITGRAPH_TIMING), "walk"),
    # a state vector past the kernels' width
    ((8192, 1, 8, 32, 1, 0, 0, HITGRAPH_TIMING), "walk"),
])
def test_serve_route(args, route):
    """The route reads the input's shape and values alone: long programs
    whose largest reachable time stays inside int32 take the chunked scan,
    the rest the record walk."""
    assert ops.serve_route(*args) == route


@pytest.mark.parametrize("near_edge", [False, True])
def test_check_routes_near_int32_to_the_walk(near_edge):
    """The serve's own check reads the bound with its range checks: the
    same long program from a carry whose bank times lie near 2^31 goes to
    the record walk, from a cold carry to the chunked scan; the plan also
    counts the phase ends."""
    rng = np.random.default_rng(9)
    S, C, K, B, R = 2 * ops.CHUNKED_MIN_STEPS, 4, 8, 16, 2
    issue = rng.integers(0, 5000, (S, C, K))
    meta = rng.integers(0, B, (S, C, K)) | vec.META_VALID
    boundary = np.zeros(S, dtype=bool)
    boundary[::500] = True
    timing = _t(vec.timing_params(R_PRESETS["hitgraph"]().timing))
    state = tuple(vec.init_lean_carry(C, B, B // R, "cpu")) + (
        torch.zeros(C, dtype=torch.int32),)
    if near_edge:
        state = (torch.full((C, B), 2**31 - 10**4, dtype=torch.int32),
                 ) + state[1:]
    *_, plan = ops._check(_t(issue), _t(meta), _t(boundary), timing, state)
    assert plan == ops.ServePlan("walk" if near_edge else "chunked",
                                 int(boundary.sum()))


def test_serve_records_chunks_on_the_cpu():
    """For CPU tensors the chunked route's wrapper is its plain version;
    a carry whose bus time lies near 2^31 is refused rather than served."""
    rng = np.random.default_rng(4)
    S, C, K, B, R = 3 * TILE + 1, 2, 4, 8, 2
    issue, meta = _any_program(rng, S, C, K, B)
    streams = [_t(issue), _t(meta), _t(_phase_ends("inside", S, rng))]
    timing = _t(vec.timing_params(R_PRESETS["hitgraph"]().timing))[None]
    state = tuple(x[None] for x in _warm_state(rng, C, B, R))
    rec = serve_prepass_batch_ref(*streams, timing, B // R, R, S + 1)
    fin, st, ms = ops.serve_records_chunks(rec, timing, state, S, 32)
    want = serve_records_batch_ref(rec, timing, state, S)
    assert ms is None and torch.equal(fin, want[0])
    assert all(torch.equal(a, b) for a, b in zip(st, want[1]))
    far = (state[0],) * 2 + (torch.full_like(state[2], 2**31 - 100),) + \
        state[3:]
    with pytest.raises(ValueError, match="int32 bound"):
        ops.serve_records_chunks(rec, timing, far, S, 32)
