"""``repro_torch.core.trace``'s merge and issue helpers (``dedup_lines``,
``rate_limited_issue``, ``_round_robin_positions``, ``round_robin_merge``,
``round_robin_merge_traces``, ``interleave_issue_ordered``) against
``repro.core.trace``'s on the same inputs, equal to the element and in
dtype, on fixed cases and on hypothesis draws of stream lengths."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import trace as JT
from repro_torch.core import trace as TT

SETTINGS = settings(max_examples=40, deadline=None)
LENGTHS = st.lists(st.integers(0, 40), min_size=0, max_size=6)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _same_trace(a, b):
    for f in ("line_addr", "is_write", "issue"):
        _same(getattr(a, f), getattr(b, f))


def _streams(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 50, size=n).astype(np.int64) for n in lens]


def _traces(mod, lens, seed):
    rng = np.random.default_rng(seed)
    out = []
    for n in lens:
        out.append(mod.Trace(rng.integers(0, 1 << 20, size=n),
                             rng.random(n) < 0.3,
                             np.sort(rng.integers(0, 500, size=n))))
    return out


@pytest.mark.parametrize("lines", [[], [7], [3, 3, 3], [1, 2, 2, 1, 1, 5],
                                   list(range(10))])
def test_dedup_lines(lines):
    _same(TT.dedup_lines(np.asarray(lines, dtype=np.int64)),
          JT.dedup_lines(np.asarray(lines, dtype=np.int64)))


@given(st.lists(st.integers(0, 6), max_size=80))
@SETTINGS
def test_dedup_lines_property(lines):
    _same(TT.dedup_lines(lines), JT.dedup_lines(lines))


@pytest.mark.parametrize("args", [
    (0, 10, 8.0, 16.0), (33, 0, 8.0, 16.0), (100, 7, 2.5, 16.0, 1.33),
    (64, 3, 16.0, 0.0, 2.0), (17, 5, 1e-12, 4.0, 0.75)])
def test_rate_limited_issue(args):
    _same(TT.rate_limited_issue(*args), JT.rate_limited_issue(*args))


@given(st.integers(0, 200), st.integers(0, 10**6),
       st.floats(0.01, 64.0), st.floats(0.0, 64.0), st.floats(0.1, 4.0))
@SETTINGS
def test_rate_limited_issue_property(n, start, epc, epl, ratio):
    _same(TT.rate_limited_issue(n, start, epc, epl, ratio),
          JT.rate_limited_issue(n, start, epc, epl, ratio))


@given(LENGTHS)
@SETTINGS
def test_round_robin_positions_property(lens):
    got = TT._round_robin_positions(lens)
    want = JT._round_robin_positions(lens)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _same(a, b)
    if lens:   # a permutation of the output slots
        _same(np.sort(np.concatenate(got)), np.arange(sum(lens),
                                                      dtype=np.int64))


@given(LENGTHS, st.integers(0, 2**16))
@SETTINGS
def test_round_robin_merge_property(lens, seed):
    _same(TT.round_robin_merge(_streams(lens, seed)),
          JT.round_robin_merge(_streams(lens, seed)))


@given(LENGTHS, st.integers(0, 2**16))
@SETTINGS
def test_round_robin_merge_traces_property(lens, seed):
    _same_trace(TT.round_robin_merge_traces(_traces(TT, lens, seed)),
                JT.round_robin_merge_traces(_traces(JT, lens, seed)))


@given(LENGTHS, st.integers(0, 2**16))
@SETTINGS
def test_interleave_issue_ordered_property(lens, seed):
    _same_trace(TT.interleave_issue_ordered(_traces(TT, lens, seed)),
                JT.interleave_issue_ordered(_traces(JT, lens, seed)))


@pytest.mark.parametrize("helper", ["round_robin_merge_traces",
                                    "interleave_issue_ordered"])
def test_no_traces(helper):
    _same_trace(getattr(TT, helper)([]), getattr(JT, helper)([]))


def test_trace_empty_and_concat():
    _same_trace(TT.Trace.empty(), JT.Trace.empty())
    ts, js = _traces(TT, [3, 0, 5], 1), _traces(JT, [3, 0, 5], 1)
    _same_trace(TT.Trace.concat(ts), JT.Trace.concat(js))
