"""The rule of ``csrc/cache_lookup.cu``'s thread path, held on the CPU.

For up to 32 ways the card's lookup keeps a set as its ways in recency
order: slot ``r`` holds the way whose age is ``r``.  A read whose tag one
slot holds moves that slot to the front and the slots before it down one;
a read that no slot holds takes the oldest slot (``W - 1``), which moves
to the front with the read's tag.  At the end each way's age is its slot.
Tags are compared in 32 bits.  Some sets leave that rule for the warp
path, which takes the reference's step (``_lookup_numpy``'s): from its
first read a row whose ages are not a permutation of ``0..W-1``, that
holds a tag outside 32 bits, or the same line (a tag >= 0) in two ways;
from that read on, a set where a read's tag is negative or 2**31 or more.

The kernel runs only on the card.  Here a test-local model of that rule
(:func:`recency_model`) is held to the plain version ``cache_lookup_ref``
and to ``repro``'s ``_lookup_numpy`` with hypothesis: random permutation
ages, ``-1`` tags, a hot set, tags past 2**31, W from 1 to 32, and rows
and reads that go to the warp path.  Every value is an integer: all
comparisons are exact.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import cache as r_cache

from repro_torch.kernels.cache_lookup.ref import cache_lookup_ref


def reference_step(tags, age, cur) -> bool:
    """One read through one row by ``_lookup_numpy``'s step (the warp
    path's rule); the row is updated in place, the hit returned."""
    W = len(tags)
    match = tags == cur
    h = bool(match.any())
    thresh = int(np.where(match, age, -1).max()) if h else W
    tgt = int(match.argmax()) if h else int(age.argmax())
    age += age < thresh
    age[tgt] = 0
    tags[tgt] = cur
    return h


def recency_model(seg_ptr, tag, pos, tags, age):
    """The thread path's rule over CSR segments (``tags`` / ``age``
    updated in place).  Returns the hits in program order and, a set
    each, the read from which the warp path serves it (its segment's end
    where the rule took every read)."""
    U, W = tags.shape
    hit = np.zeros(len(tag), dtype=bool)
    handed = []
    for u in range(U):
        b, e = int(seg_ptr[u]), int(seg_ptr[u + 1])
        i = b
        lines = tags[u][tags[u] >= 0]
        if (sorted(age[u].tolist()) == list(range(W))
                and all(-2**31 <= t < 2**31 for t in tags[u])
                and len(set(lines.tolist())) == len(lines)):
            order = np.argsort(age[u], kind="stable")
            slot_tag, slot_way = list(tags[u, order]), list(order)
            while i < e:
                if not 0 <= tag[i] < 2**31:
                    break
                held = [r for r in range(W) if slot_tag[r] == tag[i]]
                assert len(held) <= 1
                r = held[0] if held else W - 1
                slot_tag.pop(r)
                slot_tag.insert(0, tag[i])
                slot_way.insert(0, slot_way.pop(r))
                hit[pos[i]] = bool(held)
                i += 1
            tags[u, slot_way] = slot_tag
            age[u, slot_way] = np.arange(W)
        handed.append(i)
        for j in range(i, e):
            hit[pos[j]] = reference_step(tags[u], age[u], tag[j])
    return hit, handed


def _case(rng, U, W, n, hot, big, invalid, unsorted, negative,
          twice=0.0):
    """A set-sorted stream and a state: ``hot`` of the reads on set 0,
    tags from 3W values (near 2**31, half of them past it, with ``big``),
    ``invalid`` of the ways holding -1, ``unsorted`` of the rows with
    ages that are not a permutation, ``twice`` of the rows holding a line
    in two ways, ``negative`` of the reads with tag -1."""
    base = 2**31 - int(1.5 * W) if big else 0
    row = np.where(rng.random(n) < hot, 0, rng.integers(0, U, n))
    tag = base + rng.integers(0, 3 * W, n)
    tag[rng.random(n) < negative] = -1
    tags = np.stack([base + rng.permutation(3 * W)[:W] for _ in range(U)])
    tags[rng.random((U, W)) < invalid] = -1
    if W > 1:
        dup = rng.random(U) < twice
        tags[dup, 1] = tags[dup, 0] = base
    age = np.argsort(rng.random((U, W)), axis=1)
    odd = rng.random(U) < unsorted
    age[odd] = rng.integers(-2, W + 2, (int(odd.sum()), W))
    return row, tag.astype(np.int64), tags.astype(np.int64), age.astype(
        np.int64)


def _check(row, tag, tags0, age0):
    """The model against ``cache_lookup_ref`` and ``_lookup_numpy``:
    hits, tags and ages.  Returns the model's hand-over points."""
    U, W = tags0.shape
    order = np.argsort(row, kind="stable")
    seg_ptr = np.concatenate([[0], np.cumsum(np.bincount(row,
                                                         minlength=U))])
    tags_m, age_m = tags0.copy(), age0.copy()
    got, handed = recency_model(seg_ptr, tag[order],
                                order.astype(np.int32), tags_m, age_m)
    tags_t, age_t = torch.tensor(tags0), torch.tensor(age0)
    ref = cache_lookup_ref(torch.as_tensor(seg_ptr),
                           torch.as_tensor(tag[order]),
                           torch.as_tensor(order.astype(np.int32)),
                           tags_t, age_t)
    assert np.array_equal(got, ref.numpy())
    assert np.array_equal(tags_m, tags_t.numpy())
    assert np.array_equal(age_m, age_t.numpy())
    if len(tag):
        tag_m, valid_m, slot = r_cache._columns(U, row, tag)
        tags_r, age_r = tags0.copy(), age0.copy()
        want = r_cache._lookup_numpy(tags_r, age_r, tag_m, valid_m)
        assert np.array_equal(got, want[row, slot])
        assert np.array_equal(tags_m, tags_r)
        assert np.array_equal(age_m, age_r)
    return seg_ptr, handed


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**16), W=st.integers(1, 32),
       U=st.integers(1, 6), n=st.integers(0, 300),
       hot=st.sampled_from([0.0, 0.5, 0.95]), big=st.booleans(),
       invalid=st.sampled_from([0.0, 0.5, 1.0]),
       unsorted=st.sampled_from([0.0, 0.0, 0.3]),
       negative=st.sampled_from([0.0, 0.0, 0.05]),
       twice=st.sampled_from([0.0, 0.0, 0.3]))
def test_recency_order_equals_the_reference(seed, W, U, n, hot, big,
                                            invalid, unsorted, negative,
                                            twice):
    rng = np.random.default_rng(seed)
    _check(*_case(rng, U, W, n, hot, big, invalid, unsorted, negative,
                  twice))


@pytest.mark.parametrize("W", [1, 2, 3, 16, 31, 32])
def test_hot_set_stays_on_the_thread_path(W):
    """A valid state and line tags below 2**31 (what ``core/cache.py``
    gives): every set, the hot one with most of 3,000 reads included,
    is served by the recency rule to its end."""
    rng = np.random.default_rng(W)
    row, tag, tags, age = _case(rng, 8, W, 3000, 0.9, False, 0.5, 0.0, 0.0)
    seg_ptr, handed = _check(row, tag, tags, age)
    assert handed == list(seg_ptr[1:])
    assert np.bincount(row).max() > 2500


@pytest.mark.parametrize("W", [2, 16, 32])
def test_rows_and_reads_outside_the_rule_go_to_the_warp_path(W):
    """The warp path takes set 0 (ages not a permutation), set 3 (a tag
    past 2**31 in the row) and set 4 (a line in two ways) from their
    first read, set 1 from its -1 read and set 5 from its read past
    2**31; set 2 follows the rule to its end.  All equal the
    reference."""
    base = 7
    tags = np.full((6, W), -1, dtype=np.int64)
    tags[2] = base + np.arange(W)
    tags[3, 0] = 2**31
    tags[4, :2] = base + 1
    age = np.broadcast_to(np.arange(W), (6, W)).copy()
    age[0] = 0
    row = np.repeat(np.arange(6), 5)
    tag = np.array([base, base + 1, base, base + 2, base] * 6,
                   dtype=np.int64)
    tag[5] = -1
    tag[27] = 2**31 + 3
    seg_ptr, handed = _check(row, tag, tags, age)
    assert handed == [0, 5, 15, 15, 20, 27]
