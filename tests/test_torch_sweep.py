"""The round form of AccuGraph's asynchronous sweep.

``sweep_min_rounds_ref`` (the algorithm of ``csrc/sweep_min_rounds.cu``
in torch ops) against the sequential sweep ``sweep_min_ref`` and the JAX
package's ``_sweep_min`` scan on destination-sorted blocks; its round
counts on paths; the preconditions ``sweep_min_block`` enforces; and the
vertex-centric engine with its sweeps done by rounds against ``repro``.
Every value is an integer: all comparisons are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.algorithms import vertex_centric as r_vertex
from repro.algorithms.common import Problem as RProblem
from repro.graphs import generators as r_gen

from repro_torch import interop
from repro_torch.algorithms import vertex_centric
from repro_torch.algorithms.common import INF32, Problem
from repro_torch.kernels.sweep_min import ops
from repro_torch.kernels.sweep_min.ops import (SweepBlock, pack_sweep_block,
                                               sweep_min_block,
                                               sweep_min_ref,
                                               sweep_min_rounds,
                                               sweep_min_rounds_ref)


def _jax_sweep(values, src, dst, add):
    """The JAX package's scan, its edges padded to a power of two with
    (0, 0) self-loops as the package pads them (fewer recompiles)."""
    pad = lambda a: r_vertex._pad_to_bucket(a.astype(np.int32), 0)
    out = r_vertex._sweep_min(jnp.asarray(values), jnp.asarray(pad(src)),
                              jnp.asarray(pad(dst)), add=add)
    return np.asarray(out)


def _blocks(src, dst, n, q):
    """Block k: the edges whose source lies in [k q, (k + 1) q), stably
    sorted by destination (the engine's block order)."""
    for k in range(-(-n // q)):
        mine = np.flatnonzero(src // q == k)
        order = mine[np.argsort(dst[mine], kind="stable")]
        yield src[order], dst[order]


@settings(max_examples=40, deadline=None)
@given(n=st.sampled_from([1, 6, 17, 40]), m=st.integers(0, 150),
       seed=st.integers(0, 2**16), add=st.sampled_from([0, 1]),
       start=st.sampled_from(["arange", "root", "warm"]),
       q_div=st.sampled_from([1, 3]))
def test_rounds_equal_serial_and_jax(n, m, seed, add, start, q_div):
    """Random graphs with self-loops and duplicate edges, several blocks
    (q < n) or one, from WCC's start, BFS's (INF32 but the root) and a
    warm start that holds INF32: after every block, the rounds, the
    sequential sweep and the JAX scan agree."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    if m:
        src = np.concatenate([src, [src[0], dst[0]]])   # a duplicate and
        dst = np.concatenate([dst, [dst[0], dst[0]]])   # a self-loop
    if start == "arange":
        x = np.arange(n, dtype=np.int32)
    elif start == "root":
        x = np.full(n, INF32, dtype=np.int32)
        x[0] = 0
    else:
        x = rng.integers(0, 50, n).astype(np.int32)
        x[rng.random(n) < 0.3] = INF32
    q = max(1, -(-n // q_div))
    vals_s = torch.as_tensor(x)
    vals_r = vals_s.clone()
    for s, d in _blocks(src, dst, n, q):
        st_, dt_ = (torch.as_tensor(a.astype(np.int32)) for a in (s, d))
        want = _jax_sweep(vals_s.numpy(), s, d, add)
        sweep_min_ref(vals_s, st_, dt_, add)
        rounds = sweep_min_rounds_ref(vals_r, st_, dt_, add)
        np.testing.assert_array_equal(vals_s.numpy(), want)
        np.testing.assert_array_equal(vals_r.numpy(), want)
        assert 1 <= rounds <= n + 1


@pytest.mark.parametrize("problem", ["wcc", "bfs"])
@pytest.mark.parametrize("ascending", [True, False])
def test_path_round_counts(problem, ascending):
    """An ascending path needs a round a hop (n in all, the last one
    confirming); a descending one is settled by its first round (WCC:
    nothing changes) or its second (BFS from the far end)."""
    n = 50
    v = np.arange(1, n)
    src, dst = (v - 1, v) if ascending else (v, v - 1)
    order = np.argsort(dst, kind="stable")
    src_t, dst_t = (torch.as_tensor(a[order].astype(np.int32))
                    for a in (src, dst))
    if problem == "wcc":
        x = torch.arange(n, dtype=torch.int32)
    else:
        x = torch.full((n,), int(INF32), dtype=torch.int32)
        x[0 if ascending else n - 1] = 0
    add = 0 if problem == "wcc" else 1
    want = x.clone()
    sweep_min_ref(want, src_t, dst_t, add)
    got = x.clone()
    rounds = sweep_min_rounds_ref(got, src_t, dst_t, add)
    assert torch.equal(got, want)
    if ascending:
        assert rounds == n
    else:
        assert rounds == (1 if problem == "wcc" else 2)


def test_block_wrapper_runs_the_serial_sweep_on_cpu():
    g = r_gen.rmat(8, 4, seed=3)
    order = np.argsort(g.dst, kind="stable")
    block = pack_sweep_block(g.src[order], g.dst[order], g.n)
    # no sliced ELL on the CPU: only the card's round kernel reads one
    assert block.m == g.m and block.ell is None
    with pytest.raises(ValueError, match="no sliced ELL"):
        block.slots
    for add in (0, 1):
        vals = torch.arange(g.n, dtype=torch.int32)
        want = vals.clone()
        sweep_min_ref(want, block.src, block.dst, add)
        before = (sweep_min_rounds.launches, ops.sweep_min.launches)
        assert sweep_min_block(vals, block, add) == (0, "plain")
        assert (sweep_min_rounds.launches, ops.sweep_min.launches) == before
        assert torch.equal(vals, want)


def test_block_wrapper_rejects_its_preconditions():
    src = torch.tensor([0, 2, 1], dtype=torch.int32)
    dst = torch.tensor([1, 0, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="non-decreasing"):
        pack_sweep_block(src, dst, 3)
    good = pack_sweep_block(torch.tensor([1, 2, 0], dtype=torch.int32),
                            torch.tensor([0, 0, 2], dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="non-decreasing"):
        SweepBlock(3, src, dst)
    with pytest.raises(ValueError, match="out of range"):
        pack_sweep_block([0, 5], [1, 1], 3)
    vals = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="add >= 0"):
        sweep_min_block(vals, good, -1)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        sweep_min_block(torch.tensor([0, 2**31 - 1, 4], dtype=torch.int32),
                        good, 1)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        sweep_min_rounds_ref(torch.tensor([0, 2**31 - 1, 4],
                                          dtype=torch.int32),
                             good.src, good.dst, 1)
    with pytest.raises(ValueError, match="values for a block"):
        sweep_min_block(torch.zeros(4, dtype=torch.int32), good, 0)
    with pytest.raises(TypeError):
        sweep_min_block(vals, (good.src, good.dst), 0)


@pytest.mark.parametrize("max_rounds", [1, 3, 2**20])
def test_rounds_wrapper_status_on_cpu(max_rounds):
    """``sweep_min_rounds`` on CPU tensors runs the synchronous rounds,
    at most ``max_rounds``, and fills the kernel's status words: the last
    round that lowered a value (from 1), the rounds run, converged.  An
    ascending path of 12 vertices from the WCC start needs 12 rounds."""
    n = 12
    block = pack_sweep_block(np.arange(n - 1), np.arange(1, n), n)
    x0 = torch.arange(n, dtype=torch.int32)
    want = x0.clone()
    sweep_min_ref(want, block.src, block.dst, 0)
    vals, status = x0.clone(), torch.zeros(3, dtype=torch.int32)
    before = sweep_min_rounds.launches
    sweep_min_rounds(vals, x0.clone(), block, 0, max_rounds, status)
    assert sweep_min_rounds.launches == before
    if max_rounds >= n:
        assert status.tolist() == [n - 1, n, 1]
        assert torch.equal(vals, want)
    else:
        assert status.tolist() == [max_rounds, max_rounds, 0]
        assert not torch.equal(vals, want)
        # values only fall toward the serial result
        assert bool((vals >= want).all()) and bool((vals <= x0).all())


def _rounds_sweep(values, src, dst, add):
    sweep_min_rounds_ref(values, src, dst, add)


@pytest.mark.parametrize("problem", ["wcc", "bfs"])
@pytest.mark.parametrize("warm", [False, True])
def test_engine_by_rounds_equals_jax(monkeypatch, problem, warm):
    """``vertex_centric.run`` on several blocks (q = 64) with partition
    skipping, its sweeps done by the synchronous rounds, equals the JAX
    package's run: values, iterations and every change set; also from a
    warm start (``x0``/``active0``) as the dynamic path's repairs run."""
    monkeypatch.setattr(ops, "sweep_min_ref", _rounds_sweep)
    r_g = r_gen.rmat(8, 5, seed=102).undirected_view()
    kw = dict(q=64, block_skipping=True)
    if warm:
        full = r_vertex.run(r_g, RProblem(problem))
        x0 = np.asarray(full.values).copy()
        rng = np.random.default_rng(1)
        reset = rng.random(r_g.n) < 0.2
        x0[reset] = (np.arange(r_g.n, dtype=np.int32)[reset]
                     if problem == "wcc" else INF32)
        if problem == "bfs":
            x0[0] = 0
        kw.update(x0=x0, active0=reset)
    r_run = r_vertex.run(r_g, RProblem(problem), **kw)
    run = vertex_centric.run(interop.graph(r_g), Problem(problem),
                             device="cpu", **kw)
    np.testing.assert_array_equal(run.values, np.asarray(r_run.values))
    assert run.iterations == r_run.iterations
    for a, b in zip(run.per_iter, r_run.per_iter):
        np.testing.assert_array_equal(a.changed, b.changed)
        assert len(a.changed_per_block) == len(b.changed_per_block)
        for x, y in zip(a.changed_per_block, b.changed_per_block):
            assert (x is None) == (y is None)
            if y is not None:
                np.testing.assert_array_equal(x, y)
