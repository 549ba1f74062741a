"""The plain versions of the port's segment_reduce, edge_scatter and
spmv_ell kernels (and the ELL packers, the sliced one included) against
the JAX package's Pallas kernels, run through their ``ops.py`` in interpret mode on the same seeded
inputs, at the shapes, ops, dtypes and tolerances of
``tests/test_kernels.py``; and the wrappers' input checks."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.graphs.formats import CSR as RCSR
from repro.graphs.generators import rmat as r_rmat
from repro.kernels.edge_scatter.ops import edge_scatter as r_edge_scatter
from repro.kernels.segment_reduce.ops import (
    segment_reduce as r_segment_reduce)
from repro.kernels.spmv_ell.ops import csr_to_ell as r_csr_to_ell
from repro.kernels.spmv_ell.ops import spmv_ell as r_spmv_ell

from repro_torch import interop
from repro_torch.graphs.formats import CSR
from repro_torch.graphs.generators import rmat
from repro_torch.kernels.edge_scatter.ops import edge_scatter
from repro_torch.kernels.edge_scatter.ref import edge_scatter_ref
from repro_torch.kernels.segment_reduce.ops import segment_reduce
from repro_torch.kernels.segment_reduce.ref import segment_reduce_ref
from repro_torch.kernels.spmv_ell.ops import (CHUNK_SLOTS, HEAVY_SLOTS,
                                              csr_to_ell, pack_in_edges,
                                              spmv_ell, spmv_sell)
from repro_torch.kernels.spmv_ell.ref import spmv_ell_ref, spmv_sell_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,n,d", [(1000, 300, 1), (513, 128, 4),
                                   (128, 700, 2)])
def test_segment_reduce_vs_pallas(op, dtype, m, n, d):
    """Sums to rtol 1e-5 / atol 1e-4 in f32 and 5e-2 in bf16 (the
    Pallas kernel accumulates bf16 across blocks), min/max exactly; ids
    outside [0, n) match no segment in both."""
    rng = np.random.default_rng(0)
    ids = rng.integers(-2, n + 2, m).astype(np.int32)
    vals = rng.normal(size=(m, d)).astype(np.float32)
    if d == 1:
        vals = vals[:, 0]
    j_dtype, t_dtype = DTYPES[dtype]
    want = np.asarray(r_segment_reduce(ids, jnp.asarray(vals, j_dtype), n,
                                       op=op), np.float32)
    got = segment_reduce_ref(_t(ids), _t(vals, t_dtype), n, op)
    assert got.dtype == t_dtype and tuple(got.shape) == want.shape
    assert torch.equal(segment_reduce(_t(ids), _t(vals, t_dtype), n, op),
                       got)
    got = got.float().numpy()
    if op != "sum":
        np.testing.assert_array_equal(got, want)
    elif dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("seed", range(4))
def test_segment_reduce_sum_property(seed):
    rng = np.random.default_rng(seed)
    m, n = int(rng.integers(1, 400)), int(rng.integers(1, 300))
    ids = rng.integers(0, n, m).astype(np.int32)
    vals = rng.normal(size=(m,)).astype(np.float32)
    want = np.asarray(r_segment_reduce(ids, vals, n, op="sum"))
    got = segment_reduce_ref(_t(ids), _t(vals), n, "sum").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_segment_reduce_wcc_step_vs_pallas():
    """One synchronous WCC gather step (min), exactly."""
    g = rmat(8, 4, seed=0)
    vals = np.arange(g.n, dtype=np.float32)
    want = np.asarray(r_segment_reduce(g.dst, vals[g.src], g.n, op="min"))
    got = segment_reduce_ref(_t(g.dst.astype(np.int32)), _t(vals[g.src]),
                             g.n, "min")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op", ["copy", "add", "mul"])
@pytest.mark.parametrize("m,q", [(500, 256), (128, 1000), (77, 33)])
def test_edge_scatter_vs_pallas(op, m, q):
    """Bit for bit, with sources outside [0, q) that gather 0."""
    rng = np.random.default_rng(2)
    src = rng.integers(-2, q + 3, m).astype(np.int32)
    w = rng.integers(1, 5, m).astype(np.float32)
    vals = rng.normal(size=q).astype(np.float32)
    act = (rng.random(q) < 0.5).astype(np.float32)
    upd_w, valid_w = r_edge_scatter(src, w, vals, act, op=op)
    args = (_t(src), _t(w), _t(vals), _t(act))
    upd, valid = edge_scatter_ref(*args, op)
    np.testing.assert_array_equal(upd.numpy(), np.asarray(upd_w))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_w))
    upd2, valid2 = edge_scatter(*args, op)
    assert torch.equal(upd, upd2) and torch.equal(valid, valid2)


@pytest.mark.parametrize("seed", range(4))
def test_edge_scatter_add_property(seed):
    rng = np.random.default_rng(seed)
    m, q = int(rng.integers(1, 300)), int(rng.integers(1, 300))
    src = rng.integers(0, q, m).astype(np.int32)
    w = rng.normal(size=m).astype(np.float32)
    vals = rng.normal(size=q).astype(np.float32)
    act = np.ones(q, np.float32)
    upd_w, _ = r_edge_scatter(src, w, vals, act, op="add")
    upd, valid = edge_scatter_ref(_t(src), _t(w), _t(vals), _t(act), "add")
    np.testing.assert_array_equal(upd.numpy(), np.asarray(upd_w))
    np.testing.assert_array_equal(upd.numpy(), vals[src] + w)
    assert bool((valid == 1).all())


@pytest.mark.parametrize("n,k,nx", [(256, 4, 256), (100, 7, 333),
                                    (513, 2, 128)])
def test_spmv_ell_vs_pallas(n, k, nx):
    """rtol/atol 1e-4 as the JAX package's kernel test; padding ids (nx
    and beyond) carry nonzero values and still add 0."""
    rng = np.random.default_rng(3)
    cols = rng.integers(0, nx, (n, k)).astype(np.int32)
    pad = rng.random((n, k)) < 0.2
    cols[pad] = nx
    cols[rng.random((n, k)) < 0.05] = nx + 1000
    vals = rng.normal(size=(n, k)).astype(np.float32)
    x = rng.normal(size=nx).astype(np.float32)
    want = np.asarray(r_spmv_ell(cols, vals, x))
    got = spmv_ell_ref(_t(cols), _t(vals), _t(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert torch.equal(spmv_ell(_t(cols), _t(vals), _t(x)), got)


@pytest.mark.parametrize("k", [None, 3])
def test_csr_to_ell_equals_jax_package(k):
    """Same arrays, a truncating ``k`` included: the first k entries of
    a long row are kept."""
    r_g = r_rmat(8, 4, seed=4)
    r_g.weights = np.random.default_rng(5).integers(1, 10, r_g.m).astype(
        np.int32)
    r_csr = RCSR.from_graph(r_g)
    csr = CSR.from_graph(interop.graph(r_g))
    want_cols, want_vals = r_csr_to_ell(r_csr, k)
    cols, vals = csr_to_ell(csr, k)
    assert cols.dtype == want_cols.dtype and vals.dtype == want_vals.dtype
    np.testing.assert_array_equal(cols, want_cols)
    np.testing.assert_array_equal(vals, want_vals)
    np.testing.assert_array_equal(csr.degrees(), r_csr.degrees())


def test_csr_spmv_end_to_end_vs_pallas():
    """CSR rows are sources: y[i] = sum over out-neighbours x[j]."""
    g = rmat(8, 4, seed=4).with_unit_weights()
    csr = CSR.from_graph(g)
    csr.weights = np.ones(csr.m, np.float32)
    cols, vals = csr_to_ell(csr)
    x = np.arange(g.n, dtype=np.float32)
    y = spmv_ell_ref(_t(cols), _t(vals), _t(x)).numpy()
    expect = np.zeros(g.n)
    np.add.at(expect, g.src, x[g.dst])
    np.testing.assert_allclose(y, expect, rtol=1e-5)
    np.testing.assert_allclose(y, np.asarray(r_spmv_ell(cols, vals, x)),
                               rtol=1e-5)


def _in_edge_graph(n, hub_in, seed):
    """A small directed graph with one destination of ``hub_in``
    in-edges, a spread of light in-degrees, vertices with no in-edge and
    a light-row count that leaves the last slice partly full."""
    rng = np.random.default_rng(seed)
    light = rng.integers(0, n // 2, 5 * n)          # dsts < n / 2 only
    dst = np.concatenate([np.full(hub_in, n - 1), light,
                          np.arange(n // 2, n // 2 + 7)])
    src = rng.integers(0, n, len(dst))
    perm = rng.permutation(len(dst))
    return src[perm], dst[perm]


def _slot_rows(a):
    """The destination of every slot of a SlicedEll (-1 for padding
    rows), as the kernel reads the layout."""
    width = np.diff(a.slice_ptr.numpy()) // 32
    light = np.repeat(a.slice_rows.numpy().reshape(-1, 32), width, axis=0)
    heavy = np.repeat(a.chunk_rows.numpy(), np.diff(a.chunk_ptr.numpy()))
    return np.concatenate([light.ravel(), heavy])


@pytest.mark.parametrize("heavy,chunk", [(8, 4), (8, 32), (16, 1000),
                                         (4, 7)])
def test_pack_in_edges_spmv_vs_pallas(heavy, chunk):
    """The sliced ELL's plain SpMV against the JAX package's Pallas SpMV
    (interpret mode) over a ``csr_to_ell`` of the same in-edges, at the
    tolerance of ``test_csr_spmv_end_to_end_vs_pallas``; one in-degree
    far above the heavy threshold, empty rows, a partly full slice."""
    n = 300
    src, dst = _in_edge_graph(n, hub_in=heavy * 12, seed=heavy + chunk)
    w = np.random.default_rng(1).integers(1, 5, len(dst)).astype(
        np.float32)
    x = np.random.default_rng(2).random(n).astype(np.float32)
    a = pack_in_edges(src, dst, n, w, heavy=heavy, chunk=chunk)
    deg = np.bincount(dst, minlength=n)
    assert (deg == 0).any() and deg.max() >= 12 * heavy
    assert int((a.slice_rows < 0).sum()) > 0       # last slice partly full
    assert a.n_chunks >= 1 and a.n_slices >= 1
    order = np.argsort(dst, kind="stable")
    pointers = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=pointers[1:])
    cols, vals = r_csr_to_ell(RCSR(n, pointers, src[order], w[order]))
    want = np.asarray(r_spmv_ell(cols, vals, x))
    got = spmv_sell(a, _t(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert torch.equal(spmv_sell_ref(a, _t(x)), got)


@pytest.mark.parametrize("scale,heavy,chunk", [
    (9, 64, 50), (12, HEAVY_SLOTS, CHUNK_SLOTS), (12, HEAVY_SLOTS, 300)])
def test_pack_in_edges_equals_dense_product(scale, heavy, chunk):
    """The sliced-ELL packer on a skewed rmat: light slices of 32 rows,
    widest first, each padded to its widest row; heavy rows unpadded in
    chunks; every edge in exactly one slot; the SpMV equals a dense
    product."""
    g = rmat(scale, 8, seed=11)
    rng = np.random.default_rng(12)
    w = rng.random(g.m).astype(np.float32)
    x = rng.random(g.n).astype(np.float32)
    deg = g.in_degrees()
    a = pack_in_edges(g.src, g.dst, g.n, w, heavy=heavy, chunk=chunk)
    assert a.n_slices >= 5 and a.n_chunks >= int((deg >= heavy).sum()) > 0
    width = np.diff(a.slice_ptr.numpy()) // 32
    assert np.all(np.diff(width) <= 0)
    rows = a.slice_rows.numpy().reshape(-1, 32)
    for s, k in enumerate(width):
        r = rows[s][rows[s] >= 0]
        assert deg[r].max() == k and np.all(deg[r] < heavy)
    heavy_rows = a.chunk_rows.numpy()
    assert np.all(deg[heavy_rows] >= heavy)
    assert np.all(np.diff(heavy_rows) >= 0)
    assert np.all(np.diff(a.chunk_ptr.numpy()) <= chunk)
    lo = int(a.chunk_ptr[0])
    hcols = a.cols.numpy()[lo:]
    hrows = np.repeat(heavy_rows, np.diff(a.chunk_ptr.numpy()))
    assert np.all(np.diff(hrows * g.n + hcols) >= 0)  # by source in a row
    seen = np.concatenate([rows[rows >= 0], np.unique(heavy_rows)])
    np.testing.assert_array_equal(np.sort(seen), np.flatnonzero(deg))
    slot_rows = _slot_rows(a)
    cols = a.cols.numpy()
    real = cols < g.n
    assert int(real.sum()) == g.m
    np.testing.assert_array_equal(np.bincount(slot_rows[real],
                                              minlength=g.n), deg)
    assert np.all(a.vals.numpy()[~real] == 0)
    y = spmv_sell(a, _t(x)).numpy()
    dense = np.zeros((g.n, g.n))
    np.add.at(dense, (g.dst, g.src), w.astype(np.float64))
    np.testing.assert_allclose(y, dense @ x.astype(np.float64), rtol=1e-5,
                               atol=1e-6)


def test_pack_in_edges_keeps_edge_order_in_a_row():
    """Rows 0 (3 in-edges) and 2 (2 in-edges) share one column-major
    slice, each in edge-list order; with ``heavy=3`` row 0 is heavy and
    goes to chunks, its edges sorted by source."""
    src = np.array([5, 1, 4, 2, 3], dtype=np.int64)
    dst = np.array([0, 2, 0, 0, 2], dtype=np.int64)
    w = np.arange(1, 6, dtype=np.float32)
    a = pack_in_edges(src, dst, 6, w)
    assert a.n_slices == 1 and a.n_chunks == 0
    np.testing.assert_array_equal(a.slice_rows[:3], [0, 2, -1])
    np.testing.assert_array_equal(a.slice_ptr, [0, 96])
    cols = a.cols.numpy().reshape(3, 32)           # [slot, row]
    vals = a.vals.numpy().reshape(3, 32)
    np.testing.assert_array_equal(cols[:, 0], [5, 4, 2])
    np.testing.assert_array_equal(vals[:, 0], [1, 3, 4])
    np.testing.assert_array_equal(cols[:, 1], [1, 3, 6])
    np.testing.assert_array_equal(vals[:, 1], [2, 5, 0])
    assert np.all(cols[:, 2:] == 6)
    b = pack_in_edges(src, dst, 6, w, heavy=3, chunk=2)
    np.testing.assert_array_equal(b.slice_rows[:2], [2, -1])
    np.testing.assert_array_equal(b.chunk_rows, [0, 0])
    np.testing.assert_array_equal(b.chunk_ptr, [64, 66, 67])
    np.testing.assert_array_equal(b.cols[64:], [2, 4, 5])
    np.testing.assert_array_equal(b.vals[64:], [4, 3, 1])


def test_pack_in_edges_of_no_edges():
    a = pack_in_edges(np.zeros(0, np.int64), np.zeros(0, np.int64), 4,
                      np.zeros(0, np.float32))
    assert a.n_slices == 0 and a.n_chunks == 0 and a.cols.numel() == 0
    assert torch.equal(spmv_sell(a, torch.ones(4)), torch.zeros(4))


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("sorted_ids", [True, False])
def test_segment_reduce_long_runs_vs_pallas(op, sorted_ids):
    """Destination-sorted ids with runs longer than the card's 4,096-
    update tile (and out-of-range ids inside a run), as the HitGraph
    gather feeds them; the same ids shuffled.  Tolerances as
    ``test_segment_reduce_vs_pallas``."""
    rng = np.random.default_rng(7)
    n = 40
    lengths = rng.integers(0, 300, n)
    lengths[[3, 17]] = [9000, 5000]
    ids = np.repeat(np.arange(n), lengths).astype(np.int32)
    ids[rng.random(len(ids)) < 0.01] = -1
    ids[rng.random(len(ids)) < 0.01] = n + 3
    if not sorted_ids:
        ids = rng.permutation(ids)
    vals = rng.normal(size=len(ids)).astype(np.float32)
    want = np.asarray(r_segment_reduce(ids, vals, n, op=op), np.float32)
    got = segment_reduce(_t(ids), _t(vals), n, op)
    assert torch.equal(segment_reduce_ref(_t(ids), _t(vals), n, op), got)
    if op == "sum":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def _sell():
    return pack_in_edges(np.array([0, 1, 2]), np.array([1, 1, 2]), 3,
                         np.ones(3, np.float32), heavy=2, chunk=1)


def _i32(*a):
    return torch.tensor(a, dtype=torch.int32)


def _f32(*a):
    return torch.tensor(a, dtype=torch.float32)


@pytest.mark.parametrize("call,exc", [
    # dtypes
    (lambda: segment_reduce(_i32(0, 1).long(), _f32(1, 2), 2), TypeError),
    (lambda: segment_reduce(_i32(0, 1), _f32(1, 2).double(), 2),
     TypeError),
    (lambda: edge_scatter(_i32(0), _f32(1).double(), _f32(1), _f32(1)),
     TypeError),
    (lambda: edge_scatter(_i32(0).long(), _f32(1), _f32(1), _f32(1)),
     TypeError),
    (lambda: spmv_ell(_i32(0)[None].long(), _f32(1)[None], _f32(1)),
     TypeError),
    (lambda: spmv_ell(_i32(0)[None], _f32(1)[None], _f32(1).half()),
     TypeError),
    # devices
    (lambda: segment_reduce(_i32(0, 1), _f32(1, 2).to("meta"), 2),
     ValueError),
    (lambda: segment_reduce(_i32(0, 1).to("meta"), _f32(1, 2).to("meta"),
                            2), ValueError),
    (lambda: edge_scatter(_i32(0), _f32(1), _f32(1).to("meta"), _f32(1)),
     ValueError),
    (lambda: spmv_ell(_i32(0)[None], _f32(1)[None], _f32(1).to("meta")),
     ValueError),
    # ranges, shapes and ops
    (lambda: segment_reduce(_i32(0, 1), _f32(1, 2), -1), ValueError),
    (lambda: segment_reduce(_i32(0, 1), _f32(1, 2), 2**31), ValueError),
    (lambda: segment_reduce(_i32(0, 1), _f32(1, 2, 3), 2), ValueError),
    (lambda: segment_reduce(_i32(0, 1), _f32(1, 2), 2, "mean"),
     ValueError),
    (lambda: edge_scatter(_i32(0, 1), _f32(1), _f32(1), _f32(1)),
     ValueError),
    (lambda: edge_scatter(_i32(0), _f32(1), _f32(1), _f32(1), "div"),
     ValueError),
    (lambda: spmv_ell(_i32(0, 1)[None], _f32(1)[None], _f32(1)),
     ValueError),
    (lambda: spmv_ell(torch.zeros(2, 4, dtype=torch.int32)[:, ::2],
                      torch.zeros(2, 2), _f32(1)), ValueError),
    # the sliced ELL: x's dtype, shape and device, and the tables
    (lambda: spmv_sell(_sell(), torch.ones(3).double()), TypeError),
    (lambda: spmv_sell(_sell(), torch.ones(3, 1)), ValueError),
    (lambda: spmv_sell(_sell(), torch.ones(3).to("meta")), ValueError),
    (lambda: spmv_sell(dataclasses.replace(
        _sell(), slice_ptr=_sell().slice_ptr.int()), torch.ones(3)),
     ValueError),
    (lambda: spmv_sell(dataclasses.replace(
        _sell(), chunk_rows=_sell().chunk_rows.long()), torch.ones(3)),
     ValueError),
    (lambda: spmv_sell(dataclasses.replace(
        _sell(), chunk_rows=_sell().chunk_rows[:0]), torch.ones(3)),
     ValueError),
    (lambda: pack_in_edges(_i32(0), _i32(1), 3, _f32(1), heavy=0),
     ValueError),
])
def test_wrappers_reject_bad_inputs(call, exc):
    with pytest.raises(exc):
        call()
