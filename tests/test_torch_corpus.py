"""The port's graph corpus (``repro_torch.graphs.corpus`` and the parsers
and generators it builds on) against the JAX package's, on the CPU.

The cases of ``tests/test_corpus.py``, each held to ``repro`` with the
same inputs:

* the SNAP and MatrixMarket parsers: equal graphs, or the same
  :class:`GraphParseError` with the same message (file and line);
* the binary store: a round trip is bit-identical, a file written by
  either package loads in the other bit for bit (and both write the same
  bytes), bad magic, truncation, a version bump, an address change and a
  corrupt entry behave as in ``repro``;
* the ordering transforms: the edge multiset is kept, and every
  permutation and transformed graph equals ``repro``'s;
* every preset at ``scale=0.01`` (and ``karate``, ``road-grid`` and
  ``uniform-sparse`` at 1.0): arrays and fingerprint equal to ``repro``'s;
  the store keys, memoization, suffixes and typed errors;
* ``simulate`` / ``sweep`` / ``run_dynamic`` on names, equal to ``repro``
  field for field;
* a cheap subset of ``chip_smoke.py``'s phase-11 pins recomputed with
  ``repro``, so the pins cannot drift from the reference, and the
  phase's calls (``chip_smoke.corpus_runs``) through both packages at
  ``graph_scale=0.01``.

Every test keeps the disk store out (``REPRO_GRAPH_CACHE=0``) or gives
both packages a ``tmp_path`` store, so neither reads a graph the other
built, except where the cross-package load is the point.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.graphs import corpus as r_corpus
from repro.graphs import datasets as r_datasets
from repro.graphs import formats as r_formats
from repro.graphs import generators as r_gen
from repro.sim import Sweeper as RSweeper
from repro.sim import run_dynamic as r_run_dynamic
from repro.sim import simulate as r_simulate
from repro.sim import sweep as r_sweep

from repro_torch import interop
from repro_torch.errors import UnknownPresetError
from repro_torch.graphs import corpus, datasets
from repro_torch.graphs import generators as gen
from repro_torch.graphs.corpus import (CORPUS_CACHE_VERSION, GRAPH_PRESETS,
                                       CorpusCacheError, GraphStore,
                                       load_graph_binary, save_graph_binary)
from repro_torch.graphs.formats import (EdgeListPartitions, Graph,
                                        GraphParseError, load_matrix_market,
                                        load_snap_edgelist)
from repro_torch.sim import Sweeper, SweepCase, run_dynamic, simulate, sweep

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


@pytest.fixture(autouse=True)
def _no_disk_store(monkeypatch):
    monkeypatch.setenv("REPRO_GRAPH_CACHE", "0")


def assert_graph_equal(g, r_g):
    """``g`` (the port's) equals ``r_g`` (``repro``'s) array for array."""
    assert (g.n, g.m, g.directed, g.name) == (r_g.n, r_g.m, r_g.directed,
                                              r_g.name)
    assert np.array_equal(g.src, r_g.src) and g.src.dtype == r_g.src.dtype
    assert np.array_equal(g.dst, r_g.dst) and g.dst.dtype == r_g.dst.dtype
    if r_g.weights is None:
        assert g.weights is None
    else:
        assert g.weights.dtype == r_g.weights.dtype
        assert np.array_equal(g.weights, r_g.weights)
    assert g.fingerprint == r_g.fingerprint


def _row(row):
    d = row.as_dict()
    d.pop("wall_s")
    return d


def assert_rows_equal(rows, r_rows):
    assert len(rows) == len(r_rows)
    for row, r_row in zip(rows, r_rows):
        assert _row(row) == _row(r_row)
        assert row.report == interop.sim_report(r_row.report)


# ---- parsers ----------------------------------------------------------------

SNAP_CASES = [
    ("# comment\n\n0 1\n1 2\n2 0\n", None),
    ("0 1 2.5\n1 0 1.0\n", None),
    ("0 1\nx 2\n", r"g\.txt:2.*not an integer"),
    ("0 1\n-3 2\n", "negative"),
    ("0 1\n1 2 3 4\n", "columns"),
    ("0 1 2.0\n1 2\n", "inconsistent"),
    ("0 1\n1 2 2.0\n", "inconsistent"),
    ("# only comments\n", "no edges"),
    ("0 1 abc\n", "not a number"),
]

MM_HEADER = "%%MatrixMarket matrix coordinate real general\n"
MM_CASES = [
    (MM_HEADER + "% c\n3 3 2\n1 2 1.5\n3 1 2.0\n", None),
    ("%%MatrixMarket matrix coordinate pattern symmetric\n"
     "3 3 3\n2 1\n3 1\n2 2\n", None),
    ("%%MatrixMarket matrix coordinate integer symmetric\n"
     "4 4 3\n2 1 7\n4 3 9\n1 1 5\n", None),
    ("3 3 1\n1 2 1.0\n", "banner"),
    ("%%MatrixMarket matrix coordinate complex general\n"
     "2 2 1\n1 2 1.0 0.0\n", "complex"),
    ("%%MatrixMarket matrix array real general\n2 2\n1.0\n", "coordinate"),
    ("%%MatrixMarket matrix coordinate real hermitian\n2 2 1\n1 2 1\n",
     "symmetry"),
    ("%%MatrixMarket matrix\n", "malformed banner"),
    (MM_HEADER + "3 3\n", "size line"),
    (MM_HEADER + "3 3 1\n4 1 1.0\n", "1-based"),
    (MM_HEADER + "3 3 1\n0 1 1.0\n", "1-based"),
    (MM_HEADER + "3 3 0\n", "no edges"),
    (MM_HEADER + "3 3 3\n1 2 1.0\n", "nnz=3"),
    (MM_HEADER + "3 3 1\n1 2 1.0\n2 3 1.0\n", "more than"),
    (MM_HEADER + "0 3 1\n", "non-positive"),
    (MM_HEADER + "3 3 1\n1 2\n", "columns"),
    (MM_HEADER + "3 3 1\n1 2 x\n", "not a number"),
    (MM_HEADER + "% only a comment\n", "missing size line"),
]


def _both(parse, r_parse, path, match):
    """Run both parsers on ``path``: equal graphs, or the same typed error
    with the same message (matching ``match``)."""
    if match is None:
        assert_graph_equal(parse(path), r_parse(path))
        return
    with pytest.raises(GraphParseError, match=match) as got:
        parse(path)
    with pytest.raises(r_formats.GraphParseError) as want:
        r_parse(path)
    assert str(got.value) == str(want.value)
    assert (got.value.path, got.value.line_no) == (want.value.path,
                                                   want.value.line_no)
    assert isinstance(got.value, ValueError)


@pytest.mark.parametrize("text, match", SNAP_CASES)
def test_snap_parser_vs_jax(tmp_path, text, match):
    p = tmp_path / "g.txt"
    p.write_text(text)
    _both(load_snap_edgelist, r_formats.load_snap_edgelist, p, match)


def test_snap_parser_directed_flag_and_name(tmp_path):
    p = tmp_path / "edges.txt"
    p.write_text("0 3\n3 1\n")
    g = load_snap_edgelist(p, directed=False, name="und")
    assert_graph_equal(g, r_formats.load_snap_edgelist(p, directed=False,
                                                       name="und"))
    assert load_snap_edgelist(p).name == "edges"


@pytest.mark.parametrize("text, match", MM_CASES)
def test_matrix_market_parser_vs_jax(tmp_path, text, match):
    p = tmp_path / "m.mtx"
    p.write_text(text)
    _both(load_matrix_market, r_formats.load_matrix_market, p, match)


def test_parsers_on_the_shipped_karate_file():
    """The port's copy of the data file is the JAX package's, byte for
    byte, and parses to the same graph."""
    mine = ROOT / "src" / "repro_torch" / "graphs" / "data" / "karate.txt"
    theirs = ROOT / "src" / "repro" / "graphs" / "data" / "karate.txt"
    assert corpus._DATA_DIR == mine.parent
    assert mine.read_bytes() == theirs.read_bytes()
    assert_graph_equal(load_snap_edgelist(mine, directed=False,
                                          name="karate"),
                       r_formats.load_snap_edgelist(theirs, directed=False,
                                                    name="karate"))


def test_graph_helpers_vs_jax():
    r_g = r_gen.rmat(7, 4, seed=3)
    g = interop.graph(r_g)
    assert g.avg_degree == r_g.avg_degree
    for key in ("dst", "src"):
        assert_graph_equal(g.sorted_by(key), r_g.sorted_by(key))
    perm = np.random.default_rng(1).permutation(g.n)
    assert_graph_equal(g.relabeled(perm, name="p"),
                       r_g.relabeled(perm, name="p"))
    parts = EdgeListPartitions.build(g, 20)
    r_parts = r_formats.EdgeListPartitions.build(r_g, 20)
    assert parts.p == r_parts.p and parts.intervals == r_parts.intervals
    for k in range(parts.p):
        assert np.array_equal(parts.edge_index[k], r_parts.edge_index[k])
        for a, b in zip(parts.edges_in(k), r_parts.edges_in(k)):
            assert np.array_equal(a, b)


# ---- the binary store -------------------------------------------------------


def _graphs():
    """The store cases of tests/test_corpus.py, built by the port."""
    rng = np.random.default_rng(5)
    plain = gen.rmat(7, 4, seed=3)
    weighted_f = dataclasses.replace(plain, weights=rng.random(plain.m),
                                     name="wf")
    weighted_i = plain.with_unit_weights()
    undirected = gen.grid_road(9)
    return [plain, weighted_f, weighted_i, undirected]


@pytest.mark.parametrize("i", range(4))
def test_store_round_trip_bit_identical(tmp_path, i):
    g = _graphs()[i]
    p = tmp_path / f"g{i}.rgc"
    save_graph_binary(p, g, descriptor=f"test-{i}")
    lg = load_graph_binary(p)
    assert (lg.n, lg.m, lg.name, lg.directed) == (g.n, g.m, g.name,
                                                  g.directed)
    assert np.array_equal(lg.src, g.src) and np.array_equal(lg.dst, g.dst)
    if g.weights is None:
        assert lg.weights is None
    else:
        want = np.float64 if np.issubdtype(g.weights.dtype,
                                           np.floating) else np.int64
        assert np.array_equal(lg.weights, np.asarray(g.weights, dtype=want))
        assert lg.weights.dtype == want
    p2 = tmp_path / f"g{i}b.rgc"
    save_graph_binary(p2, lg, descriptor=f"test-{i}")
    assert p.read_bytes() == p2.read_bytes()


@pytest.mark.parametrize("i", range(4))
def test_store_files_load_across_packages(tmp_path, i):
    """A file written by either package loads in the other bit for bit,
    and both packages write the same bytes for the same graph."""
    g = _graphs()[i]
    r_g = r_formats.Graph(g.n, g.src, g.dst, g.weights, g.directed, g.name)
    ours, theirs = tmp_path / "ours.rgc", tmp_path / "theirs.rgc"
    save_graph_binary(ours, g, descriptor="k")
    r_corpus.save_graph_binary(theirs, r_g, descriptor="k")
    assert ours.read_bytes() == theirs.read_bytes()
    assert_graph_equal(interop.graph(r_corpus.load_graph_binary(ours)),
                       load_graph_binary(ours))
    assert_graph_equal(load_graph_binary(theirs),
                       r_corpus.load_graph_binary(theirs))


def test_store_bad_magic(tmp_path):
    p = tmp_path / "x.rgc"
    p.write_bytes(b"NOPE" + b"\x00" * 64)
    with pytest.raises(CorpusCacheError, match="magic") as got:
        load_graph_binary(p)
    with pytest.raises(r_corpus.CorpusCacheError) as want:
        r_corpus.load_graph_binary(p)
    assert str(got.value) == str(want.value)


def test_store_truncated_file(tmp_path):
    p = tmp_path / "x.rgc"
    save_graph_binary(p, _graphs()[0])
    p.write_bytes(p.read_bytes()[:-16])
    with pytest.raises(CorpusCacheError, match="truncated|expected") as got:
        load_graph_binary(p)
    with pytest.raises(r_corpus.CorpusCacheError) as want:
        r_corpus.load_graph_binary(p)
    assert str(got.value) == str(want.value)
    p.write_bytes(p.read_bytes()[:10])
    with pytest.raises(CorpusCacheError, match="truncated header"):
        load_graph_binary(p)


def test_store_version_bump_invalidates(tmp_path, monkeypatch):
    assert CORPUS_CACHE_VERSION == r_corpus.CORPUS_CACHE_VERSION == 3
    g = _graphs()[0]
    store = GraphStore(tmp_path)
    key = "preset;x=1"
    store.store(key, g)
    assert store.load(key) is not None
    old_path = store.path_for(key)
    monkeypatch.setattr(corpus, "CORPUS_CACHE_VERSION",
                        CORPUS_CACHE_VERSION + 1)
    assert store.path_for(key) != old_path
    assert store.load(key) is None
    stale = store.path_for(key)
    old_path.replace(stale)
    with pytest.raises(CorpusCacheError, match="version"):
        load_graph_binary(stale)
    assert store.load(key) is None


def test_store_addresses_equal_jax(tmp_path):
    store, r_store = GraphStore(tmp_path), r_corpus.GraphStore(tmp_path)
    keys = ["rmat;scale=16;seed=0", "rmat;scale=16;seed=1",
            GRAPH_PRESETS["karate"].key(1.0, 0),
            GRAPH_PRESETS["kron-social"].key(0.5, 3)]
    assert [store.path_for(k) for k in keys] == [r_store.path_for(k)
                                                 for k in keys]
    assert store.path_for(keys[0]) != store.path_for(keys[1])


def test_store_default_root(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_GRAPH_CACHE_DIR", str(tmp_path))
    assert GraphStore().root == r_corpus.GraphStore().root == tmp_path


def test_store_get_builds_once_then_hits(tmp_path):
    store = GraphStore(tmp_path)
    g = _graphs()[0]
    calls = []

    def build():
        calls.append(1)
        return g

    g1 = store.get("k", build)
    g2 = store.get("k", build)
    assert len(calls) == 1 and (store.builds, store.hits) == (1, 1)
    assert np.array_equal(g1.src, g2.src)


def test_store_corrupt_entry_rebuilt(tmp_path):
    store = GraphStore(tmp_path)
    g = _graphs()[0]
    store.store("k", g)
    store.path_for("k").write_bytes(b"garbage")
    assert np.array_equal(store.get("k", lambda: g).src, g.src)
    assert store.builds == 1 and load_graph_binary(store.path_for("k"))


def test_store_corrupt_name_field_rebuilt(tmp_path):
    store = GraphStore(tmp_path)
    g = _graphs()[0]
    store.store("k", g)
    p = store.path_for("k")
    data = bytearray(p.read_bytes())
    name_off = 4 + 4 + 8 + 8 + 1 + 4
    data[name_off:name_off + 2] = b"\xff\xff"
    p.write_bytes(bytes(data))
    with pytest.raises(CorpusCacheError, match="name") as got:
        load_graph_binary(p)
    with pytest.raises(r_corpus.CorpusCacheError) as want:
        r_corpus.load_graph_binary(p)
    assert str(got.value) == str(want.value)
    assert np.array_equal(store.get("k", lambda: g).src, g.src)


def test_store_read_only_root_stays_in_memory(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    store = GraphStore(blocker / "store")
    g = _graphs()[0]
    assert store.store("k", g) is None
    assert store.get("k", lambda: g) is g


# ---- ordering transforms ----------------------------------------------------


def _pair(kind, seed):
    if kind == "rmat":
        return gen.rmat(6, 4, seed=seed), r_gen.rmat(6, 4, seed=seed)
    if kind == "grid":
        return gen.grid_road(5 + seed % 4), r_gen.grid_road(5 + seed % 4)
    if kind == "uniform":
        return (gen.uniform_random(40, 160, seed=seed),
                r_gen.uniform_random(40, 160, seed=seed))
    return gen.chain(20 + seed % 10), r_gen.chain(20 + seed % 10)


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2**16),
       kind=st.sampled_from(["rmat", "grid", "uniform", "chain"]),
       transform=st.sampled_from(["degree", "bfs", "shuffle"]))
def test_transforms_keep_edge_multiset_and_equal_jax(seed, kind, transform):
    g, r_g = _pair(kind, seed)
    assert_graph_equal(g, r_g)
    t = corpus.TRANSFORMS[transform](g)
    assert_graph_equal(t, r_corpus.TRANSFORMS[transform](r_g))
    perm = {"degree": corpus.degree_perm, "bfs": corpus.bfs_perm,
            "shuffle": corpus.shuffle_perm}[transform](g)
    r_perm = {"degree": r_corpus.degree_perm, "bfs": r_corpus.bfs_perm,
              "shuffle": r_corpus.shuffle_perm}[transform](r_g)
    assert np.array_equal(perm, r_perm) and perm.dtype == r_perm.dtype
    inv = np.empty(g.n, dtype=np.int64)
    inv[perm] = np.arange(g.n)
    back = t.relabeled(inv)
    assert np.array_equal(back.src, g.src)
    assert np.array_equal(back.dst, g.dst)
    assert sorted(zip(t.src.tolist(), t.dst.tolist())) == sorted(
        zip(perm[g.src].tolist(), perm[g.dst].tolist()))
    assert sorted(t.out_degrees().tolist()) == sorted(
        g.out_degrees().tolist())


@pytest.mark.parametrize("by", ["out", "in", "total"])
def test_degree_perm_by_vs_jax(by):
    g = gen.degree_matched(200, 2000, skew=1.0, seed=1)
    r_g = r_gen.degree_matched(200, 2000, skew=1.0, seed=1)
    assert np.array_equal(corpus.degree_perm(g, by),
                          r_corpus.degree_perm(r_g, by))
    with pytest.raises(ValueError, match="by must be"):
        corpus.degree_perm(g, "both")


def test_degree_sort_puts_hubs_first():
    t = corpus.degree_sort(gen.degree_matched(200, 2000, skew=1.0, seed=1))
    deg = t.out_degrees() + t.in_degrees()
    assert deg[0] == deg.max() and t.name.endswith("+degsort")


@pytest.mark.parametrize("root", [0, 7, 35])
def test_bfs_perm_vs_jax(root):
    g, r_g = gen.grid_road(6), r_gen.grid_road(6)
    perm = corpus.bfs_perm(g, root=root)
    assert perm[root] == 0 and sorted(perm.tolist()) == list(range(g.n))
    assert np.array_equal(perm, r_corpus.bfs_perm(r_g, root=root))
    # unreached vertices (another component) keep their order after it
    two = Graph(6, [0, 1, 3, 4], [1, 0, 4, 3], directed=False)
    r_two = r_formats.Graph(6, two.src, two.dst, directed=False)
    assert np.array_equal(corpus.bfs_perm(two), r_corpus.bfs_perm(r_two))


def test_perm_shape_checked():
    with pytest.raises(ValueError, match="shape"):
        gen.chain(10).relabeled(np.arange(5))


# ---- generators and presets -------------------------------------------------


@pytest.mark.parametrize("scale, deg, seed, noise", [
    (7, 4, 9, 0.1), (7, 4, 10, 0.1), (9, 12, 0, 0.0), (6, 3, 5, 0.4)])
def test_kronecker_equals_jax(scale, deg, seed, noise):
    g = gen.kronecker(scale, deg, noise=noise, seed=seed)
    assert_graph_equal(g, r_gen.kronecker(scale, deg, noise=noise,
                                          seed=seed))
    again = gen.kronecker(scale, deg, noise=noise, seed=seed)
    assert np.array_equal(g.src, again.src)
    init = (0.5, 0.2, 0.2, 0.1)
    assert_graph_equal(gen.kronecker(scale, deg, initiator=init, seed=seed),
                       r_gen.kronecker(scale, deg, initiator=init,
                                       seed=seed))


def test_kronecker_seed_changes_graph():
    assert not np.array_equal(gen.kronecker(7, 4, seed=9).src,
                              gen.kronecker(7, 4, seed=10).src)


@pytest.mark.parametrize("side", [8, 9, 31])
def test_grid_road_and_chain_equal_jax(side):
    assert_graph_equal(gen.grid_road(side, name="g"),
                       r_gen.grid_road(side, name="g"))
    assert_graph_equal(gen.chain(side), r_gen.chain(side))


def test_roadnet_stand_in_equals_jax():
    g = datasets.instantiate("rd", scale=0.01, seed=2)
    assert_graph_equal(g, r_datasets.instantiate("rd", scale=0.01, seed=2))
    assert not g.directed and g.name == "roadnet-ca"


@pytest.mark.parametrize("name", sorted(r_corpus.GRAPH_PRESETS))
def test_preset_equals_jax(name):
    preset, r_preset = GRAPH_PRESETS[name], r_corpus.GRAPH_PRESETS[name]
    assert preset == interop.graph_preset(r_preset)
    for scale, seed in ((0.01, 0), (0.01, 3), (0.5, 1)):
        assert preset.key(scale, seed) == r_preset.key(scale, seed)
    g = preset.build(scale=0.01)
    assert g.n >= 8 and g.m >= 8
    assert_graph_equal(g, r_preset.build(scale=0.01))
    assert_graph_equal(preset.build(scale=0.01, seed=3),
                       r_preset.build(scale=0.01, seed=3))


@pytest.mark.parametrize("name", ["karate", "road-grid", "uniform-sparse"])
def test_preset_full_size_equals_jax(name):
    g = GRAPH_PRESETS[name].build(scale=1.0)
    assert_graph_equal(g, r_corpus.GRAPH_PRESETS[name].build(scale=1.0))


def test_karate_is_file_parsed_and_real():
    g = GRAPH_PRESETS["karate"].build()
    assert (g.n, g.m) == (34, 156) and not g.directed


def test_unknown_preset_family_raises():
    bad = corpus.GraphPreset("x", "zip")
    with pytest.raises(ValueError, match="unknown preset family"):
        bad.build()


# ---- resolution -------------------------------------------------------------


def test_resolution_is_memoized_per_transform_scale_seed():
    g1 = corpus.resolve_graph("rmat-16", scale=0.01)
    assert corpus.resolve_graph("rmat-16", scale=0.01) is g1
    assert corpus.resolve_graph("rmat-16", scale=0.01, seed=1) is not g1
    assert corpus.resolve_graph("rmat-16:bfs", scale=0.01) is not g1


def test_resolution_uses_and_fills_the_store(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_GRAPH_CACHE", "1")
    store = GraphStore(tmp_path)
    g = corpus.resolve_graph("uniform-sparse:shuffle", scale=0.004,
                             seed=11, store=store)
    assert (store.builds, store.hits) == (1, 0)
    base = corpus.resolve_graph("uniform-sparse", scale=0.004, seed=11,
                                store=store)
    assert (store.builds, store.hits) == (1, 1)
    r_base = r_corpus.GRAPH_PRESETS["uniform-sparse"].build(scale=0.004,
                                                            seed=11)
    assert_graph_equal(base, r_base)
    assert_graph_equal(g, r_corpus.shuffle(r_base))
    # the file the port wrote is the JAX package's store entry, bit for bit
    key = GRAPH_PRESETS["uniform-sparse"].key(0.004, 11)
    assert_graph_equal(
        interop.graph(r_corpus.GraphStore(tmp_path).load(key)), base)


@pytest.mark.parametrize("suffix, tail", [("degree", "+degsort"),
                                          ("bfs", "+bfsorder"),
                                          ("shuffle", "+shuffle")])
def test_transform_suffix_equals_jax(suffix, tail):
    g = corpus.resolve_graph(f"powerlaw-social:{suffix}", scale=0.01)
    r_g = r_corpus.resolve_graph(f"powerlaw-social:{suffix}", scale=0.01)
    assert g.name == "powerlaw-social" + tail
    assert_graph_equal(g, r_g)
    assert corpus.graph_name(f"powerlaw-social:{suffix}") == (
        r_corpus.graph_name(f"powerlaw-social:{suffix}"))


def test_unknown_preset_and_transform_typed():
    with pytest.raises(UnknownPresetError, match="unknown graph preset"):
        corpus.resolve_graph("no-such-graph")
    with pytest.raises(UnknownPresetError, match="unknown graph transform"):
        corpus.resolve_graph("karate:zorder")
    with pytest.raises(TypeError, match="preset name"):
        corpus.resolve_graph(42)


def test_graph_passthrough_and_name():
    g = gen.chain(10)
    assert corpus.resolve_graph(g) is g
    assert corpus.graph_name(g) == "chain"


def test_dataset_presets_keep_preset_name():
    g = corpus.resolve_graph("lj-sample", scale=0.2)
    assert g.name == "lj-sample"
    assert_graph_equal(g, r_corpus.resolve_graph("lj-sample", scale=0.2))


def test_graph_variants_equal_jax():
    gs = corpus.graph_variants(("karate", "road-grid"), scale=0.01)
    r_gs = r_corpus.graph_variants(("karate", "road-grid"), scale=0.01)
    assert [g.name for g in gs] == ["karate", "road-grid"]
    for g, r_g in zip(gs, r_gs):
        assert_graph_equal(g, r_g)


def test_fingerprint_tracks_content():
    a, b = gen.chain(10), gen.chain(10)
    assert a.fingerprint == b.fingerprint
    assert dataclasses.replace(a, name="o").fingerprint != a.fingerprint


# ---- the entry points on names ----------------------------------------------


def test_sweep_accepts_preset_names_equal_jax():
    kw = dict(graphs=("karate", "road-grid", "rmat-16:degree"),
              problems=("wcc", "pr"), accelerators=("hitgraph",),
              graph_scale=0.01)
    sw, r_sw = Sweeper(device=CPU), RSweeper()
    rows = sweep(sweeper=sw, **kw)
    assert [r.graph_name for r in rows] == [
        "karate", "karate", "road-grid", "road-grid",
        "rmat-16+degsort", "rmat-16+degsort"]
    assert_rows_equal(rows, r_sweep(sweeper=r_sw, **kw))
    assert all(r.report.runtime_ms > 0 for r in rows)
    for f in ("cases", "algo_runs", "algo_cache_hits", "pack_cache_hits",
              "pack_cache_misses"):
        assert getattr(sw.stats, f) == getattr(r_sw.stats, f), f


def test_sessions_shared_across_equal_graphs():
    g1, g2 = gen.rmat(6, 4, seed=4), gen.rmat(6, 4, seed=4)
    assert g1 is not g2
    sw = Sweeper(device=CPU)
    sw.run([SweepCase(graph=g1, problem="wcc"),
            SweepCase(graph=g2, problem="wcc")])
    assert (sw.stats.algo_runs, sw.stats.algo_cache_hits) == (1, 1)
    # one name resolves to one object, so cases naming it share a session
    a = SweepCase("road-grid", "wcc", graph_scale=0.01)
    assert a.graph is SweepCase("road-grid", "bfs", graph_scale=0.01).graph


@pytest.mark.parametrize("scale, seed", [(0.01, 0), (0.02, 5)])
def test_sweepcase_graph_scale_and_seed_equal_jax(scale, seed):
    kw = dict(graphs=["powerlaw-social"], problems=["wcc"],
              accelerators=["accugraph"], graph_scale=scale,
              graph_seed=seed)
    rows = sweep(device=CPU, **kw)
    assert_rows_equal(rows, r_sweep(**kw))
    assert rows[0].case.graph.fingerprint == r_sweep(**kw)[
        0].case.graph.fingerprint


@pytest.mark.parametrize("accelerator", ["hitgraph", "accugraph"])
def test_simulate_accepts_preset_name_equal_jax(accelerator):
    r = simulate("karate", "wcc", accelerator=accelerator, device=CPU)
    assert r.runtime_ms > 0
    assert r == interop.sim_report(r_simulate("karate", "wcc",
                                              accelerator=accelerator))


@pytest.mark.parametrize("accelerator", ["hitgraph", "accugraph"])
def test_run_dynamic_on_names_equal_jax(accelerator):
    kw = dict(updates="uniform-churn", accelerator=accelerator,
              graph_scale=0.01, graph_seed=2)
    res = run_dynamic("powerlaw-social:degree", "wcc", device=CPU, **kw)
    want = interop.dynamic_result(r_run_dynamic("powerlaw-social:degree",
                                                "wcc", **kw))
    assert res.epochs == want.epochs and res.report == want.report
    assert_graph_equal(res.final_graph, want.final_graph)


# ---- the phase-11 pins of chip_smoke.py -------------------------------------


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_chip_smoke_graph_pins_equal_jax_and_port(smoke):
    """Every phase-11 graph at full size: ``repro``'s and the port's
    name, size and fingerprint equal the pins."""
    for sel, pin in smoke.CORPUS_GRAPHS.items():
        assert smoke.graph_pin(r_corpus.resolve_graph(sel)) == pin, sel
        assert smoke.graph_pin(corpus.resolve_graph(sel)) == pin, sel


def test_chip_smoke_row_pins_equal_jax(smoke):
    """Karate's rows of the grid and its BRAM row, and one generator
    preset's WCC rows, recomputed with ``repro`` (and, for karate, the
    port on the CPU) against the pins."""
    kw = dict(problems=smoke.CORPUS_PROBLEMS,
              accelerators=smoke.CORPUS_ACCELERATORS,
              memories=smoke.CORPUS_MEMORIES, fixed_iters=None)
    checked = 0
    for sel, problems in (("karate", smoke.CORPUS_PROBLEMS),
                          ("kron-social", ("wcc",))):
        rows = r_sweep(graphs=[sel], **dict(kw, problems=problems))
        for r in rows:
            key = (sel, r.case.problem.value, r.report.system, r.memory,
                   r.cache)
            assert smoke.report_pin(r.report) == smoke.CORPUS_PINS[key], key
            checked += 1
    bram = r_simulate("karate", "wcc", accelerator="accugraph",
                      cache="default")
    assert smoke.report_pin(bram) == smoke.CORPUS_PINS[
        "karate", "wcc", "accugraph", "default", "default"]
    mine = sweep(graphs=["karate"], device=CPU, **kw)
    for r in mine:
        key = ("karate", r.case.problem.value, r.report.system, r.memory,
               r.cache)
        assert smoke.report_pin(r.report) == smoke.CORPUS_PINS[key], key
    assert checked == 12


def test_chip_smoke_phase_runs_equal_jax_at_small_scale(smoke):
    """Phase 11's calls (``chip_smoke.corpus_runs``) through both packages
    at ``graph_scale=0.01``, the port on the CPU: every graph, row pin,
    sweeper counter, contract direction, warning and epoch equal."""
    from repro import sim as r_sim
    from repro_torch import sim
    got = smoke.corpus_runs(sim, scale=0.01, device=CPU)
    want = smoke.corpus_runs(r_sim, scale=0.01)

    def pins(out):
        rows = smoke.corpus_keyed(out)
        return {
            "graphs": {s: smoke.graph_pin(g)
                       for s, g in out["graphs"].items()},
            "rows": {k: smoke.report_pin(r.report) for k, r in rows.items()},
            "stats": out["stats"], "contracts": smoke.corpus_contracts(rows),
            "spec": smoke.report_pin(out["spec"]),
            "warnings": out["spec_warnings"],
            "dynamic": smoke.report_pin(out["dynamic"].report),
            "epochs": [smoke.epoch_pin(e) for e in out["dynamic"].epochs]}

    mine, theirs = pins(got), pins(want)
    assert len(mine["rows"]) == 64 and len(mine["graphs"]) == 11
    for part in theirs:
        assert mine[part] == theirs[part], part
    assert got["spec"] == got["spec_keywords"]
    assert got["dynamic_spec"] == got["dynamic"].report
    assert len(got["spec_warnings"]) == 1
