"""The port's distributed edge-centric engine
(``repro_torch.algorithms.distributed``: HitGraph's crossbar as one
``all_to_all_single``) against the JAX package's ``shard_map`` engine and
the reference algorithms, on the CPU.

One shard in this process; then 2, 4 and 8 ranks, each a process of its
own in one gloo group (rendezvous through a ``FileStore`` in
``tmp_path``, so concurrent test workers never share a port).  Every
multi-process run has its own timeout: a hung rendezvous fails its test.
The graph of the 2- and 4-rank runs has a vertex count that the ranks do
not divide and skewed edge counts per rank (the padded edges of every rank
above 0 point outside its interval), a component that crosses every
interval, and an SSSP root above rank 0's interval.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.algorithms import distributed as R_DG
from repro.algorithms import reference as r_ref
from repro.graphs.formats import Graph as RGraph
from repro.graphs.generators import rmat as r_rmat

from repro_torch import interop
from repro_torch.algorithms import distributed as DG
from repro_torch.algorithms import reference as ref
from repro_torch.algorithms.common import INF32

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 180

#: one rank of a gloo group: loads the graph, runs the engine on the CPU,
#: prints the results as JSON on its last line
RANK_SCRIPT = r"""
import datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.algorithms import distributed as DG
from repro_torch.graphs.formats import Graph

rank, world, store, path, root = sys.argv[1:6]
rank, world, root = int(rank), int(world), int(root)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
try:
    with np.load(path) as f:
        g = Graph(int(f["n"]), f["src"], f["dst"])
    stats = {}
    out = {"wcc": DG.run_wcc(g, device="cpu", stats=stats).tolist(),
           "stats": stats}
    if root >= 0:
        out["sssp"] = DG.run_sssp(g, root=root, device="cpu").tolist()
    print(json.dumps(out))
finally:
    dist.destroy_process_group()
"""


def run_ranks(world, g, tmp_path, root=-1):
    """Run :data:`RANK_SCRIPT` on ``world`` processes of one gloo group on
    ``g``; returns each rank's parsed output."""
    path = str(tmp_path / "graph.npz")
    np.savez(path, n=g.n, src=g.src, dst=g.dst)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(r), str(world),
         str(tmp_path / "store"), path, str(root)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [json.loads(out.splitlines()[-1]) for out, _ in outs]


def uneven_graph(scale, degree, seed, n):
    """``repro``'s rmat graph cut to its first ``n`` vertices, undirected."""
    g = r_rmat(scale, degree, seed=seed)
    keep = (g.src < n) & (g.dst < n)
    return RGraph(n, g.src[keep], g.dst[keep]).undirected_view()


def giant_root(r_g, lo):
    """The first vertex at or above ``lo`` in vertex 0's component."""
    labels = r_ref.wcc(r_g)
    return int(np.flatnonzero((labels == 0)
                              & (np.arange(r_g.n) >= lo))[0])


def test_single_device_wcc():
    r_g = r_rmat(8, 4, seed=1)
    g = interop.graph(r_g).undirected_view()
    labels = DG.run_wcc(g, device="cpu")
    assert labels.dtype == np.int32
    np.testing.assert_array_equal(labels, r_ref.wcc(r_g))
    np.testing.assert_array_equal(labels, R_DG.run_wcc(r_g.undirected_view()))
    np.testing.assert_array_equal(labels, ref.wcc(interop.graph(r_g)))


def test_single_device_sssp():
    r_g = r_rmat(8, 4, seed=2).with_unit_weights()
    g = interop.graph(r_g)
    dist = DG.run_sssp(g, root=0, device="cpu")
    np.testing.assert_array_equal(dist, R_DG.run_sssp(r_g, root=0))
    expect = r_ref.sssp(r_g, 0)
    reach = expect < np.iinfo(np.int64).max // 8
    np.testing.assert_array_equal(dist[reach].astype(np.int64),
                                  expect[reach])
    assert (dist[~reach] == INF32).all()


@pytest.mark.parametrize("problem", ["wcc", "sssp"])
def test_single_shard_on_uneven_graph_vs_jax(problem):
    """The graph the multi-rank runs use, in one shard: equal to the JAX
    engine (weighted SSSP too) and to the reference."""
    r_g = uneven_graph(10, 4, 5, 1001)
    g = interop.graph(r_g)
    if problem == "wcc":
        got = DG.run_wcc(g, device="cpu")
        np.testing.assert_array_equal(got, R_DG.run_wcc(r_g))
        np.testing.assert_array_equal(got, r_ref.wcc(r_g))
    else:
        w = np.random.default_rng(0).integers(1, 9, r_g.m).astype(np.int32)
        r_gw = RGraph(r_g.n, r_g.src, r_g.dst, weights=w)
        root = giant_root(r_g, 502)
        got = DG.run_sssp(interop.graph(r_gw), root=root, device="cpu")
        np.testing.assert_array_equal(got, R_DG.run_sssp(r_gw, root=root))


def test_no_group_means_one_shard():
    g = interop.graph(r_rmat(7, 4, seed=4)).undirected_view()
    stats = {}
    DG.run_wcc(g, device="cpu", stats=stats)
    assert stats["shards"] == 1 and stats["q"] == g.n
    assert stats["iterations"] >= 1


def test_shard_edges_equal_jax():
    r_g = uneven_graph(9, 4, 6, 500).with_unit_weights()
    for S in (1, 3, 4):
        got = DG.shard_edges(interop.graph(r_g), S, weighted=True)
        want = R_DG.shard_edges(r_g, S, weighted=True)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_eight_shard_equivalence(tmp_path):
    r_g = r_rmat(9, 4, seed=3)
    outs = run_ranks(8, interop.graph(r_g).undirected_view(), tmp_path)
    expect = r_ref.wcc(r_g)
    for o in outs:
        assert o["stats"]["shards"] == 8
        np.testing.assert_array_equal(o["wcc"], expect)


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_ranks_on_uneven_shards(world, tmp_path):
    """WCC and SSSP over ``world`` gloo ranks equal the one-shard JAX
    engine and the reference on every rank."""
    r_g = uneven_graph(10, 4, 5, 1001)
    assert r_g.n % world
    # above rank 0's interval (q = 501 for 2 ranks); an inner one for 4
    root = giant_root(r_g, 502)
    outs = run_ranks(world, interop.graph(r_g), tmp_path, root=root)
    want_wcc = R_DG.run_wcc(r_g)
    want_sssp = R_DG.run_sssp(r_g, root=root)
    np.testing.assert_array_equal(want_wcc, r_ref.wcc(r_g))
    expect = r_ref.sssp(r_g.with_unit_weights(), root)
    reach = expect < np.iinfo(np.int64).max // 8
    np.testing.assert_array_equal(want_sssp[reach].astype(np.int64),
                                  expect[reach])
    # components span several intervals, and the root's reach too
    q = -(-r_g.n // world)
    assert len(np.unique(np.flatnonzero(want_wcc == 0) // q)) == world
    assert len(np.unique(np.flatnonzero(reach) // q)) == world
    for o in outs:
        assert o["stats"]["shards"] == world and o["stats"]["q"] == q
        np.testing.assert_array_equal(o["wcc"], want_wcc)
        np.testing.assert_array_equal(o["sssp"], want_sssp)


def test_backend_device_pairing_is_checked(monkeypatch):
    """A gloo group takes CPU tensors and an NCCL group CUDA ones; nothing
    is staged through the host."""
    import torch
    monkeypatch.setattr(DG.dist, "get_backend", lambda group: "gloo")
    with pytest.raises(ValueError, match="gloo group takes cpu"):
        DG._check_backend(object(), torch.device("cuda"))
    DG._check_backend(object(), torch.device("cpu"))
    monkeypatch.setattr(DG.dist, "get_backend", lambda group: "nccl")
    with pytest.raises(ValueError, match="nccl group takes cuda"):
        DG._check_backend(object(), torch.device("cpu"))
    monkeypatch.setattr(DG.dist, "get_backend", lambda group: "mpi")
    with pytest.raises(ValueError, match="nccl or gloo"):
        DG._check_backend(object(), torch.device("cpu"))
