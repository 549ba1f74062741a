"""The LM on a mesh (``repro_torch.distributed.sharding``'s LM half,
``distributed.context``'s ``constrain`` / ``shard_map``, the expert-parallel
MoE paths, ``launch.mesh.make_host_mesh``) on a ``(data=4, model=2)`` gloo
world of 8 CPU ranks, each a process of its own (rendezvous through a
``FileStore`` in a temporary directory; one spawn serves every case of
this file).

On every rank, for the ten architectures' SMOKE configurations in float32
on ``repro``'s weights (key 0) and a batch of 4 x 16 tokens:

* the loss and every gradient with ``DTensor`` parameters placed by
  ``tree_shardings``, the batch by ``batch_shardings``, the forward under
  ``make_ctx``, against the unsharded port on the same rank (rtol 1e-4,
  atol 1e-5); the parameters' placements against the specs'; the
  collectives ``CommDebugMode`` counts;
* the ``a2a`` and ``psum`` MoE paths (arctic and llama4-scout) and their
  gradients against ``_moe_reference``;
* a prefill and 4 greedy decode steps under ``serve_param_spec`` and
  ``cache_shardings`` against the unsharded serve (qwen3, llama4-scout
  (``psum`` at decode), xLSTM).

An MoE layer drops the tokens past an expert's capacity, and the EP paths
count capacity per token shard where ``_moe_reference`` counts it over all
tokens, so they agree only where no token is dropped.  The MoE configs
held to the unsharded port run with ``capacity_factor = max(cf, E / k)``:
an expert's capacity is then at least the tokens of its shard, and a token
picks an expert at most once, so nothing is ever dropped.  At each MoE
config's own capacity factor (arctic-smoke's is already E / k,
llama4-scout-smoke's half of it, so its ``a2a`` shards drop tokens) the
port's sharded loss and gradients are held to ``repro``'s sharded ones,
which count capacity per shard as the port does.

``repro`` itself runs the same sharded loss and gradients (qwen3, arctic,
xLSTM; arctic and llama4-scout at their own capacity factor too) on a ``(4, 2)`` mesh of 8 XLA host devices with ``Auto`` axes, in a
subprocess (``jax.make_mesh``'s default ``Explicit`` axes make ``repro``'s
``constrain`` raise under JAX 0.9.0); the port's sharded results are held
to it at rtol 1e-4.

The same ranks also form a ``(data=2, model=4)`` mesh, wider on ``model``
than the key/value heads of qwen3-smoke (2) and gemma-smoke (1): their
loss and every gradient against the unsharded port, and qwen3's against
``repro`` on an ``Auto``-axis ``(2, 4)`` mesh (the projections' outputs
are gathered over ``model`` before a head view that would cut a head
across ranks, ``layers.split_heads``).  xlstm-smoke's mLSTM cuts its
head dim (64) over that ``model`` axis of 4: its loss and gradients
against the unsharded port, and its serve against the unsharded serve;
and on a ``(data=1, model=8)`` mesh its loss and gradients against the
unsharded port and ``repro``'s ``Auto``-axis ``(1, 8)`` run.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import get_config as j_config
from repro.models import model as JM

from repro_torch.configs import ARCHS, get_config
from repro_torch.distributed.checkpoint import _flatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
RANK_TIMEOUT_S = 600
F32 = {"rtol": 1e-4, "atol": 1e-5}
SERVE_ARCHS = ("qwen3_0_6b", "llama4_scout_17b_a16e", "xlstm_1_3b")
EP_ARCHS = ("arctic_480b", "llama4_scout_17b_a16e")
REPRO_ARCHS = ("qwen3_0_6b", "arctic_480b", "xlstm_1_3b")
#: the (2, 4) mesh's configs, and those also held to repro there
WIDE_ARCHS = ("qwen3_0_6b", "gemma_2b", "xlstm_1_3b")
WIDE_REPRO_ARCHS = ("qwen3_0_6b",)
#: served on the (2, 4) mesh too
WIDE_SERVE_ARCHS = ("xlstm_1_3b",)
WIDE = "@2x4"
#: the (1, 8) mesh's configs, each also held to repro there
NARROW_ARCHS = ("xlstm_1_3b",)
NARROW = "@1x8"

#: what both packages' rank scripts share: a config without dropped
#: tokens, the weights from the npz, the batch
COMMON = r"""
import dataclasses
import numpy as np

ROWS, SEQ = 4, 16


def f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def no_drop(cfg):
    cfg = f32(cfg)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=max(
            cfg.capacity_factor, cfg.n_experts / cfg.top_k))
    return cfg


def nested(path):
    out = {}
    with np.load(path) as f:
        for key in f.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = f[key]
    return out
"""

#: one rank of the gloo world: prints a JSON object on its last line
RANK_SCRIPT = COMMON + f"WIDE = {WIDE!r}\nNARROW = {NARROW!r}\n" + r"""
import datetime, json, sys, time
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard
from torch.distributed.tensor.debug import CommDebugMode
torch.set_num_threads(1)
from repro_torch import interop
from repro_torch.configs import ARCHS, get_config
from repro_torch.distributed import context as dctx
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.checkpoint import _flatten
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.train import data as TD
from repro_torch.train import step as TS
from repro_torch.tree import leaves, map_tree

rank, world, store, wdir, odir = sys.argv[1:6]
rank, world = int(rank), int(world)
(serve_archs, ep_archs, repro_archs, wide_archs, wide_repro, wide_serve,
 narrow_archs) = ([x for x in a.split(",") if x] for a in sys.argv[6:13])
OWN_CF = "@own_cf"
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=300))
RTOL, ATOL = 1e-4, 1e-5


def full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def excess(got, want):
    # the worst of |got - want| - (atol + rtol |want|) over the elements
    got = full(got).detach().double()
    want = want.detach().double()
    return float(((got - want).abs() - (ATOL + RTOL * want.abs())).max())


def worst(got_tree, want_tree):
    return max(excess(g, w) for g, w in zip(leaves(got_tree),
                                            leaves(want_tree)))


def copy(tree):
    return map_tree(lambda t: t.detach().clone(), tree)


def batch_for(cfg):
    b = TD.make_batch(cfg, TD.DataConfig(seq_len=SEQ, global_batch=ROWS,
                                         seed=0), 0)
    return {k: torch.as_tensor(np.asarray(v)) for k, v in b.items()}


def train_case(arch, mesh, out, saved=None, tag=""):
    cfg = no_drop(get_config(arch, smoke=True))
    tree = interop.lm_params(nested(f"{wdir}/{arch}.npz"), cfg, "cpu")
    batch = batch_for(cfg)
    loss, grads = TS.loss_and_grads(copy(tree), batch, cfg, device="cpu")
    shard = SH.tree_shardings(tree, mesh, False)
    dparams = SH.distribute_tree(copy(tree), shard)
    placed = all(isinstance(p, DTensor) and tuple(p.placements)
                 == s.placements(p.ndim)
                 for p, s in zip(leaves(dparams), leaves(shard)))
    sharded_leaves = sum(any(not pl.is_replicate() for pl in p.placements)
                         for p in leaves(dparams))
    dbatch = SH.distribute_tree(batch, SH.batch_shardings(batch, mesh,
                                                          False))
    with CommDebugMode() as comm:
        with dctx.use(SH.make_ctx(cfg, mesh, False)):
            dloss, dgrads = TS.loss_and_grads(dparams, dbatch, cfg,
                                              device="cpu")
    out[arch] = {"loss": float(loss), "dloss": float(full(dloss)),
                 "loss_excess": excess(dloss, loss),
                 "grad_excess": worst(dgrads, grads),
                 "placed": placed, "sharded_leaves": sharded_leaves,
                 "leaves": len(leaves(dparams)),
                 "collectives": int(comm.get_total_counts()),
                 "dtensor_grads": all(isinstance(g, DTensor)
                                      for g in leaves(dgrads))}
    if arch in (repro_archs if saved is None else saved):
        # full_tensor is a collective: every rank gathers, rank 0 saves
        flat = _flatten(map_tree(lambda g: full(g).detach(), dgrads))
        if rank == 0:
            np.savez(f"{odir}/{arch}{tag}.npz",
                     loss=np.float32(out[arch]["dloss"]),
                     **{"g/" + k: v for k, v in flat.items()})


def own_cf_case(arch, mesh, out):
    # the sharded step at the config's own capacity factor; rank 0 saves
    # the loss and gradients for the comparison with repro's
    cfg = f32(get_config(arch, smoke=True))
    tree = interop.lm_params(nested(f"{wdir}/{arch}.npz"), cfg, "cpu")
    batch = batch_for(cfg)
    dparams = SH.distribute_tree(tree, SH.tree_shardings(tree, mesh, False))
    dbatch = SH.distribute_tree(batch, SH.batch_shardings(batch, mesh,
                                                          False))
    ctx = SH.make_ctx(cfg, mesh, False)
    with dctx.use(ctx):
        dloss, dgrads = TS.loss_and_grads(dparams, dbatch, cfg,
                                          device="cpu")
    flat = _flatten(map_tree(lambda g: full(g).detach(), dgrads))
    out[arch] = {"dloss": float(full(dloss)),
                 "capacity_factor": cfg.capacity_factor,
                 "mode": L.moe_mode(ROWS * SEQ, cfg, ctx)}
    if rank == 0:
        np.savez(f"{odir}/{arch}{OWN_CF}.npz", loss=np.float32(
            out[arch]["dloss"]), **{"g/" + k: v for k, v in flat.items()})


def attn_case(meshes, out):
    # one attention layer on grouped-query heads the model axis does not
    # divide: q head-sharded, k/v whole on every rank (model=2: 4 q heads
    # on 1 kv head, 6 on 3; model=4: 8 on 2, each rank's q heads in one
    # group, which group its coordinate's); causal with gradients, and a
    # decode step with the cache's sequence sharded (20 slots) or not (21)
    g = torch.Generator().manual_seed(2)
    base = dataclasses.replace(get_config("qwen3_0_6b", smoke=True),
                               dtype="float32", head_dim=16)
    for H, Hkv, mesh in ((4, 1, meshes[2]), (6, 3, meshes[2]),
                         (8, 2, meshes[4])):
        cfg = dataclasses.replace(base, n_heads=H, n_kv_heads=Hkv)
        ctx = SH.make_ctx(cfg, mesh, False)
        p = L.init_attention(g, cfg, torch.float32, "cpu")
        x = torch.randn((ROWS, SEQ, cfg.d_model), generator=g)
        w = torch.randn((ROWS, SEQ, cfg.d_model), generator=g)
        pos = torch.arange(SEQ, dtype=torch.int32)[None].expand(ROWS, SEQ)
        xr = x.clone().requires_grad_(True)
        want, _ = L.attention(xr, p, cfg, positions=pos)
        (want * w).sum().backward()
        with dctx.use(ctx):
            dx = dctx.constrain(x, "act_btd").requires_grad_(True)
            got, _ = L.attention(dx, p, cfg, positions=pos)
            (got * w).sum().backward()
        res = {"out_excess": excess(got, want),
               "x_grad_excess": excess(dx.grad, xr.grad)}
        for smax in (20, 21):
            cache = {"k": torch.randn((ROWS, smax, Hkv, cfg.hd), generator=g),
                     "v": torch.randn((ROWS, smax, Hkv, cfg.hd), generator=g),
                     "pos_slots": torch.arange(smax, dtype=torch.int32),
                     "length": torch.tensor(11, dtype=torch.int32)}
            x1 = torch.randn((ROWS, 1, cfg.d_model), generator=g)
            at = torch.tensor([11], dtype=torch.int32)
            want, wc = L.attention(x1, p, cfg, positions=at, mode="decode",
                                   layer_cache=cache)
            with dctx.use(ctx):
                dc = SH.distribute_tree(cache, SH.cache_shardings(
                    cache, mesh, False, cfg))
                d1 = dctx.constrain(x1, "act_btd")
                got, gc = L.attention(d1, p, cfg, positions=at,
                                      mode="decode", layer_cache=dc)
            res[f"decode{smax}_excess"] = max(
                excess(got, want), excess(gc["k"], wc["k"]),
                excess(gc["v"], wc["v"]))
            res[f"decode{smax}_cache_seq_sharded"] = any(
                pl == Shard(1) for pl in gc["k"].placements)
        out[f"{H}/{Hkv}"] = res


def ep_case(arch, mesh, out):
    cfg = no_drop(get_config(arch, smoke=True))
    p = interop.lm_params(nested(f"{wdir}/{arch}.npz"), cfg,
                          "cpu")["blocks"][0]["moe"]
    ctx = SH.make_ctx(cfg, mesh, False)
    g = torch.Generator().manual_seed(1)
    for mode, (B, S) in (("a2a", (4, 8)), ("psum", (4, 1))):
        x = torch.randn((B, S, cfg.d_model), generator=g)
        w = torch.randn((B, S, cfg.d_model), generator=g)
        xr, pr = x.clone().requires_grad_(True), copy(p)
        for t in leaves(pr):
            t.requires_grad_(True)
        want = L.moe_ffn(xr, pr, cfg)
        (want * w).sum().backward()
        shard = SH.tree_shardings({"blocks": [{"moe": p}]}, mesh, False)
        dp = SH.distribute_tree(copy(p), shard["blocks"][0]["moe"])
        for t in leaves(dp):
            t.requires_grad_(True)
        with dctx.use(ctx):
            dx = dctx.constrain(x, "act_btd").requires_grad_(True)
            got_mode = L.moe_mode(B * S, cfg, ctx)
            got = L.moe_ffn(dx, dp, cfg)
            (got * w).sum().backward()
        out[f"{arch}/{mode}"] = {
            "mode": got_mode, "out_excess": excess(got, want),
            "x_grad_excess": excess(dx.grad, xr.grad),
            "param_grad_excess": max(excess(a.grad, b.grad) for a, b in
                                     zip(leaves(dp), leaves(pr)))}


def serve_case(arch, mesh, out, steps=4):
    cfg = no_drop(get_config(arch, smoke=True))
    tree = interop.lm_params(nested(f"{wdir}/{arch}.npz"), cfg, "cpu")
    toks = batch_for(cfg)["tokens"]
    logits, cache = M.prefill(tree, toks, cfg, max_len=SEQ + steps,
                              device="cpu")
    want_logits, want_tokens = [logits], []
    for _ in range(steps):
        nxt = logits.argmax(-1).to(torch.int32)
        want_tokens.append(nxt)
        logits, cache = M.decode_step(tree, cache, nxt, cfg, device="cpu")
        want_logits.append(logits)
    dparams = SH.distribute_tree(tree, SH.tree_shardings(tree, mesh, False,
                                                         serve=True))
    ctx = SH.make_ctx(cfg, mesh, False)
    with dctx.use(ctx):
        dt = SH.distribute_tree({"tokens": toks}, SH.batch_shardings(
            {"tokens": toks}, mesh, False))["tokens"]
        logits, cache = M.prefill(dparams, dt, cfg, max_len=SEQ + steps,
                                  device="cpu")
        got_logits, got_tokens, placed = [logits], [], True
        for _ in range(steps):
            cache = SH.distribute_tree(cache, SH.cache_shardings(
                cache, mesh, False, cfg))
            placed &= all(isinstance(c, DTensor) for c in leaves(cache))
            nxt = full(logits).argmax(-1).to(torch.int32)
            got_tokens.append(nxt)
            dn = SH.distribute_tree({"t": nxt}, SH.batch_shardings(
                {"t": nxt}, mesh, False))["t"]
            logits, cache = M.decode_step(dparams, cache, dn, cfg,
                                          device="cpu")
            got_logits.append(logits)
    out[arch] = {
        "logits_excess": max(excess(a, b) for a, b in
                             zip(got_logits, want_logits)),
        "tokens_equal": all(bool((a == b).all()) for a, b in
                            zip(got_tokens, want_tokens)),
        "cache_dtensors": placed}


try:
    mesh = make_host_mesh(2, device="cpu")
    wide = make_host_mesh(4, device="cpu")
    narrow = make_host_mesh(8, device="cpu")
    res = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
           "wide_mesh": dict(zip(wide.mesh_dim_names, wide.mesh.shape)),
           "narrow_mesh": dict(zip(narrow.mesh_dim_names,
                                   narrow.mesh.shape)),
           "train": {}, "wide": {}, "own_cf": {}, "attn": {}, "ep": {},
           "serve": {}, "wide_serve": {}, "narrow": {}}
    for arch in ARCHS:
        t0 = time.perf_counter()
        print("train", arch, file=sys.stderr, flush=True)
        train_case(arch, mesh, res["train"])
        res["train"][arch]["seconds"] = time.perf_counter() - t0
    for arch in wide_archs:
        print("wide", arch, file=sys.stderr, flush=True)
        train_case(arch, wide, res["wide"], saved=wide_repro, tag=WIDE)
    for arch in narrow_archs:
        print("narrow", arch, file=sys.stderr, flush=True)
        train_case(arch, narrow, res["narrow"], saved=narrow_archs,
                   tag=NARROW)
    print("attn", file=sys.stderr, flush=True)
    attn_case({2: mesh, 4: wide}, res["attn"])
    for arch in ep_archs:
        print("ep", arch, file=sys.stderr, flush=True)
        ep_case(arch, mesh, res["ep"])
        own_cf_case(arch, mesh, res["own_cf"])
    for arch in serve_archs:
        print("serve", arch, file=sys.stderr, flush=True)
        serve_case(arch, mesh, res["serve"])
    for arch in wide_serve:
        print("wide serve", arch, file=sys.stderr, flush=True)
        serve_case(arch, wide, res["wide_serve"])
    print(json.dumps(res))
finally:
    dist.destroy_process_group()
"""

#: ``repro``'s sharded loss and gradients on a (4, 2) mesh of host devices
#: with ``Auto`` axes
REPRO_SCRIPT = COMMON + r"""
import sys
import jax
import jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_config
from repro.distributed import context as dctx
from repro.distributed import sharding as SH
from repro.distributed.checkpoint import _flatten
from repro.train import data as JD
from repro.train import step as JS

wdir, odir = sys.argv[1:3]
mesh42, mesh24, mesh18 = (jax.make_mesh(shape, ("data", "model"),
                                        axis_types=(AxisType.Auto,) * 2)
                          for shape in ((4, 2), (2, 4), (1, 8)))
runs = [(a, no_drop, "", mesh42) for a in sys.argv[3].split(",")]
runs += [(a, f32, "@own_cf", mesh42) for a in sys.argv[4].split(",")]
runs += [(a, no_drop, sys.argv[6], mesh24) for a in sys.argv[5].split(",")]
runs += [(a, no_drop, sys.argv[8], mesh18) for a in sys.argv[7].split(",")]
for arch, as_run, tag, mesh in runs:
    cfg = as_run(get_config(arch, smoke=True))
    params = jax.tree.map(jnp.asarray, nested(f"{wdir}/{arch}.npz"))
    batch = JD.make_batch(cfg, JD.DataConfig(seq_len=SEQ, global_batch=ROWS,
                                             seed=0), 0)
    params = jax.device_put(params, SH.tree_shardings(params, mesh, False))
    batch = jax.device_put(batch, SH.batch_shardings(batch, mesh, False))
    with dctx.use(SH.make_ctx(cfg, mesh, False)):
        loss, grads = jax.jit(jax.value_and_grad(JS.lm_loss),
                              static_argnums=2)(params, batch, cfg)
    np.savez(f"{odir}/{arch}{tag}.npz", loss=np.float32(loss),
             **{"g/" + k: np.asarray(v, np.float32)
                for k, v in _flatten(grads).items()})
"""


@functools.lru_cache(maxsize=None)
def weights(arch):
    params = JM.init_params(jax.random.PRNGKey(0), j_config(arch, smoke=True))
    return {k: np.asarray(v) for k, v in _flatten(params).items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawn the 8 ranks and ``repro``'s mesh run once; returns rank 0's
    results, every rank's, and the two output directories."""
    base = tmp_path_factory.mktemp("lm_mesh")
    wdir, port_out, repro_out = (base / d for d in ("w", "port", "repro"))
    for d in (wdir, port_out, repro_out):
        d.mkdir()
    for arch in ARCHS:
        np.savez(wdir / f"{arch}.npz", **weights(arch))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    jenv = dict(env, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(r), str(WORLD),
         str(base / "store"), str(wdir), str(port_out), ",".join(SERVE_ARCHS),
         ",".join(EP_ARCHS), ",".join(REPRO_ARCHS), ",".join(WIDE_ARCHS),
         ",".join(WIDE_REPRO_ARCHS), ",".join(WIDE_SERVE_ARCHS),
         ",".join(NARROW_ARCHS)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", REPRO_SCRIPT, str(wdir), str(repro_out),
         ",".join(REPRO_ARCHS), ",".join(EP_ARCHS),
         ",".join(WIDE_REPRO_ARCHS), WIDE, ",".join(NARROW_ARCHS), NARROW],
        env=jenv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    ranks = [json.loads(out.splitlines()[-1]) for out, _ in outs[:WORLD]]
    return ranks[0], ranks, port_out, repro_out


def test_host_mesh_is_four_by_two(world):
    assert world[0]["mesh"] == {"data": 4, "model": 2}


@pytest.mark.parametrize("arch", WIDE_ARCHS)
def test_wider_model_axis_than_kv_heads(world, arch):
    """On the ``(2, 4)`` mesh, whose ``model`` axis is wider than the
    config's key/value heads (qwen3-smoke 2, gemma-smoke 1; the port
    raised "Cannot unflatten unevenly sharded tensor" at the head view):
    on every rank the loss and every gradient within rtol 1e-4 of the
    unsharded port's, the gradients ``DTensor``s."""
    assert world[0]["wide_mesh"] == {"data": 2, "model": 4}
    cfg = get_config(arch, smoke=True)
    assert cfg.n_kv_heads < world[0]["wide_mesh"]["model"], cfg
    for res in world[1]:
        r = res["wide"][arch]
        assert r["loss_excess"] <= 0, r
        assert r["grad_excess"] <= 0, r
        assert r["dtensor_grads"], r
        assert r["placed"], r


@pytest.mark.parametrize("arch", WIDE_REPRO_ARCHS)
def test_wider_model_axis_equals_sharded_repro(world, arch):
    """The port's loss and gradients on the ``(2, 4)`` mesh (rank 0's)
    against ``repro``'s on its ``Auto``-axis ``(2, 4)`` mesh, leaf by
    leaf."""
    _held_to_repro(world, arch + WIDE)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_and_grads_equal_unsharded(world, arch):
    """On every rank: the loss and every gradient within rtol 1e-4 (atol
    1e-5) of the unsharded port's, the gradients ``DTensor``s."""
    for res in world[1]:
        r = res["train"][arch]
        assert r["loss_excess"] <= 0, r
        assert r["grad_excess"] <= 0, r
        assert r["dtensor_grads"], r
    r = world[0]["train"][arch]
    assert np.isfinite(r["loss"]) and r["loss"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_params_placed_by_tree_shardings(world, arch):
    """Every parameter a ``DTensor`` whose placements are its spec's, some
    of them sharded; DTensor ran collectives in the sharded step."""
    r = world[0]["train"][arch]
    assert r["placed"], r
    assert 0 < r["sharded_leaves"] <= r["leaves"], r
    assert r["collectives"] > 0, r


@pytest.mark.parametrize("heads", ["4/1", "6/3", "8/2"])
def test_grouped_heads_the_model_axis_does_not_divide(world, heads):
    """q's heads sharded over the model axis and k/v's whole: a causal
    layer's output and input gradient, and a decode step's output and
    cache, on every rank within rtol 1e-4 of the unsharded layer's; the
    decode cache stays sequence-sharded where the axis divides it."""
    for res in world[1]:
        r = res["attn"][heads]
        assert r["out_excess"] <= 0, r
        assert r["x_grad_excess"] <= 0, r
        assert r["decode20_excess"] <= 0, r
        assert r["decode21_excess"] <= 0, r
        assert r["decode20_cache_seq_sharded"], r
        assert not r["decode21_cache_seq_sharded"], r


@pytest.mark.parametrize("mode", ["a2a", "psum"])
@pytest.mark.parametrize("arch", EP_ARCHS)
def test_ep_paths_equal_reference(world, arch, mode):
    """``moe_ffn`` under the mesh takes ``mode`` (32 tokens: every axis
    divides them; 4 tokens: only ``data`` does), and its output and the
    gradients of its input and of every parameter equal
    ``_moe_reference``'s."""
    for res in world[1]:
        r = res["ep"][f"{arch}/{mode}"]
        assert r["mode"] == mode
        assert r["out_excess"] <= 0, r
        assert r["x_grad_excess"] <= 0, r
        assert r["param_grad_excess"] <= 0, r


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_under_serve_specs(world, arch):
    """A prefill and 4 decode steps with weights under
    ``serve_param_spec`` and the cache resharded by ``cache_shardings``
    before each step: every step's logits within rtol 1e-4 and the greedy
    tokens equal to the unsharded serve's."""
    for res in world[1]:
        r = res["serve"][arch]
        assert r["logits_excess"] <= 0, r
        assert r["tokens_equal"], r
        assert r["cache_dtensors"], r


@pytest.mark.parametrize("arch", NARROW_ARCHS)
def test_model_axis_of_eight_equals_unsharded_and_repro(world, arch):
    """On the ``(1, 8)`` mesh, whose ``model`` axis of 8 cuts
    xlstm-smoke's mLSTM head dim (64; the port raised in ``ssm.mlstm``
    on such a mesh): on every rank the loss and every gradient within
    rtol 1e-4 of the unsharded port's, and rank 0's against ``repro``'s
    on its ``Auto``-axis ``(1, 8)`` mesh, leaf by leaf."""
    assert world[0]["narrow_mesh"] == {"data": 1, "model": 8}
    for res in world[1]:
        r = res["narrow"][arch]
        assert r["loss_excess"] <= 0, r
        assert r["grad_excess"] <= 0, r
        assert r["dtensor_grads"], r
        assert r["placed"], r
    _held_to_repro(world, arch + NARROW)


@pytest.mark.parametrize("arch", WIDE_SERVE_ARCHS)
def test_serve_under_serve_specs_on_the_wider_mesh(world, arch):
    """The same serve on the ``(2, 4)`` mesh, where xlstm-smoke's mLSTM
    cuts its head dim (64) over a ``model`` axis of 4 (the port raised
    in ``ssm.mlstm`` there): logits within rtol 1e-4 and greedy tokens
    equal to the unsharded serve's on every rank."""
    for res in world[1]:
        r = res["wide_serve"][arch]
        assert r["logits_excess"] <= 0, r
        assert r["tokens_equal"], r
        assert r["cache_dtensors"], r


def _held_to_repro(world, name):
    _, _, port_out, repro_out = world
    with np.load(port_out / f"{name}.npz") as a, \
            np.load(repro_out / f"{name}.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        np.testing.assert_allclose(a["loss"], b["loss"], **F32)
        for k in a.files:
            np.testing.assert_allclose(a[k], b[k], err_msg=k, **F32)


@pytest.mark.parametrize("arch", REPRO_ARCHS)
def test_sharded_port_equals_sharded_repro(world, arch):
    """The port's sharded loss and gradients (rank 0's) against
    ``repro``'s on its ``Auto``-axis mesh, leaf by leaf."""
    _held_to_repro(world, arch)


@pytest.mark.parametrize("arch", EP_ARCHS)
def test_ep_at_own_capacity_equals_sharded_repro(world, arch):
    """At the config's own capacity factor the sharded step takes the
    ``a2a`` path, whose per-shard capacity, slot order and dropped tokens
    are ``repro``'s: loss and gradients against ``repro``'s on its
    ``Auto``-axis mesh, leaf by leaf.  Where the factor is below E / k,
    tokens were dropped (the loss differs from the no-drop run's)."""
    r = world[0]["own_cf"][arch]
    assert r["mode"] == "a2a", r
    _held_to_repro(world, arch + "@own_cf")
    no_drop = world[0]["train"][arch]["dloss"]
    cfg = get_config(arch, smoke=True)
    if cfg.capacity_factor < cfg.n_experts / cfg.top_k:
        assert r["dloss"] != no_drop, (r, no_drop)
    else:
        assert r["dloss"] == no_drop, (r, no_drop)
