"""Parameter / activation sharding rules, and the case-sharded sweep
serving.

**The LM half** (a port of ``repro.distributed.sharding``'s rules):
FSDP x TP x pod-DP.

* every >= 2-D parameter is sharded on two axes where divisibility
  allows: its "model" dimension over the ``model`` axis and a second
  dimension over ``data`` (ZeRO-3); optimizer moments inherit the rule;
* activations: batch over (pod, data); heads / ffn / vocab over model,
  with per-arch fallbacks when a dimension is not divisible;
* decode KV caches: batch over data, sequence over model.

The module imports nothing of the LM stack (``repro_torch.models``), so
the sweep's live code may import it; a ``cfg`` is a ``ModelConfig``.
Rules are *structural*: they pattern-match parameter names and check
divisibility against the mesh's axis sizes.  Each spec function reads
only those sizes, so it takes a ``DeviceMesh`` or a plain mapping of axis
name to size (``{"data": 16, "model": 16}``).  ``repro`` stacks a layer
stack's parameters on leading axes; the port keeps one dict a layer
(``blocks[i]``), and every rule counts dims from the end, so a layer's
spec is ``repro``'s stacked spec without its stacked axes.

**The case-sharded serves.**
The batched serve (:func:`repro_torch.core.vectorized.fused_scan_batch`)
serves independent cases, each from a cold carry.  On a mesh of N entries
(:func:`repro_torch.launch.mesh.make_sweep_mesh`) the case batch splits
into N contiguous shards instead, one batched serve each on its entry's
device: ``dram_serve_batch`` (``csrc/dram_serve.cu``) on a card, its plain
version on the CPU.  The per-case math is the same, so every finish equals
the unsharded serve's bit for bit, for any mesh.  The batch pads up to a
multiple of the mesh size with replicas of case 0, as the JAX package
pads, so every shard has the same number of cases; the pad rows are
dropped afterwards.

Every shard's inputs are placed on its device before the first shard is
served, and the finishes are gathered onto ``device`` only once every
shard has been launched, so distinct cards serve their shards at once.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import vectorized as vec
from repro_torch.distributed import context as dctx
from repro_torch.distributed.context import NamedSharding, PartitionSpec as P

# name-suffix -> (model-parallel dim, fsdp dim); dims count from the end
# so a layer's parameters match as ``repro``'s stacked [L, ...] ones do.
_MATRIX_RULES = {
    "wq": (-1, -2), "wk": (-1, -2), "wv": (-1, -2), "wo": (-2, -1),
    "w1": (-1, -2), "w3": (-1, -2), "w2": (-2, -1),
    "in_proj": (-1, -2), "out_proj": (-2, -1), "x_bc": (-2, -1),
    "r_rec": (-1, -2), "w_in": (-1, -2), "w_if": (-2, -1),
    "router": (None, -2), "img_adapter": (-1, -2),
    "lm_head": (-1, -2),
}


def _divisible(shape, dim, size) -> bool:
    return shape[dim] % size == 0 and shape[dim] >= size


def _is_expert(path, shape) -> bool:
    """An expert tensor ``(E, D, F)`` / ``(E, F, D)`` of an MoE layer."""
    return (path[-1] in ("w1", "w2", "w3") and len(shape) >= 3
            and len(path) >= 2 and path[-2] == "moe")


def param_spec(path: Tuple[str, ...], shape: Tuple[int, ...], mesh,
               multi_pod: bool) -> P:
    """Sharding spec for one parameter (``mesh``: a ``DeviceMesh`` or a
    mapping of axis name to size)."""
    sizes = dctx.axis_sizes(mesh)
    name = path[-1]
    n_model = sizes["model"]
    n_data = sizes["data"]
    spec = [None] * len(shape)
    if name == "embed":
        if _divisible(shape, 0, n_model):
            spec[0] = "model"
        if _divisible(shape, 1, n_data):
            spec[1] = "data"
        return P(*spec)
    rule = _MATRIX_RULES.get(name)
    if rule is None or len(shape) < 2:
        return P()                      # norms/scales: replicated
    tp_dim, fsdp_dim = rule
    # expert tensors (E, D, F): model axis shards experts (dim -3)
    if _is_expert(path, shape):
        e_dim = len(shape) - 3
        if shape[e_dim] % n_model == 0:
            spec[e_dim] = "model"
        f_dim = len(shape) + (-2 if name == "w2" else -1)
        # hierarchical FSDP: the F dim over *data* only, replicated across
        # pods, so a layer's weight gathers stay within a pod
        if shape[f_dim] % n_data == 0:
            spec[f_dim] = "data"
        return P(*spec)
    if tp_dim is not None and _divisible(shape, tp_dim, n_model):
        spec[tp_dim] = "model"
    if fsdp_dim is not None and _divisible(shape, fsdp_dim, n_data):
        spec[fsdp_dim] = "data"
    return P(*spec)


def serve_param_spec(path: Tuple[str, ...], shape: Tuple[int, ...],
                     mesh) -> P:
    """Serving layout: weights stay TP-resident (model axis only, no
    FSDP), so decode does not all-gather weights every layer."""
    sizes = dctx.axis_sizes(mesh)
    name = path[-1]
    n_model = sizes["model"]
    spec = [None] * len(shape)
    if name == "embed":
        if _divisible(shape, 0, n_model):
            spec[0] = "model"
        return P(*spec)
    rule = _MATRIX_RULES.get(name)
    if rule is None or len(shape) < 2:
        return P()
    if _is_expert(path, shape):
        e_dim = len(shape) - 3
        if shape[e_dim] % n_model == 0:
            spec[e_dim] = "model"
        return P(*spec)
    tp_dim, _ = rule
    if tp_dim is not None and _divisible(shape, tp_dim, n_model):
        spec[tp_dim] = "model"
    return P(*spec)


def _walk(tree, path, leaf):
    """``leaf(path, x)`` over a tree of dicts, lists and tuples; a list
    or tuple entry's path element is its index as a string."""
    if isinstance(tree, dict):
        return {k: _walk(v, path + (k,), leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, path + (str(i),), leaf)
                          for i, v in enumerate(tree))
    return leaf(path, tree)


def tree_shardings(params_shape, mesh, multi_pod: bool,
                   serve: bool = False):
    """A :class:`NamedSharding` for every leaf of a tree of parameters
    (tensors, ``meta`` tensors, or anything with a ``.shape``)."""
    if hasattr(params_shape, "tree") and not isinstance(params_shape, dict):
        params_shape = params_shape.tree()

    def one(path, x):
        shape = tuple(x.shape)
        spec = (serve_param_spec(path, shape, mesh) if serve
                else param_spec(path, shape, mesh, multi_pod))
        return NamedSharding(mesh, spec)

    return _walk(params_shape, (), one)


def activation_rules(cfg, mesh, multi_pod: bool) -> Dict[str, P]:
    """Per-arch activation rules (``cfg`` a ``ModelConfig``) with
    divisibility fallbacks."""
    batch = ("pod", "data") if multi_pod else ("data",)
    n_model = dctx.axis_sizes(mesh)["model"]
    rules: Dict[str, P] = {"tokens": P(batch, None),
                           "act_btd": P(batch, None, None)}
    if cfg.d_ff and cfg.d_ff % n_model == 0:
        rules["act_btf"] = P(batch, None, "model")
    if cfg.n_heads % n_model == 0:
        rules["act_heads"] = P(batch, None, "model", None)
    else:
        # indivisible head counts (arctic 56, hymba 25, gemma 8, whisper
        # 6): q/k/v replicated over the model axis, as ``repro`` chose
        # against any partial layout of the scores
        rules["act_heads"] = P(batch, None, None, None)
    # k/v carry n_kv_heads, often fewer than the model axis (GQA): then
    # k/v are replicated (the standard GQA-TP choice)
    if cfg.n_kv_heads % n_model == 0 and cfg.n_heads % n_model == 0:
        rules["act_kv_heads"] = P(batch, None, "model", None)
    else:
        rules["act_kv_heads"] = P(batch, None, None, None)
    rules["replicated2d"] = P(None, None)
    if cfg.vocab % n_model == 0:
        rules["logits"] = P(batch, None, "model")
    if cfg.family == "ssm":
        di = cfg.d_model * max(cfg.ssm_expand, 1)
        dh = di // cfg.n_heads
        if dh % n_model == 0:
            rules["act_ssm_heads"] = P(batch, None, None, "model")
    return rules


def make_ctx(cfg, mesh, multi_pod: bool) -> dctx.ShardCtx:
    return dctx.ShardCtx(
        mesh=mesh,
        rules=activation_rules(cfg, mesh, multi_pod),
        token_axes=("pod", "data") if multi_pod else ("data",),
        expert_axis="model",
    )


def batch_shardings(batch_shape, mesh, multi_pod: bool):
    """A :class:`NamedSharding` for every entry of a batch: dim 0 over the
    batch axes where they divide it."""
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    sizes = dctx.axis_sizes(mesh)
    n = int(np.prod([sizes[a] for a in batch_axes]))

    def one(path, x):
        shape = tuple(x.shape)
        spec = [None] * len(shape)
        if len(shape) >= 1 and shape[0] % n == 0:
            spec[0] = batch_axes if multi_pod else "data"
        return NamedSharding(mesh, P(*spec))

    return _walk(batch_shape, (), one)


def cache_shardings(cache_shape, mesh, multi_pod: bool, cfg):
    """Decode-cache shardings: batch -> data, KV sequence -> model.  The
    port's caches hold one dict a layer (a block for xLSTM), so no leaf
    has ``repro``'s stacked leading axes."""
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    sizes = dctx.axis_sizes(mesh)
    n_batch = int(np.prod([sizes[a] for a in batch_axes]))
    n_model = sizes["model"]
    ba = batch_axes if multi_pod else "data"

    def one(path, x):
        shape = tuple(x.shape)
        spec = [None] * len(shape)
        name = path[-1]
        if name in ("k", "v") and len(shape) >= 4:
            if shape[0] % n_batch == 0:
                spec[0] = ba
            if shape[1] % n_model == 0:
                spec[1] = "model"                # sequence-sharded KV
        elif name in ("0", "1") and "cross_kv" in path:
            if shape[0] % n_batch == 0:
                spec[0] = ba
        elif len(shape) >= 2 and name not in ("pos_slots", "length", "pos"):
            if shape[0] % n_batch == 0:
                spec[0] = ba
            # shard the widest remaining dim over model if divisible
            dims = list(range(1, len(shape)))
            widest = max(dims, key=lambda i: shape[i])
            if shape[widest] % n_model == 0:
                spec[widest] = "model"
        return NamedSharding(mesh, P(*spec))

    return _walk(cache_shape, (), one)


def distribute_tree(tree, shardings):
    """Every tensor of ``tree`` laid out by the matching
    :class:`NamedSharding` of ``shardings`` (``jax.device_put(tree,
    shardings)``): a plain tensor (the full value, the same on every
    rank) is distributed, a ``DTensor`` redistributed.  Leaves that are
    not tensors stay as they are."""
    from torch.distributed.tensor import DTensor
    from repro_torch.tree import map_tree

    def one(x, s):
        if isinstance(x, DTensor):
            return x.redistribute(s.mesh, s.placements(x.ndim))
        if isinstance(x, torch.Tensor):
            return s.distribute(x)
        return x
    return map_tree(one, tree, shardings)


# ---------------------------------------------------------------------------
# case-sharded sweep serving
# ---------------------------------------------------------------------------

Streams = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _case0(arr, n: int):
    """``n`` replicas of case 0 of ``arr`` (an array or a tensor, case axis
    first)."""
    if isinstance(arr, torch.Tensor):
        return arr[:1].expand((n,) + tuple(arr.shape[1:]))
    return np.repeat(np.asarray(arr)[:1], n, axis=0)


def _shard_rows(arr, lo: int, hi: int, M: int):
    """Cases ``[lo, hi)`` of ``arr``'s ``M`` cases padded with replicas of
    case 0 past ``M``, without copying the cases outside the shard."""
    if hi <= M:
        return arr[lo:hi]
    parts = ([arr[lo:M]] if lo < M else []) + [_case0(arr, hi - max(lo, M))]
    if isinstance(arr, torch.Tensor):
        return torch.cat(parts, dim=0)
    return np.concatenate(parts, axis=0)


def _pad_cases(arr, pad: int):
    """``arr`` with ``pad`` replicas of case 0 appended."""
    return _shard_rows(arr, 0, len(arr) + pad, len(arr))


def _serve_shards(streams_for: Callable[[int, int, torch.device], Streams],
                  timing, n_banks: int, banks_per_rank: int,
                  mesh: Sequence[torch.device], device):
    """Serve ``len(timing)`` cases in ``len(mesh)`` shards: shard k's
    streams are ``streams_for(lo, hi, mesh[k])``.  Returns the finishes
    ``[M, S, C, K]`` and the lean carries, case axis first, on
    ``device``."""
    if not mesh:
        raise ValueError("the case mesh is empty")
    device = torch.device(device)
    M = len(timing)
    D = len(mesh)
    per = -(-M // D)
    bounds = [(k * per, (k + 1) * per) for k in range(D)]
    inputs = [(streams_for(lo, hi, d),
               vec.as_int32(_shard_rows(timing, lo, hi, M), d))
              for (lo, hi), d in zip(bounds, mesh)]
    outs = [vec.fused_scan_batch(*streams, t, n_banks, banks_per_rank, d)
            for (streams, t), d in zip(inputs, mesh)]
    fin = torch.cat([f.to(device) for f, _ in outs], dim=0)[:M]
    carry = tuple(torch.cat([c[i].to(device) for _, c in outs], dim=0)[:M]
                  for i in range(len(outs[0][1])))
    return fin, carry


def sharded_fused_scan_batch(issue, meta, boundary, timing, n_banks: int,
                             banks_per_rank: int,
                             mesh: Sequence[torch.device], device):
    """Case-sharded :func:`~repro_torch.core.vectorized.fused_scan_batch`
    on M stacked programs (``issue``/``meta`` ``[M, S, C, K]``,
    ``boundary[M, S]``, ``timing[M, 7]``; host arrays or tensors): shard k
    of the case batch is served on ``mesh[k]``.  Returns ``(finish[M, S,
    C, K], lean carries)`` on ``device``, bit-identical to the unsharded
    serve for any mesh."""
    def streams_for(lo, hi, d):
        return tuple(vec.as_int32(_shard_rows(a, lo, hi, len(timing)), d)
                     for a in (issue, meta, boundary))
    return _serve_shards(streams_for, timing, n_banks, banks_per_rank,
                         mesh, device)


def sharded_fused_scan_batch_shared(issue, meta, boundary, timing,
                                    n_banks: int, banks_per_rank: int,
                                    mesh: Sequence[torch.device], device):
    """Case-sharded shared-program variant: ONE program (``[S, C, K]``,
    ``boundary[S]``) served against a sharded batch of timing vectors
    (``[M, 7]``).  The program is copied once per distinct device of the
    mesh, never once per case.  Returns as
    :func:`sharded_fused_scan_batch`."""
    copies = {}

    def streams_for(lo, hi, d):
        if d not in copies:
            copies[d] = tuple(vec.as_int32(a, d)
                              for a in (issue, meta, boundary))
        return copies[d]
    return _serve_shards(streams_for, timing, n_banks, banks_per_rank,
                         mesh, device)

