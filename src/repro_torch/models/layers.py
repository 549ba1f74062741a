"""Transformer building blocks: norms, RoPE, GQA attention (train /
prefill / chunked-long / decode), MLPs, and the MoE FFN (the reference
dense dispatch and the two expert-parallel paths).

A port of ``repro.models.layers``.  The functions keep ``repro``'s names
and take parameters as dicts of tensors, so each is held to its
counterpart on the same weights; the ``nn.Module`` classes at the end
hold a layer's parameters and call them.  Every cast, mask constant and
contraction order follows ``repro``'s ``jnp`` code: bf16 products,
float32 scores and softmax, probabilities cast back to the compute dtype
before the value product.  Where XLA, compiling ``repro``, keeps a
result in float32 for a float32 consumer, the port computes it in
float32 too: the scores are the bf16 product times the float32
reciprocal of the bf16-rounded sqrt(Dh), as XLA rewrites the division.
Under a mesh context (``distributed.context``) the MoE FFN takes
``repro``'s expert-parallel paths: an all-to-all dispatch with capacity
(``a2a``) or a replicated dispatch summed over the expert axis
(``psum``), each a ``shard_map`` over the mesh.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.distributed import context as dctx
from repro_torch.distributed.context import PartitionSpec as P
from repro_torch.models.config import ModelConfig

Params = Dict[str, torch.Tensor]

#: the mask fill of ``repro``'s scores
NEG = -1e30


# ---------------------------------------------------------------------------
# initializers / numerics
# ---------------------------------------------------------------------------

def _dense_init(gen, shape, in_axis_size, dtype, device):
    """``normal * 1/sqrt(fan_in)``, drawn from ``gen`` on ``device``."""
    scale = 1.0 / math.sqrt(max(in_axis_size, 1))
    return (torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32) * scale).to(dtype)


def weak(value: float, like: torch.Tensor) -> float:
    """A Python float as JAX applies it to an array: rounded to the
    array's dtype first (``bf16 / sqrt(d)`` divides by a bf16 value).
    A Python number, so no constant is copied to the card a call."""
    return _rounded(float(value), like.dtype)


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    return torch.tensor(value, dtype=dtype).item()


def _recip32(value: float) -> float:
    """``1 / value`` in float32, as XLA folds a division by a constant."""
    return float(np.float32(1.0) / np.float32(value))


def silu(x):
    """``jax.nn.silu``: ``x * (1 / (1 + exp(-x)))``, op by op, each result
    rounded to ``x``'s dtype as XLA rounds it (``F.silu`` rounds once)."""
    one = weak(1.0, x)
    return x * (one / (one + torch.exp(-x)))


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh form, op by op (torch's
    ``F.gelu`` is the erf form, and its tanh form rounds once)."""
    cdf = weak(0.5, x) * (weak(1.0, x) + torch.tanh(
        weak(math.sqrt(2 / math.pi), x)
        * (x + weak(0.044715, x) * (x * x * x))))
    return x * cdf


def softplus(x):
    """``jax.nn.softplus``, ``logaddexp(x, 0)``: ``max(x, 0) +
    log1p(exp(-|x|))``, op by op."""
    return x.clamp(min=0.0) + torch.log1p(torch.exp(-x.abs()))


def softmax(x):
    """``jax.nn.softmax`` over the last axis: ``exp(x - max) / sum``, a
    true division (``torch.softmax`` differs in the last bit)."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def rms_norm(x, weight, eps):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * weight).to(dt)


def rope_freqs(dh: int, theta: float) -> np.ndarray:
    """``repro``'s frequencies: float64 in NumPy, then float32 (JAX casts
    the float64 array to float32 before it meets the positions)."""
    half = dh // 2
    return (theta ** (-np.arange(0, half) * 2.0 / dh)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _freqs_on(dh: int, theta: float, device: torch.device) -> torch.Tensor:
    """:func:`rope_freqs` on ``device``, copied there once.  Made outside
    inference mode, so a train step may save it for its backward pass
    after a serve call first cached it."""
    with torch.inference_mode(False):
        return torch.from_numpy(rope_freqs(dh, theta)).to(device)


def rope(x, positions, theta):
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = _freqs_on(dh, theta, x.device)
    angles = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def init_attention(gen, cfg: ModelConfig, dtype, device) -> Params:
    d, hd = cfg.d_model, cfg.hd
    p = {
        "wq": _dense_init(gen, (d, cfg.n_heads * hd), d, dtype, device),
        "wk": _dense_init(gen, (d, cfg.n_kv_heads * hd), d, dtype, device),
        "wv": _dense_init(gen, (d, cfg.n_kv_heads * hd), d, dtype, device),
        "wo": _dense_init(gen, (cfg.n_heads * hd, d), cfg.n_heads * hd,
                          dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def split_heads(y, heads: int, hd: int):
    """``y`` ``(B, S, heads * hd)`` viewed as ``(B, S, heads, hd)``.  On a
    ``DTensor`` whose last dim is cut over more ranks than divide
    ``heads`` (a projection's output sharded over ``model``, with fewer
    or indivisible heads), that dim is gathered first: a view cannot cut
    a head across ranks, and GSPMD lays ``repro``'s reshape out whole
    there too."""
    from torch.distributed.tensor import DTensor, Replicate
    B, S = y.shape[:2]
    if isinstance(y, DTensor):
        last = y.ndim - 1
        cut = [p.is_shard(last) for p in y.placements]
        ranks = int(np.prod([y.device_mesh.size(i)
                             for i, c in enumerate(cut) if c]))
        if heads % ranks:
            y = y.redistribute(y.device_mesh, [
                Replicate() if c else p for p, c in zip(y.placements, cut)])
    return y.reshape(B, S, heads, hd)


def _qkv(x, p, cfg: ModelConfig, positions):
    hd = cfg.hd
    q = split_heads(x @ p["wq"], cfg.n_heads, hd)
    k = split_heads(x @ p["wk"], cfg.n_kv_heads, hd)
    v = split_heads(x @ p["wv"], cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = dctx.constrain(q, "act_heads")
    k = dctx.constrain(k, "act_kv_heads")
    v = dctx.constrain(v, "act_kv_heads")
    return q, k, v


def _sdpa(q, k, v, cfg: ModelConfig, *, causal, q_pos0=0, k_pos0=0,
          window=0, k_len=None):
    """q: (B,Sq,H,Dh); k,v: (B,Sk,Hkv,Dh).  Grouped-query attention with
    optional causal / sliding-window masking and a valid-length bound."""
    B, Sq, H, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, Dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k)
    scores = scores.float() * _recip32(weak(math.sqrt(Dh), scores))
    qi = q_pos0 + torch.arange(Sq, device=q.device)[:, None]
    ki = k_pos0 + torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window:
        mask &= ki > qi - window
    if k_len is not None:
        mask &= ki < k_len
    scores = torch.where(mask, scores, NEG)
    probs = softmax(scores).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, Sq, H * Dh)


def _sdpa_chunked(q, k, v, cfg: ModelConfig, *, window=0):
    """Memory-bounded causal attention for long prefill: an outer loop
    over query chunks, an inner online softmax over the KV chunks that
    ``repro``'s scan visits, less those the mask hides wholly (they add
    exact zeros) — scores never materialize beyond (B, Hkv, G, cq,
    ck)."""
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    c = cfg.attn_chunk
    assert S % c == 0, (S, c)
    nq = S // c
    qg = q.reshape(B, nq, c, Hkv, G, Dh)
    kc = k.reshape(B, nq, c, Hkv, Dh).unbind(1)
    vc = v.reshape(B, nq, c, Hkv, Dh).unbind(1)
    scale = 1.0 / math.sqrt(Dh)
    ar = torch.arange(c, device=q.device)
    outs = []
    for qi in range(nq):
        q_blk = qg[:, qi]
        m = torch.full((B, Hkv, G, c), NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, Hkv, G, c), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, c, Hkv, G, Dh), dtype=torch.float32,
                          device=q.device)
        for ki in range(nq):
            # a chunk the mask hides wholly (past the diagonal, or before
            # the window) changes nothing, bit for bit: once a row has a
            # valid key its p = exp(NEG - m) is 0 and its corr 1, and the
            # first valid chunk's corr = 0 clears what came before it
            if ki > qi or (window and (ki + 1) * c - 1 <= qi * c - window):
                continue
            s = torch.einsum("bskgd,btkd->bkgst", q_blk, kc[ki])
            s = s.float() * weak(scale, s)
            if ki == qi or window:      # else every key is valid
                qpos = qi * c + ar[:, None]
                kpos = ki * c + ar[None, :]
                msk = qpos >= kpos
                if window:
                    msk &= kpos > qpos - window
                s = torch.where(msk, s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = (acc * corr.permute(0, 3, 1, 2)[..., None]
                   + torch.einsum("bkgst,btkd->bskgd", p.to(q_blk.dtype),
                                  vc[ki]))
            m = m_new
        out = acc / l.permute(0, 3, 1, 2)[..., None]
        outs.append(out.reshape(B, c, H * Dh).to(q.dtype))
    return torch.stack(outs, dim=1).reshape(B, S, H * Dh)


def _head_axes(ctx):
    """The mesh axes of q's and of k/v's head dim under the context's
    ``act_heads`` / ``act_kv_heads`` rules (``None`` for whole)."""
    qs, kvs = (ctx.spec(n) or P() for n in ("act_heads", "act_kv_heads"))
    hq = qs[2] if len(qs) > 2 else None
    hkv = kvs[2] if len(kvs) > 2 and hq is not None else None
    return hq, hkv


def _group_kv(q, k, v, axis: str):
    """Inside a ``shard_map`` whose q holds this rank's shard of the heads
    over ``axis`` and whose k/v hold every key/value head: the key/value
    heads those query heads attend to, laid out so that the core's
    grouping (``H // Hkv`` query heads a key/value head) pairs them as
    the whole does.  Where the key/value heads do not shard over the axis,
    a rank's query heads lie in one group when their count divides the
    group (``Hkv`` divides the axis: that one head), else each query head
    gets its own copy of its key/value head."""
    Hl = q.shape[2]
    G = Hl * dctx.axis_size(axis) // k.shape[2]
    h0 = dctx.axis_index(axis) * Hl
    if G % Hl == 0:
        return k[:, :, h0 // G:h0 // G + 1], v[:, :, h0 // G:h0 // G + 1]
    idx = torch.div(h0 + torch.arange(Hl, device=k.device), G,
                    rounding_mode="floor")
    return k.index_select(2, idx), v.index_select(2, idx)


def _attend(core, q, k, v):
    """``core(q, k, v) -> (B, Sq, H * Dh)``, every argument ``(B, S,
    heads, Dh)``.  Under a mesh context, on each rank's shards
    (``shard_map``), as GSPMD partitions it: the batch over the batch axes
    where they divide it; q's heads over the model axis where the
    ``act_heads`` rule shards them, and k/v's with them where
    ``act_kv_heads`` does, else k/v whole on every rank and each rank
    attending with the key/value heads of its own query heads
    (:func:`_group_kv`).  DTensor's own rules do not cover the
    grouped-query einsums on every torch release, so the attention core
    runs on local tensors."""
    ctx = dctx.current()
    if ctx is None:
        return core(q, k, v)
    batch = _batch_axes(ctx, q.shape[0])
    hq, hkv = _head_axes(ctx)
    body = core
    if hq is not None and hkv is None:
        def body(q, k, v):
            return core(q, *_group_kv(q, k, v, hq))
    return dctx.shard_map(body, mesh=ctx.mesh,
                          in_specs=(P(batch, None, hq, None),
                                    P(batch, None, hkv, None),
                                    P(batch, None, hkv, None)),
                          out_specs=P(batch, None, hq))(q, k, v)


def _decode_core(q, k, v, k_new, v_new, slot, mask, seq_axis=None):
    """One decode step's attention: ``k_new`` / ``v_new`` written at
    ``slot`` of the caches ``k`` / ``v``, ``q`` attending to them under
    ``mask`` (1, Smax).  With ``seq_axis``, ``k`` / ``v`` are this rank's
    shard of the cache's sequence over that mesh axis (flash-decoding):
    the slot is written on the rank holding it, and the softmax's max and
    sum and the output are reduced over the axis."""
    Bl, S, H, Dh = q.shape
    lo, Sl = 0, k.shape[1]
    if seq_axis is not None:
        lo = dctx.axis_index(seq_axis) * Sl
        mask = mask[:, lo:lo + Sl]
    # the slot is written on local tensors: DTensor decomposes index_copy
    # into an index_put it has no working rule for on torch 2.11
    if seq_axis is None:
        k = k.index_copy(1, slot, k_new)
        v = v.index_copy(1, slot, v_new)
    else:                      # the row itself where another rank holds it
        at = (slot - lo).clamp(0, Sl - 1)
        mine = ((slot >= lo) & (slot < lo + Sl)).reshape(1, 1, 1, 1)
        k = k.index_copy(1, at, torch.where(mine, k_new,
                                            k.index_select(1, at)))
        v = v.index_copy(1, at, torch.where(mine, v_new,
                                            v.index_select(1, at)))
    Hkv = k.shape[2]
    qg = q.reshape(Bl, S, Hkv, H // Hkv, Dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k)
    scores = scores.float() * _recip32(weak(math.sqrt(Dh), scores))
    scores = torch.where(mask[None, None, None], scores, NEG)
    if seq_axis is None:
        probs = softmax(scores).to(q.dtype)
    else:                      # softmax's own steps, reduced over the axis
        e = torch.exp(scores - dctx.pmax(scores.amax(dim=-1, keepdim=True),
                                         seq_axis))
        probs = (e / dctx.psum(e.sum(dim=-1, keepdim=True), seq_axis)
                 ).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v).reshape(Bl, S, H * Dh)
    if seq_axis is not None:
        out = dctx.psum(out, seq_axis)
    return out, k, v


def _decode_attend(q, k, v, k_new, v_new, slot, mask):
    """:func:`_decode_core` on the whole cache, or under a mesh context on
    each rank's shards (``shard_map``): the batch over the batch axes
    where they divide it; the cache's sequence over the model axis where
    it divides it (``cache_shardings``' layout, kept: the cache is never
    gathered), q and the new entries whole over that axis.  Where the
    model axis does not divide the cache, the heads as :func:`_attend`
    lays them when k/v's heads shard with q's, else whole."""
    ctx = dctx.current()
    if ctx is None:
        return _decode_core(q, k, v, k_new, v_new, slot, mask)
    batch = _batch_axes(ctx, q.shape[0])
    sizes = dctx.axis_sizes(ctx.mesh)
    if "model" in sizes and k.shape[1] % sizes["model"] == 0:
        new, cache = P(batch, None, None, None), P(batch, "model", None, None)
        out = P(batch, None, None)
        body = functools.partial(_decode_core, seq_axis="model")
    else:
        hq, hkv = _head_axes(ctx)
        heads = hkv if hkv == hq else None
        new = cache = P(batch, None, heads, None)
        out = P(batch, None, heads)
        body = _decode_core

    def local(q, k, v, k_new, v_new):
        return body(q, k, v, k_new, v_new, slot, mask)

    return dctx.shard_map(local, mesh=ctx.mesh,
                          in_specs=(new, cache, cache, new, new),
                          out_specs=(out, cache, cache))(q, k, v, k_new,
                                                         v_new)


def _batch_axes(ctx, n: int):
    """The batch entry of the context's ``act_btd`` rule where its axes
    divide ``n`` rows, else ``None``."""
    btd = ctx.spec("act_btd") or P()
    sizes = dctx.axis_sizes(ctx.mesh)
    if not btd or n % int(np.prod([sizes[a] for a in btd.axes(0)])):
        return None
    return btd[0]


def embed_lookup(table, tokens):
    """``table[tokens]`` under a mesh context, vocab-parallel: each rank
    looks up the rows of its vocabulary shard (the table's ``model``-axis
    shard, gathered over the other axes), zero for the tokens outside it,
    and the rows are summed over the ``model`` axis (Megatron's embedding:
    every token's row is one exact copy plus zeros).  DTensor's own rules
    for the lookup fail on some torch release (indexing's backward on
    2.11, ``F.embedding`` on a 2-D mesh on 2.13)."""
    ctx = dctx.current()
    sizes = dctx.axis_sizes(ctx.mesh)
    vocab = ("model" if "model" in sizes
             and table.shape[0] % sizes["model"] == 0 else None)
    batch = _batch_axes(ctx, tokens.shape[0])

    def local(tab, tok):
        lo = dctx.axis_index(vocab) * tab.shape[0] if vocab else 0
        idx = tok.long() - lo
        inside = (idx >= 0) & (idx < tab.shape[0])
        rows = tab[torch.where(inside, idx, 0)] * inside[..., None].to(
            tab.dtype)
        return dctx.psum(rows, vocab) if vocab else rows

    return dctx.shard_map(local, mesh=ctx.mesh,
                          in_specs=(P(vocab, None), P(batch, None)),
                          out_specs=P(batch, None, None))(table, tokens)


def takes_chunked_route(cfg: ModelConfig, S: int) -> bool:
    """Whether a causal or prefill pass over ``S`` tokens runs
    :func:`_sdpa_chunked` (``repro``'s branch, ``layers.py:224``)."""
    return S > 2 * cfg.attn_chunk and S % cfg.attn_chunk == 0


def attention(x, p, cfg: ModelConfig, *, positions, mode="causal",
              layer_cache=None, cross_kv=None, window=None):
    """Returns (out, new_layer_cache).

    mode: causal | bidir | cross | decode | prefill.  ``layer_cache`` for
    decode is a dict with k, v (B, Smax, Hkv, Dh), pos_slots (Smax,) for
    ring buffers, and length (a 0-d int32 tensor); decode returns a new
    dict and leaves the one it was given as it was.
    """
    B, S, _ = x.shape
    win = cfg.sliding_window if window is None else window
    if mode == "cross":
        q = split_heads(x @ p["wq"], cfg.n_heads, cfg.hd)
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k, v = cross_kv
        out = _attend(lambda q, k, v: _sdpa(q, k, v, cfg, causal=False),
                      q, k, v)
        return out @ p["wo"], None

    if mode == "decode":
        # the step's bookkeeping (length, position, ring slots) is
        # replicated under a mesh: each rank computes it on its own copy,
        # as DTensor mixes a plain and a replicated bool tensor wrongly
        length = dctx.replicated(layer_cache["length"])
        positions = dctx.replicated(positions).reshape(1)
        q, k_new, v_new = _qkv(x, p, cfg, positions)
        Smax = layer_cache["k"].shape[1]
        slot = (length % Smax).reshape(1).long()     # ring for SWA caches
        pos_slots = dctx.replicated(layer_cache["pos_slots"]).index_copy(
            0, slot, positions.to(layer_cache["pos_slots"].dtype))
        kpos = pos_slots[None, :]                    # (1, Smax)
        qpos = positions.reshape(1, 1)
        scores_mask = (kpos <= qpos) & (kpos > qpos - (win or 1 << 30))
        valid = torch.arange(Smax, device=x.device)[None, :] <= length
        mask = scores_mask & valid

        out, k, v = _decode_attend(q, layer_cache["k"], layer_cache["v"],
                                   k_new, v_new, slot, mask)
        out = out @ p["wo"]
        new_cache = {"k": k, "v": v, "pos_slots": pos_slots,
                     "length": length + 1}
        return out, new_cache

    q, k, v = _qkv(x, p, cfg, positions)
    if mode == "bidir":
        core = functools.partial(_sdpa, cfg=cfg, causal=False)
    elif takes_chunked_route(cfg, S):
        core = functools.partial(_sdpa_chunked, cfg=cfg, window=win)
    else:
        core = functools.partial(_sdpa, cfg=cfg, causal=True, window=win)
    out = _attend(core, q, k, v) @ p["wo"]
    if mode == "prefill":
        # return the populated cache (pad to S; serving layer resizes)
        pos_slots = positions[0] if positions.ndim > 1 else positions
        new_cache = {"k": k, "v": v, "pos_slots": pos_slots.to(torch.int32),
                     "length": torch.full((), S, dtype=torch.int32,
                                          device=x.device)}
        return out, new_cache
    return out, None


def init_attn_cache(cfg: ModelConfig, batch: int, smax: int, dtype,
                    device):
    shape = (batch, smax, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos_slots": torch.full((smax,), -1, dtype=torch.int32,
                                device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------

def init_mlp(gen, cfg: ModelConfig, d_ff: Optional[int] = None,
             dtype=torch.float32, device=None) -> Params:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    p = {"w1": _dense_init(gen, (d, f), d, dtype, device),
         "w2": _dense_init(gen, (f, d), f, dtype, device)}
    if cfg.act in ("silu", "geglu"):
        p["w3"] = _dense_init(gen, (d, f), d, dtype, device)
    return p


def mlp(x, p, cfg: ModelConfig):
    # under a mesh each product is laid out by ``act_btf`` before its
    # nonlinearity: DTensor may leave it a partial sum over ``model``,
    # and would then cut the sequence to reduce it
    h = dctx.constrain(x @ p["w1"], "act_btf")
    if cfg.act == "silu":
        h = silu(h) * dctx.constrain(x @ p["w3"], "act_btf")
    elif cfg.act == "geglu":
        h = gelu(h) * dctx.constrain(x @ p["w3"], "act_btf")
    else:
        h = gelu(h)
    h = dctx.constrain(h, "act_btf")
    return h @ p["w2"]


# ---------------------------------------------------------------------------
# MoE FFN
# ---------------------------------------------------------------------------

def _dense_sub(cfg: ModelConfig) -> ModelConfig:
    """The config of the MoE layer's parallel dense branch."""
    return dataclasses.replace(cfg, d_ff=cfg.moe_dense_ff or cfg.d_ff)


def init_moe(gen, cfg: ModelConfig, dtype, device) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": _dense_init(gen, (d, e), d, dtype, device),
        "w1": _dense_init(gen, (e, d, f), d, dtype, device),
        "w3": _dense_init(gen, (e, d, f), d, dtype, device),
        "w2": _dense_init(gen, (e, f, d), f, dtype, device),
    }
    if cfg.moe_dense_residual:
        p["dense"] = init_mlp(gen, _dense_sub(cfg), dtype=dtype,
                              device=device)
    return p


def _expert_ffn(xe, w1, w3, w2):
    """xe: (E, C, D); weights (E, D, F) / (E, F, D)."""
    h = torch.einsum("ecd,edf->ecf", xe, w1)
    h = silu(h) * torch.einsum("ecd,edf->ecf", xe, w3)
    return torch.einsum("ecf,efd->ecd", h, w2)


def top_k_stable(x, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, the lower
    index first among equal values (``torch.topk`` promises no order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx, n: int, dtype):
    """``jax.nn.one_hot``: an index outside ``[0, n)`` is a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _moe_reference(x2, p, cfg: ModelConfig):
    """Single-device GShard-style dispatch, tokens past an expert's
    capacity dropped in (token, choice) order."""
    T, D = x2.shape
    E, k = cfg.n_experts, cfg.top_k
    # XLA feeds the float32 product to the softmax, unrounded
    logits = x2.float() @ p["router"].float()
    probs = softmax(logits)
    gate_vals, gate_idx = top_k_stable(probs, k)            # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    C = max(int(math.ceil(T * k * cfg.capacity_factor / E)), 1)
    # position of each (token, choice) within its expert queue
    onehot_e = _one_hot(gate_idx, E, torch.int32)           # (T,k,E)
    flat = onehot_e.reshape(T * k, E)
    pos = (torch.cumsum(flat, dim=0, dtype=torch.int32) - flat
           ).reshape(T, k, E)
    pos = (pos * onehot_e).sum(-1)                          # (T, k)
    keep = pos < C
    disp = ((_one_hot(gate_idx, E, x2.dtype) * keep[..., None]
             )[:, :, :, None] * _one_hot(pos, C, x2.dtype)[:, :, None, :])
    dispatch = disp.sum(1)                                  # (T, E, C)
    combine = (disp * gate_vals[:, :, None, None].to(x2.dtype)
               ).sum(1)                                     # (T, E, C)
    xe = torch.einsum("tec,td->ecd", dispatch, x2)
    ye = _expert_ffn(xe, p["w1"], p["w3"], p["w2"])
    return torch.einsum("tec,ecd->td", combine, ye)


def _axes_in(axes, ctx) -> tuple:
    """The names of ``axes`` that the context's mesh has."""
    sizes = dctx.axis_sizes(ctx.mesh)
    return tuple(a for a in axes if a in sizes)


def _route(x_l, router, k: int):
    """Gates and experts of each token: the top ``k`` of the float32
    softmax over the float32 router product, renormalised."""
    probs = softmax(x_l.float() @ router.float())
    gate_vals, gate_idx = top_k_stable(probs, k)
    return gate_vals / gate_vals.sum(-1, keepdim=True), gate_idx


def _moe_ep_shard_map(x2, p, cfg: ModelConfig, ctx: dctx.ShardCtx):
    """Production path: tokens sharded over every mesh axis, experts over
    the model axis with FSDP (F-dim) resharding gathered per use;
    dispatch/return via explicit all-to-all (HitGraph's crossbar
    analogue)."""
    mesh = ctx.mesh
    sizes = dctx.axis_sizes(mesh)
    tok_axes = tuple(a for a in (*ctx.token_axes, ctx.expert_axis)
                     if a in sizes)
    # hierarchical FSDP: expert weights are F-sharded over 'data' only
    # (replicated across pods)
    fsdp_axes = tuple(a for a in ("data",) if a in sizes)
    n_tok_shards = int(np.prod([sizes[a] for a in tok_axes]))
    T, D = x2.shape
    E, k = cfg.n_experts, cfg.top_k
    Tl = T // n_tok_shards
    C = max(int(math.ceil(Tl * k * cfg.capacity_factor / E)), 1)

    def local_moe(x_l, router, w1, w3, w2):
        # x_l: (Tl, D); router (D, E); w* sharded (E_l, D, F/fsdp)
        w1 = dctx.all_gather(w1, fsdp_axes, axis=2)
        w3 = dctx.all_gather(w3, fsdp_axes, axis=2)
        w2 = dctx.all_gather(w2, fsdp_axes, axis=1)
        gate_vals, gate_idx = _route(x_l, router, k)
        onehot_e = _one_hot(gate_idx, E, torch.int32)
        flat = onehot_e.reshape(Tl * k, E)
        pos = (torch.cumsum(flat, dim=0, dtype=torch.int32) - flat
               ).reshape(Tl, k, E)
        pos = (pos * onehot_e).sum(-1)
        keep = pos < C
        oh = _one_hot(gate_idx, E, x_l.dtype) * keep[..., None]
        ohc = _one_hot(pos, C, x_l.dtype)
        disp = oh[:, :, :, None] * ohc[:, :, None, :]
        dispatch = disp.sum(1)                           # (Tl, E, C)
        combine = (disp * gate_vals[..., None, None].to(x_l.dtype)).sum(1)
        send = torch.einsum("tec,td->ecd", dispatch, x_l)  # (E, C, D)
        recv = dctx.all_to_all(send, ctx.expert_axis, split_axis=0,
                               concat_axis=1)
        ye = _expert_ffn(recv, w1, w3, w2)               # (E_l, C*nm, D)
        back = dctx.all_to_all(ye, ctx.expert_axis, split_axis=1,
                               concat_axis=0)
        return torch.einsum("tec,ecd->td", combine, back)

    fs = fsdp_axes if fsdp_axes else None
    fx = dctx.shard_map(
        local_moe, mesh=mesh,
        in_specs=(P(tok_axes, None), P(None, None),
                  P(ctx.expert_axis, None, fs),
                  P(ctx.expert_axis, None, fs),
                  P(ctx.expert_axis, fs, None)),
        out_specs=P(tok_axes, None),
    )
    return fx(x2, p["router"], p["w1"], p["w3"], p["w2"])


def _moe_ep_psum(x2, p, cfg: ModelConfig, ctx: dctx.ShardCtx):
    """Decode-scale EP: tokens sharded over the token axes only and
    replicated over the expert (model) axis; each model shard computes
    its local experts' contributions for all its tokens and the combine
    is a psum over the expert axis.  No all-to-all: the right trade at
    small token counts where per-(shard,expert) capacities round to 0."""
    mesh = ctx.mesh
    sizes = dctx.axis_sizes(mesh)
    tok_axes = tuple(a for a in ctx.token_axes if a in sizes)
    fsdp_axes = tuple(a for a in ("data",) if a in sizes)
    n_tok_shards = int(np.prod([sizes[a] for a in tok_axes]))
    n_model = sizes[ctx.expert_axis]
    T, D = x2.shape
    E, k = cfg.n_experts, cfg.top_k
    E_l = E // n_model
    Tl = T // n_tok_shards
    C = max(int(math.ceil(Tl * k * cfg.capacity_factor / E)), 1)

    def local_moe(x_l, router, w1, w3, w2):
        w1 = dctx.all_gather(w1, fsdp_axes, axis=2)
        w3 = dctx.all_gather(w3, fsdp_axes, axis=2)
        w2 = dctx.all_gather(w2, fsdp_axes, axis=1)
        e0 = dctx.axis_index(ctx.expert_axis) * E_l
        gate_vals, gate_idx = _route(x_l, router, k)       # global experts
        local_idx = gate_idx - e0                          # (Tl, k)
        in_range = (local_idx >= 0) & (local_idx < E_l)
        oh = _one_hot(torch.where(in_range, local_idx, E_l), E_l + 1,
                      x_l.dtype)[..., :E_l]
        flat = oh.reshape(Tl * k, E_l)
        pos = (torch.cumsum(flat, dim=0) - flat).reshape(Tl, k, E_l)
        pos = (pos * oh).sum(-1).to(torch.int32)
        keep = pos < C
        oh = oh * keep[..., None]
        ohc = _one_hot(pos, C, x_l.dtype)
        disp = oh[:, :, :, None] * ohc[:, :, None, :]
        dispatch = disp.sum(1)                             # (Tl, E_l, C)
        combine = (disp * gate_vals[..., None, None].to(x_l.dtype)).sum(1)
        xe = torch.einsum("tec,td->ecd", dispatch, x_l)
        ye = _expert_ffn(xe, w1, w3, w2)
        y_partial = torch.einsum("tec,ecd->td", combine, ye)
        return dctx.psum(y_partial, ctx.expert_axis)

    fs = fsdp_axes if fsdp_axes else None
    fx = dctx.shard_map(
        local_moe, mesh=mesh,
        in_specs=(P(tok_axes, None), P(None, None),
                  P(ctx.expert_axis, None, fs),
                  P(ctx.expert_axis, None, fs),
                  P(ctx.expert_axis, fs, None)),
        out_specs=P(tok_axes, None),
    )
    return fx(x2, p["router"], p["w1"], p["w3"], p["w2"])


def moe_mode(T: int, cfg: ModelConfig, ctx) -> str:
    """``repro``'s choice of MoE dispatch for ``T`` tokens: ``reference``
    without a mesh context; ``a2a`` (train / prefill) where every mesh
    axis divides the tokens; ``psum`` (decode) where the token axes do;
    else ``reference``.  Both EP modes need the expert axis to divide the
    experts."""
    if ctx is None:
        return "reference"
    sizes = dctx.axis_sizes(ctx.mesh)
    all_axes = tuple(a for a in (*ctx.token_axes, ctx.expert_axis)
                     if a in sizes)
    tok_axes = tuple(a for a in ctx.token_axes if a in sizes)
    n_all = int(np.prod([sizes[a] for a in all_axes]))
    n_tok = int(np.prod([sizes[a] for a in tok_axes]))
    n_model = sizes[ctx.expert_axis]
    if T % n_all == 0 and T // n_all >= 1 and cfg.n_experts % n_model == 0:
        return "a2a"            # train/prefill: all-to-all dispatch
    if T % n_tok == 0 and cfg.n_experts % n_model == 0:
        return "psum"           # decode: replicated-dispatch EP
    return "reference"


def moe_ffn(x, p, cfg: ModelConfig):
    """x: (B, S, D) -> (B, S, D), dispatched as :func:`moe_mode` says."""
    B, S, D = x.shape
    x2 = x.reshape(B * S, D)
    ctx = dctx.current()
    mode = moe_mode(B * S, cfg, ctx)
    if mode == "a2a":
        # tokens come back sharded over every axis; DTensor cannot split
        # a dim sharded over two mesh dims into (B, S), so they are
        # gathered over the expert axis first
        y = dctx.constrain_spec(_moe_ep_shard_map(x2, p, cfg, ctx),
                                P(_axes_in(ctx.token_axes, ctx), None))
    elif mode == "psum":
        y = _moe_ep_psum(x2, p, cfg, ctx)
    else:
        y = _moe_reference(x2, p, cfg)
    y = y.reshape(B, S, D)
    if cfg.moe_dense_residual:
        y = y + mlp(x, p["dense"], _dense_sub(cfg))
    return y


# ---------------------------------------------------------------------------
# modules: a layer's parameters, its function as ``forward``
# ---------------------------------------------------------------------------

class ParamTree(nn.Module):
    """A node of the parameter tree: tensors as (frozen) parameters,
    sub-dicts as child nodes, lists as ``ModuleList``s.  ``tree()`` gives
    the nested dict the functions above take.  ``model.trainable`` sets the
    parameters to require grad for training."""

    #: child class by name (the rest are plain nodes)
    CHILDREN: Dict[str, type] = {}

    def __init__(self, cfg: ModelConfig, tree: Dict, children=None):
        super().__init__()
        self.cfg = cfg
        self._names = list(tree)
        children = self.CHILDREN if children is None else children
        for name, value in tree.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))
            else:
                self.add_module(name, _node(children.get(name, ParamTree),
                                            cfg, value))

    def tree(self) -> Dict:
        out = {}
        for name in self._names:
            v = getattr(self, name)
            out[name] = (v.tree() if isinstance(v, (ParamTree, NodeList))
                         else v)
        return out


class NodeList(nn.ModuleList):
    """A list of nodes (a stack of layers) with ``tree()`` as a list."""

    def tree(self):
        return [m.tree() for m in self]


def _node(cls, cfg, value):
    if isinstance(value, (list, tuple)):
        return NodeList([_node(cls, cfg, v) for v in value])
    return cls(cfg, value)


class Attention(ParamTree):
    def forward(self, x, **kw):
        return attention(x, self.tree(), self.cfg, **kw)


class MLP(ParamTree):
    def forward(self, x):
        return mlp(x, self.tree(), self.cfg)


class MoE(ParamTree):
    CHILDREN = {"dense": MLP}

    def forward(self, x):
        return moe_ffn(x, self.tree(), self.cfg)
