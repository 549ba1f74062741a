"""Transformer building blocks: norms, RoPE, GQA attention (train /
prefill / chunked-long / decode), MLPs, and the MoE FFN (the reference
dense dispatch).

A port of ``repro.models.layers``.  The functions keep ``repro``'s names
and take parameters as dicts of tensors, so each is held to its
counterpart on the same weights; the ``nn.Module`` classes at the end
hold a layer's parameters and call them.  Every cast, mask constant and
contraction order follows ``repro``'s ``jnp`` code: bf16 products,
float32 scores and softmax, probabilities cast back to the compute dtype
before the value product.  Where XLA, compiling ``repro``, keeps a
result in float32 for a float32 consumer, the port computes it in
float32 too: the scores are the bf16 product times the float32
reciprocal of the bf16-rounded sqrt(Dh), as XLA rewrites the division.  The expert-parallel MoE paths wait for the LM
sharding (``distributed.context`` raises where a mesh is installed).
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


def _qkv(x, p, cfg: ModelConfig, positions):
    B, S, _ = x.shape
    hd = cfg.hd
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
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
    Sk = k.shape[1]
    G = cfg.q_per_kv
    qg = q.reshape(B, Sq, cfg.n_kv_heads, G, Dh)
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
    over query chunks, an inner online softmax over every KV chunk (as
    ``repro``'s scan visits them) — scores never materialize beyond
    (B, Hkv, G, cq, ck)."""
    B, S, H, Dh = q.shape
    G = cfg.q_per_kv
    c = cfg.attn_chunk
    assert S % c == 0, (S, c)
    nq = S // c
    Hkv = cfg.n_kv_heads
    qg = q.reshape(B, nq, c, Hkv, G, Dh)
    kc = k.reshape(B, nq, c, Hkv, Dh)
    vc = v.reshape(B, nq, c, Hkv, Dh)
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
            s = torch.einsum("bskgd,btkd->bkgst", q_blk, kc[:, ki])
            s = s.float() * weak(scale, s)
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
                                  vc[:, ki]))
            m = m_new
        out = acc / l.permute(0, 3, 1, 2)[..., None]
        outs.append(out.reshape(B, c, H * Dh).to(q.dtype))
    return torch.stack(outs, dim=1).reshape(B, S, H * Dh)


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
        hd = cfg.hd
        q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, hd)
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k, v = cross_kv
        out = _sdpa(q, k, v, cfg, causal=False)
        return out @ p["wo"], None

    if mode == "decode":
        length = layer_cache["length"]
        positions = positions.reshape(1)
        q, k_new, v_new = _qkv(x, p, cfg, positions)
        Smax = layer_cache["k"].shape[1]
        slot = (length % Smax).reshape(1).long()     # ring for SWA caches
        k = layer_cache["k"].index_copy(1, slot, k_new)
        v = layer_cache["v"].index_copy(1, slot, v_new)
        pos_slots = layer_cache["pos_slots"].index_copy(
            0, slot, positions.to(layer_cache["pos_slots"].dtype))
        kpos = pos_slots[None, :]                    # (1, Smax)
        qpos = positions.reshape(1, 1)
        scores_mask = (kpos <= qpos) & (kpos > qpos - (win or 1 << 30))
        valid = torch.arange(Smax, device=x.device)[None, :] <= length
        mask = scores_mask & valid
        G = cfg.q_per_kv
        qg = q.reshape(B, S, cfg.n_kv_heads, G, cfg.hd)
        scores = torch.einsum("bskgd,btkd->bkgst", qg, k)
        scores = scores.float() * _recip32(weak(math.sqrt(cfg.hd), scores))
        scores = torch.where(mask[None, None, None], scores, NEG)
        probs = softmax(scores).to(x.dtype)
        out = torch.einsum("bkgst,btkd->bskgd", probs, v)
        out = out.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"]
        new_cache = {"k": k, "v": v, "pos_slots": pos_slots,
                     "length": length + 1}
        return out, new_cache

    q, k, v = _qkv(x, p, cfg, positions)
    if mode == "bidir":
        out = _sdpa(q, k, v, cfg, causal=False)
    elif takes_chunked_route(cfg, S):
        out = _sdpa_chunked(q, k, v, cfg, window=win)
    else:
        out = _sdpa(q, k, v, cfg, causal=True, window=win)
    out = out @ p["wo"]
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
    h = x @ p["w1"]
    if cfg.act == "silu":
        h = silu(h) * (x @ p["w3"])
    elif cfg.act == "geglu":
        h = gelu(h) * (x @ p["w3"])
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


def moe_ffn(x, p, cfg: ModelConfig):
    """x: (B, S, D) -> (B, S, D), the reference dispatch (a mesh context
    is refused by ``constrain`` before this is reached)."""
    B, S, D = x.shape
    y = _moe_reference(x.reshape(B * S, D), p, cfg).reshape(B, S, D)
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
