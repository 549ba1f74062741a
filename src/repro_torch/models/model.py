"""Unified model: init / forward / prefill / decode for all 10 assigned
architectures (a port of ``repro.models.model``).

Families and their block structure (see configs/):

dense | vlm   x += attn(ln1(x)); x += mlp(ln2(x))
moe           x += attn(ln1(x)); x += moe_ffn(ln2(x))   [+ dense branch]
hybrid        x += attn(ln1(x)) + mamba(ln1(x));  x += mlp(ln2(x))
audio         whisper enc (bidir) -> dec (causal + cross-attn)
ssm           xLSTM groups: (group-1) x mLSTM blocks + 1 sLSTM block

Parameters are an :class:`LM` (``nn.Module``) or its tree: ``repro``'s
nested dict with each stacked per-layer axis a list (``blocks[i]``,
``m_blocks[g][j]``).  Every entry point takes either.  Parameters stay in
``cfg.param_dtype``; each layer computes in ``cfg.dtype`` (``repro``'s
``_cast_tree``).  Caches are dicts of tensors with ``repro``'s keys, one
dict a layer.  ``remat`` recomputes each block in the backward pass of a
train-mode :func:`forward` under autograd (``torch.utils.checkpoint``, as
``repro`` applies ``jax.checkpoint`` a layer); it changes memory only.
``scan_layers`` is a JAX compile knob that changes nothing here: the
layers run one after another either way.  The entry points run on the
card unless the caller passes ``device="cpu"``; ``prefill`` and
``decode_step`` serve under ``torch.inference_mode()``, ``forward`` runs
under autograd when the caller enables it (:func:`trainable`).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed import context as dctx
from repro_torch.distributed.context import PartitionSpec as P
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.tree import leaves

Params = Dict[str, Any]


def _dt(cfg: ModelConfig):
    return getattr(torch, cfg.param_dtype)


def _cdt(cfg: ModelConfig):
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class Block(L.ParamTree):
    """One layer of the attention families; ``forward`` is
    :func:`_block_apply`."""

    CHILDREN = {"attn": L.Attention, "cross": L.Attention, "mlp": L.MLP,
                "moe": L.MoE, "mamba": S.Mamba}

    def forward(self, x, *, positions, mode, cache=None, enc_out=None):
        return _block_apply(x, self.tree(), self.cfg, positions=positions,
                            mode=mode, cache=cache, enc_out=enc_out)


class DenseBlock(Block):
    """dense and vlm: attention, then the MLP."""


class MoEBlock(Block):
    """moe: attention, then the expert FFN (+ its dense branch)."""


class HybridBlock(Block):
    """hybrid: attention and Mamba side by side, then the MLP."""


class DecoderBlock(Block):
    """audio's decoder: causal attention, cross-attention, the MLP."""


class EncoderBlock(L.ParamTree):
    """audio's encoder: bidirectional attention, then the MLP."""

    CHILDREN = {"attn": L.Attention, "mlp": L.MLP}

    def forward(self, x, positions):
        return _enc_block(x, self.tree(), self.cfg, positions)


class MLSTMBlock(L.ParamTree):
    CHILDREN = {"mlstm": S.MLSTM}

    def forward(self, x, state=None):
        return _m_block(x, self.tree(), self.cfg, state)


class SLSTMBlock(L.ParamTree):
    CHILDREN = {"slstm": S.SLSTM}

    def forward(self, x, state=None):
        return _s_block(x, self.tree(), self.cfg, state)


_BLOCKS = {"dense": DenseBlock, "vlm": DenseBlock, "moe": MoEBlock,
           "hybrid": HybridBlock, "audio": DecoderBlock}


class LM(L.ParamTree):
    """The whole model's parameters, named as ``repro``'s tree (``embed``,
    ``blocks.0.attn.wq``, ``m_blocks.0.0.mlstm.wq``, ...)."""

    def __init__(self, cfg: ModelConfig, tree: Dict):
        super().__init__(cfg, tree, children={
            "blocks": _BLOCKS.get(cfg.family), "enc_blocks": EncoderBlock,
            "m_blocks": MLSTMBlock, "s_blocks": SLSTMBlock})

    def forward(self, tokens, extra=None, mode="train"):
        return forward(self, tokens, self.cfg, extra=extra, mode=mode,
                       device=self.embed.device)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(gen, cfg: ModelConfig, kind: str, device) -> Params:
    dt = _dt(cfg)
    p: Params = {"ln1": torch.ones((cfg.d_model,), dtype=dt, device=device)}
    if kind in ("dense", "moe", "hybrid", "enc", "dec"):
        p["attn"] = L.init_attention(gen, cfg, dt, device)
    if kind == "hybrid":
        p["mamba"] = S.init_mamba(gen, cfg, dt, device)
    if kind == "dec":
        p["ln_cross"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
        p["cross"] = L.init_attention(gen, cfg, dt, device)
    if kind == "moe":
        p["ln2"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
        p["moe"] = L.init_moe(gen, cfg, dt, device)
    elif kind in ("dense", "hybrid", "enc", "dec"):
        p["ln2"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
        p["mlp"] = L.init_mlp(gen, cfg, dtype=dt, device=device)
    if kind == "mlstm":
        p["mlstm"] = S.init_mlstm(gen, cfg, dt, device)
    if kind == "slstm":
        p["slstm"] = S.init_slstm(gen, cfg, dt, device)
    return p


def _stack_init(gen, cfg, kind, n, device) -> List[Params]:
    return [_init_block(gen, cfg, kind, device) for _ in range(max(n, 1))]


def _device(device) -> torch.device:
    """``resolve_device``, and the ``meta`` device as it is (shapes and
    dtypes only: ``launch.specs``)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> LM:
    """Random parameters of ``repro``'s names, shapes and dtypes, drawn
    from ``repro``'s distributions (``normal / sqrt(fan_in)``, the
    embedding ``normal * 0.02``, norms one) with ``generator`` (a
    ``torch.Generator`` on ``device``; seeded 0 when omitted).  On the
    ``meta`` device nothing is drawn or allocated."""
    dev = _device(device)
    gen = generator
    if gen is None and dev.type != "meta":
        gen = torch.Generator(device=dev).manual_seed(0)
    dt = _dt(cfg)
    p: Params = {
        "embed": (torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                              device=dev) * 0.02).to(dt),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L._dense_init(gen, (cfg.d_model, cfg.vocab),
                                     cfg.d_model, dt, dev)
    fam = cfg.family
    if fam in ("dense", "vlm"):
        p["blocks"] = _stack_init(gen, cfg, "dense", cfg.n_layers, dev)
    elif fam == "moe":
        p["blocks"] = _stack_init(gen, cfg, "moe", cfg.n_layers, dev)
    elif fam == "hybrid":
        p["blocks"] = _stack_init(gen, cfg, "hybrid", cfg.n_layers, dev)
    elif fam == "audio":
        p["blocks"] = _stack_init(gen, cfg, "dec", cfg.n_layers, dev)
        p["enc_blocks"] = _stack_init(gen, cfg, "enc", cfg.enc_layers, dev)
        p["enc_norm"] = torch.ones((cfg.d_model,), dtype=dt, device=dev)
    elif fam == "ssm":
        g = cfg.xlstm_group
        n_groups = cfg.n_layers // g
        p["m_blocks"] = [_stack_init(gen, cfg, "mlstm", g - 1, dev)
                         for _ in range(n_groups)]
        p["s_blocks"] = _stack_init(gen, cfg, "slstm", n_groups, dev)
    if fam == "vlm":
        p["img_adapter"] = L._dense_init(gen, (cfg.d_model, cfg.d_model),
                                         cfg.d_model, dt, dev)
    return LM(cfg, p)


# ---------------------------------------------------------------------------
# parameters, devices, casts
# ---------------------------------------------------------------------------

def _tree(params) -> Params:
    return params.tree() if isinstance(params, L.ParamTree) else params


def trainable(params):
    """Set every floating tensor of ``params`` (an :class:`LM` or its tree)
    to require grad, in place; returns ``params``.  :func:`init_params`
    and ``interop.lm_params`` return frozen trees for serving."""
    for t in leaves(_tree(params)):
        if t.is_floating_point() and not t.requires_grad:
            t.requires_grad_(True)
    return params


def _cast_tree(p, dtype):
    """Every floating tensor of ``p`` in ``dtype`` (no copy where it
    already is)."""
    if isinstance(p, dict):
        return {k: _cast_tree(v, dtype) for k, v in p.items()}
    if isinstance(p, (list, tuple)):
        return type(p)(_cast_tree(v, dtype) for v in p)
    return p.to(dtype) if p.is_floating_point() else p


def compute_params(params, cfg: ModelConfig) -> Params:
    """The tree cast once to the compute dtype: what every layer casts to
    anyway, so a caller that serves many steps (``generate``) pays the
    cast once instead of once a layer a step."""
    return _cast_tree(_tree(params), _cdt(cfg))


def _place(params, tokens, device):
    """The tree and the tokens on the resolved device; parameters on
    another device raise (they are never moved silently)."""
    dev = resolve_device(device)
    p = _tree(params)
    if p["embed"].device.type != dev.type:
        raise ValueError(f"parameters are on {p['embed'].device}, the call "
                         f"runs on {dev}")
    return p, torch.as_tensor(tokens, device=dev), dev


# ---------------------------------------------------------------------------
# blocks (single-layer apply; caches optional)
# ---------------------------------------------------------------------------

def _block_apply(x, bp, cfg: ModelConfig, *, positions, mode,
                 cache=None, enc_out=None):
    """One layer.  Returns (x, new_cache)."""
    fam = cfg.family
    cdt = _cdt(cfg)
    bp = _cast_tree(bp, cdt)           # mixed precision: bf16 compute
    new_cache: Dict[str, Any] = {}
    h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)

    if fam == "ssm":
        raise AssertionError("ssm handled by _ssm_forward")

    attn_mode = mode if mode in ("decode", "prefill") else "causal"
    attn_out, attn_cache = L.attention(
        h, bp["attn"], cfg, positions=positions, mode=attn_mode,
        layer_cache=None if cache is None else cache.get("attn"))
    if attn_cache is not None:
        new_cache["attn"] = attn_cache
    if fam == "hybrid":
        m_state_in = None
        if cache is not None:
            m_state_in = cache.get("mamba")
        elif mode == "prefill":
            m_state_in = S.init_mamba_state(cfg, h.shape[0], h.dtype,
                                            h.device)
        m_out, m_state = S.mamba(h, bp["mamba"], cfg, state=m_state_in)
        attn_out = attn_out + m_out
        if m_state is not None:
            new_cache["mamba"] = m_state
    # the residual laid out as at the block's edges (``act_btd``): the
    # attention's output is a partial sum over ``model``, which DTensor
    # would otherwise reduce by cutting the sequence
    x = dctx.constrain(x + attn_out, "act_btd")

    if fam == "audio" and (enc_out is not None or
                           (cache is not None and "cross_kv" in cache)):
        hc = L.rms_norm(x, bp["ln_cross"], cfg.norm_eps)
        if cache is not None and "cross_kv" in cache:
            ck, cv = cache["cross_kv"]
        else:
            ck = L.split_heads(enc_out @ bp["cross"]["wk"], cfg.n_kv_heads,
                               cfg.hd)
            cv = L.split_heads(enc_out @ bp["cross"]["wv"], cfg.n_kv_heads,
                               cfg.hd)
        c_out, _ = L.attention(hc, bp["cross"], cfg, positions=None,
                               mode="cross", cross_kv=(ck, cv))
        x = dctx.constrain(x + c_out, "act_btd")
        if mode in ("prefill", "decode"):
            new_cache["cross_kv"] = (ck, cv)

    h2 = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
    if fam == "moe":
        x = x + L.moe_ffn(h2, bp["moe"], cfg)
    else:
        x = x + L.mlp(h2, bp["mlp"], cfg)
    x = dctx.constrain(x, "act_btd")
    return x, (new_cache if new_cache else None)


def _enc_block(x, bp, cfg: ModelConfig, positions):
    bp = _cast_tree(bp, _cdt(cfg))
    h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
    out, _ = L.attention(h, bp["attn"], cfg, positions=positions,
                         mode="bidir")
    x = dctx.constrain(x + out, "act_btd")        # as in _block_apply
    h2 = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
    return dctx.constrain(x + L.mlp(h2, bp["mlp"], cfg), "act_btd")


def _m_block(x, bp, cfg: ModelConfig, st):
    bp = _cast_tree(bp, _cdt(cfg))
    h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
    out, new_st = S.mlstm(h, bp["mlstm"], cfg, state=st)
    # the residual laid out as at the block's edges, as in _block_apply
    return dctx.constrain(x + out, "act_btd"), new_st


def _s_block(x, bp, cfg: ModelConfig, st):
    bp = _cast_tree(bp, _cdt(cfg))
    h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
    out, new_st = S.slstm(h, bp["slstm"], cfg, state=st)
    return dctx.constrain(x + out, "act_btd"), new_st


# ---------------------------------------------------------------------------
# forward (train / prefill), one layer after another
# ---------------------------------------------------------------------------

def _embed(params, tokens, cfg):
    if dctx.current() is None:
        x = params["embed"][tokens.long()]
    else:
        x = L.embed_lookup(params["embed"], tokens)
    x = x.to(_cdt(cfg))
    if cfg.family == "dense" and "gemma" in cfg.name:
        x = x * L.weak(cfg.d_model ** 0.5, x)
    return x


def _ssm_state(cfg: ModelConfig, batch: int, device) -> Dict:
    """Fresh xLSTM states: ``m[group][block]`` mLSTM, ``s[group]`` sLSTM."""
    g = cfg.xlstm_group
    n_groups = cfg.n_layers // g
    return {"m": [[S.init_mlstm_state(cfg, batch, device)
                   for _ in range(g - 1)] for _ in range(n_groups)],
            "s": [S.init_slstm_state(cfg, batch, device)
                  for _ in range(n_groups)]}


def _ssm_forward(params, x, cfg: ModelConfig, caches=None, mode="train"):
    """xLSTM stack: a loop over groups, the group's mLSTM blocks, then its
    sLSTM block (7:1 in the 1.3b config).  ``caches`` carries (C, n) /
    (h, c, n, m) states for prefill/decode; train runs stateless."""
    stateful = mode in ("prefill", "decode")
    if stateful and caches is None:
        caches = _ssm_state(cfg, x.shape[0], x.device)
    new_m, new_s = [], []
    for gi, group in enumerate(params["m_blocks"]):
        states = []
        for j, bp in enumerate(group):
            x, st = _m_block(x, bp, cfg,
                             caches["m"][gi][j] if stateful else None)
            states.append(st)
        new_m.append(states)
        x, s_state = _s_block(x, params["s_blocks"][gi], cfg,
                              caches["s"][gi] if stateful else None)
        new_s.append(s_state)
    if not stateful:
        return x, None
    return x, {"m": new_m, "s": new_s}


def _head(params, x, cfg: ModelConfig):
    x = L.rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"])
    logits = x @ head.to(x.dtype)
    return dctx.constrain(logits, "logits")


def _served(logits):
    """The logits a serve step returns.  Under a mesh context with no
    ``logits`` rule (a vocabulary the ``model`` axis does not divide),
    laid out by the batch alone, over the batch axes where they divide
    the rows, else whole: the layout XLA gives ``repro``'s unconstrained
    output, where DTensor would leave uneven vocabulary shards or partial
    sums."""
    ctx = dctx.current()
    if ctx is None or ctx.spec("logits") is not None:
        return logits
    return dctx.constrain_spec(
        logits, P(L._batch_axes(ctx, logits.shape[0]), None, None))


def _remat(cfg: ModelConfig, mode: str) -> bool:
    """Whether a block recomputes in the backward pass: ``cfg.remat`` on a
    train-mode forward that autograd records."""
    return cfg.remat and mode == "train" and torch.is_grad_enabled()


def forward(params, tokens, cfg: ModelConfig,
            extra: Optional[Dict] = None, mode: str = "train", device=None):
    """tokens (B, S) -> logits (B, S_out, V).  extra carries the modality
    stubs: {"frames": (B,F,D)} for audio, {"patches": (B,P,D)} for vlm.

    Returns (logits, caches) — caches is None in train mode, else one
    dict a layer (the xLSTM states for ssm).  Differentiable: gradients
    reach every parameter that requires grad (:func:`trainable`).
    """
    params, tokens, dev = _place(params, tokens, device)
    extra = {k: torch.as_tensor(v, device=dev)
             for k, v in (extra or {}).items()}
    x = _embed(params, tokens, cfg)
    x = dctx.constrain(x, "act_btd")
    prefix = 0
    if cfg.family == "vlm":
        patches = (extra["patches"].to(_cdt(cfg))
                   @ params["img_adapter"].to(_cdt(cfg)))
        x = torch.cat([patches, x], dim=1)
        prefix = patches.shape[1]
    enc_out = None
    if cfg.family == "audio":
        enc_out = _encoder(params, extra["frames"], cfg, _remat(cfg, mode))
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=dev)

    if cfg.family == "ssm":
        x, caches = _ssm_forward(params, x, cfg, caches=None, mode=mode)
    elif _remat(cfg, mode):
        caches = None
        for bp in params["blocks"]:
            x = checkpoint(_under, dctx.current(), _train_block, x, bp,
                           cfg, positions, enc_out,
                           use_reentrant=False)
    else:
        caches = [] if mode == "prefill" else None
        for bp in params["blocks"]:
            x, c = _block_apply(x, bp, cfg, mode=mode, positions=positions,
                                enc_out=enc_out)
            if caches is not None:
                caches.append(c)

    logits = _head(params, x, cfg)
    if prefix:
        logits = logits[:, prefix:]
    return logits, caches


def _under(ctx, fn, *args):
    """``fn(*args)`` under the sharding context ``ctx``: a block that
    ``remat`` recomputes in the backward pass (which autograd may run on
    another thread) sees the context its forward saw."""
    with dctx.use(ctx):
        return fn(*args)


def _train_block(x, bp, cfg, positions, enc_out):
    return _block_apply(x, bp, cfg, mode="train", positions=positions,
                        enc_out=enc_out)[0]


def _encoder(params, frames, cfg: ModelConfig, remat: bool = False):
    x = frames.to(_cdt(cfg))
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for bp in params["enc_blocks"]:
        if remat:
            x = checkpoint(_under, dctx.current(), _enc_block, x, bp, cfg,
                           positions,
                           use_reentrant=False)
        else:
            x = _enc_block(x, bp, cfg, positions)
    return L.rms_norm(x, params["enc_norm"].to(x.dtype), cfg.norm_eps)


# ---------------------------------------------------------------------------
# serving: cache init + single-token decode
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, batch: int, smax: int, device=None):
    """Pre-allocated decode state for a context of ``smax`` tokens.
    Sliding-window archs allocate only the window (ring buffer); on the
    ``meta`` device nothing is allocated."""
    dev = _device(device)
    cdt = _cdt(cfg)
    win = cfg.sliding_window
    attn_len = min(smax, win) if win else smax
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.family == "ssm":
        return {**_ssm_state(cfg, batch, dev), "pos": pos}

    def per_layer():
        c = {"attn": L.init_attn_cache(cfg, batch, attn_len, cdt, dev)}
        if cfg.family == "hybrid":
            c["mamba"] = S.init_mamba_state(cfg, batch, cdt, dev)
        if cfg.family == "audio":
            shape = (batch, cfg.enc_frames, cfg.n_kv_heads, cfg.hd)
            c["cross_kv"] = (torch.zeros(shape, dtype=cdt, device=dev),
                             torch.zeros(shape, dtype=cdt, device=dev))
        return c

    return {"layers": [per_layer() for _ in range(cfg.n_layers)],
            "pos": pos}


@torch.inference_mode()
def decode_step(params, cache, tokens, cfg: ModelConfig,
                extra: Optional[Dict] = None, device=None):
    """tokens (B, 1) -> (logits (B, 1, V), new_cache).  ``cache`` is left
    as it was."""
    params, tokens, _ = _place(params, tokens, device)
    x = _embed(params, tokens, cfg)
    pos = cache["pos"]

    if "m" in cache:
        x, new_states = _ssm_forward(params, x, cfg,
                                     caches={"m": cache["m"],
                                             "s": cache["s"]},
                                     mode="decode")
        new_cache = {**new_states, "pos": pos + 1}
    else:
        new_layers = []
        for bp, lc in zip(params["blocks"], cache["layers"]):
            x, c = _block_apply(x, bp, cfg, mode="decode", positions=pos,
                                cache=lc, enc_out=None)
            new_layers.append(c)
        new_cache = {"layers": new_layers, "pos": pos + 1}
    return _served(_head(params, x, cfg)), new_cache


@torch.inference_mode()
def prefill(params, tokens, cfg: ModelConfig,
            extra: Optional[Dict] = None, max_len: Optional[int] = None,
            device=None):
    """Prompt processing: returns (last-token logits, populated cache).

    ``max_len`` reserves decode slots in the KV cache (default prompt +
    128; SSM states are O(1) and need no reservation)."""
    logits, caches = forward(params, tokens, cfg, extra=extra,
                             mode="prefill", device=device)
    B, Sp = tokens.shape
    pos = torch.full((), Sp, dtype=torch.int32, device=logits.device)
    if cfg.family == "ssm":
        return _served(logits[:, -1:]), {**caches, "pos": pos}
    target = max_len if max_len is not None else Sp + 128
    if cfg.sliding_window:
        target = max(min(target, cfg.sliding_window), Sp)
    pad = max(target - Sp, 0)
    if pad:
        # each rank pads its own rows: the sequence is whole on every rank
        grow = functools.partial(F.pad, pad=(0, 0, 0, 0, 0, pad))
        for c in caches:
            attn = dict(c["attn"])
            attn["k"] = dctx.on_local(grow, attn["k"])
            attn["v"] = dctx.on_local(grow, attn["v"])
            attn["pos_slots"] = F.pad(attn["pos_slots"], (0, pad),
                                      value=-(1 << 30))
            c["attn"] = attn
    return _served(logits[:, -1:]), {"layers": caches, "pos": pos}
