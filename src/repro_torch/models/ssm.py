"""State-space / recurrent blocks: Mamba (Hymba's parallel heads) and
xLSTM's mLSTM + sLSTM.

A port of ``repro.models.ssm``.  All recurrences are chunked as there:
within a chunk Mamba's recurrence runs as a log-depth inclusive scan
(``repro`` uses ``jax.lax.associative_scan``; the two differ only by
float32 rounding) and mLSTM's in matmul form; chunks chain through
:func:`scan`, ``jax.lax.scan``'s counterpart, carrying O(state) memory,
and both chunk bodies are rematerialized in the backward pass
(:func:`remat`), as ``repro`` wraps them in ``jax.checkpoint``.
sLSTM steps through time.  As in ``layers``, the port follows XLA's
float32 where ``repro``'s results depend on it: mLSTM's exp of the input
gate stays float32 for its float32 product, and its gate cumsum sums in
XLA's order (:func:`_prefix_sum`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import context as dctx
from repro_torch.distributed.context import PartitionSpec as P
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (ParamTree, _batch_axes, _dense_init,
                                      silu, softplus, split_heads, weak)

CHUNK = 256


def scan(step, carry, xs, size: Optional[int] = None):
    """``jax.lax.scan`` along dim 1 of the tensors ``xs``: ``step(carry,
    x) -> (carry, y)`` for each position of dim 1 (``x`` the tensors at
    that index, the ``y``s stacked on dim 1), or with ``size`` for each
    block of ``size`` positions (the ``y``s concatenated on dim 1).
    Returns the last carry and the joined ``y``s.

    Under a dry run's counter (:func:`dctx.loop_counter`) with autograd
    off, iterations are dispatched until two in a row count the same;
    the rest are counted as that one repeated, and their outputs are
    that one's again (the values are fake), so the joined output, the
    counts and the peak of live bytes are the full loop's.  A
    differentiated loop runs every iteration."""
    # cut once: one view op a tensor, whose backward joins the pieces'
    # gradients once (a select a step would scatter each step's gradient
    # into a zero tensor of the whole input)
    cut = [x.unbind(1) if size is None else x.split(size, dim=1)
           for x in xs]
    n = len(cut[0])

    def piece(i):
        return tuple(c[i] for c in cut)

    def join(ys):
        return torch.stack(ys, dim=1) if size is None else torch.cat(ys,
                                                                     dim=1)

    counter = dctx.loop_counter()
    ys = []
    if counter is None or torch.is_grad_enabled():
        for i in range(n):
            carry, y = step(carry, piece(i))
            ys.append(y)
        return carry, join(ys)
    # the carry passes through a box so that the iteration lets the old
    # one go before it is counted, as the plain loop's rebinding does
    box, i, last = [carry], 0, None
    while i < n:
        (new, y), delta = counter.iteration(lambda: step(box.pop(),
                                                         piece(i)))
        box.append(new)
        del new
        ys.append(y)
        i += 1
        if delta == last:
            break
        last = delta
    carry = box.pop()
    rest = n - i
    counter.repeat(last, rest)
    out = join(ys + [y] * rest)
    del ys                      # the pieces, and the repeats' stand-ins
    counter.release(y, rest)
    return carry, out


def remat(step):
    """``jax.checkpoint(step)`` for :func:`scan`: where autograd records,
    ``step(carry, x)`` keeps only its inputs for the backward pass, which
    runs it again to rebuild its intermediates (``torch.utils.checkpoint``,
    non-reentrant, given the carry's and ``x``'s tensors one by one, so
    that each is saved as itself); with autograd off it is ``step``."""
    def run(carry, x):
        if not torch.is_grad_enabled():
            return step(carry, x)
        one = not isinstance(carry, tuple)
        c = (carry,) if one else carry

        def body(*a):
            return step(a[0] if one else a[:len(c)], a[len(c):])
        return checkpoint(body, *c, *x, use_reentrant=False,
                          preserve_rng_state=False)
    return run


# ---------------------------------------------------------------------------
# Mamba (selective SSM), simplified but structurally faithful
# ---------------------------------------------------------------------------

def init_mamba(gen, cfg: ModelConfig, dtype, device) -> Dict:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    return {
        "in_proj": _dense_init(gen, (d, 2 * di), d, dtype, device),
        "conv": _dense_init(gen, (cfg.ssm_conv, di), cfg.ssm_conv, dtype,
                            device),
        "x_bc": _dense_init(gen, (di, 2 * n), di, dtype, device),
        "x_dt": _dense_init(gen, (di, 1), di, dtype, device),
        "a_log": (torch.log(torch.linspace(1.0, float(n), n,
                                           device=device)).to(dtype)
                  * torch.ones((di, 1), dtype=dtype, device=device)),
        "d_skip": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": _dense_init(gen, (di, d), di, dtype, device),
    }


def _inclusive_scan(a, b):
    """The inclusive scan of ``(a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2)``
    along axis 1, in log2(length) vectorised rounds."""
    n, off = a.shape[1], 1
    while off < n:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        b = torch.cat([b[:, :off], a[:, off:] * b_prev + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a_prev], dim=1)
        off *= 2
    return a, b


def _selective_scan_chunked(u, dt, B_t, C_t, a_log, h0):
    """u: (B,S,Di); dt: (B,S,Di); B_t/C_t: (B,S,N); h0: (B,Di,N).

    h_t = exp(-exp(a_log) * dt_t) * h_{t-1} + dt_t * u_t * B_t
    y_t = (h_t * C_t).sum(N)
    Chunked scan carrying h between chunks; the (c, Di, N) decay/input
    tensors are formed inside each chunk, so the live working set is
    O(B*c*Di*N), never O(B*S*Di*N).  The chunk body is rematerialized
    (:func:`remat`, as ``repro`` checkpoints it): a differentiated scan
    keeps each chunk's inputs and carry, not its (B, c, Di, N) tensors.
    """
    Bsz, S, Di = u.shape
    c = min(CHUNK, S)
    assert S % c == 0
    A = -torch.exp(a_log.float())                        # (Di, N)

    def chunk(h, xs):
        uc, dtc, bc, cc = xs
        dec = torch.exp(dtc[..., None].float() * A)
        xin = (dtc * uc)[..., None].float() * bc[:, :, None, :].float()
        a_scan, b_scan = _inclusive_scan(dec, xin)
        hs = a_scan * h[:, None] + b_scan                # (B,c,Di,N)
        y = torch.einsum("bcdn,bcn->bcd", hs, cc.float())
        # the carry as a tensor of its own (hs's last row, by the same
        # ops): a view would keep all of hs alive as the next chunk's
        # saved input
        return a_scan[:, -1] * h + b_scan[:, -1], y.to(u.dtype)

    h, y = scan(remat(chunk), h0.float(), (u, dt, B_t, C_t), size=c)
    return y.to(u.dtype), h


def mamba(x, p, cfg: ModelConfig, state: Optional[Dict] = None):
    """x: (B,S,D).  state: {"conv": (B,K-1,Di), "h": (B,Di,N)} for decode.
    Returns (y, new_state)."""
    B, S, D = x.shape
    di, n, k = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    xz = x @ p["in_proj"]
    u, z = torch.split(xz, xz.shape[-1] // 2, dim=-1)
    u = dctx.constrain(u, "act_btf")
    # depthwise causal conv
    if state is not None:
        conv_in = torch.cat([state["conv"], u], dim=1)
    else:
        conv_in = F.pad(u, (0, 0, k - 1, 0))
    windows = torch.stack(
        [conv_in[:, i:i + S, :] for i in range(k)], dim=2)  # (B,S,k,Di)
    u = silu(torch.einsum("bskd,kd->bsd", windows, p["conv"]))
    # both products sum over the model-sharded inner dim: laid out whole
    # before their nonlinear use (DTensor would cut the sequence)
    bc = dctx.constrain(u @ p["x_bc"], "act_btd")
    B_t, C_t = torch.split(bc, bc.shape[-1] // 2, dim=-1)  # (B,S,N)
    dt = softplus(dctx.constrain(u @ p["x_dt"], "act_btd"))  # (B,S,1)
    dt = dt.expand(B, S, di)
    h0 = (state["h"] if state is not None
          else torch.zeros((B, di, n), dtype=torch.float32, device=x.device))
    y, h_last = _selective_scan_chunked(u, dt, B_t, C_t, p["a_log"], h0)
    y = y + u * p["d_skip"]
    y = y * silu(z)
    out = y @ p["out_proj"]
    new_state = None
    if state is not None:
        new_state = {"conv": conv_in[:, -(k - 1):, :], "h": h_last}
    return out, new_state


def init_mamba_state(cfg: ModelConfig, batch: int, dtype, device) -> Dict:
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=device),
    }


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory, chunk-parallel) and sLSTM (sequential)
# ---------------------------------------------------------------------------

def _prefix_sum(x, block: int = 16):
    """Inclusive prefix sum along axis 1 in the order XLA's CPU backend
    sums ``jnp.cumsum``: left to right within blocks of 16, the blocks'
    totals summed the same way (recursively), each block's offset added
    to its sums.  ``torch.cumsum`` orders its float32 sums otherwise."""
    n = x.shape[1]
    if n <= block:
        acc, out = x[:, 0], [x[:, 0]]
        for t in range(1, n):
            acc = acc + x[:, t]
            out.append(acc)
        return torch.stack(out, dim=1)
    nb = -(-n // block)
    pad = x.new_zeros((x.shape[0], nb * block - n) + x.shape[2:])
    xb = torch.cat([x, pad], dim=1).reshape(
        (x.shape[0], nb, block) + x.shape[2:])
    acc, within = xb[:, :, 0], [xb[:, :, 0]]
    for t in range(1, block):
        acc = acc + xb[:, :, t]
        within.append(acc)
    within = torch.stack(within, dim=2)
    offsets = torch.cat([torch.zeros_like(within[:, :1, -1]),
                         _prefix_sum(within[:, :, -1], block)[:, :-1]], dim=1)
    out = offsets[:, :, None] + within
    return out.reshape((x.shape[0], nb * block) + x.shape[2:])[:, :n]


def init_mlstm(gen, cfg: ModelConfig, dtype, device) -> Dict:
    d = cfg.d_model
    di = d * max(cfg.ssm_expand, 1)
    return {
        "in_proj": _dense_init(gen, (d, 2 * di), d, dtype, device),
        "wq": _dense_init(gen, (di, di), di, dtype, device),
        "wk": _dense_init(gen, (di, di), di, dtype, device),
        "wv": _dense_init(gen, (di, di), di, dtype, device),
        "w_if": _dense_init(gen, (di, 2 * cfg.n_heads), di, dtype, device),
        "out_proj": _dense_init(gen, (di, d), di, dtype, device),
    }


def _mlstm_chunks(q, k, v, i_gate, f_gate, C_st, n_st, c: int, dtype):
    """The chunk loop of :func:`mlstm`: q, k ``(B,S,H,dh)``, v ``(B,S,H,
    dv)``, the gates ``(B,S,H)``, the state C ``(B,H,dh,dv)`` and n
    ``(B,H,dh)``.  ``dv`` is ``dh`` or a shard of it: every product keeps
    v's last dim as its own.  The chunk body is rematerialized
    (:func:`remat`, as ``repro`` checkpoints it), so that a differentiated
    loop keeps no chunk's (B, c, c, H) weights.  Returns h ``(B,S,H,dv)``
    in ``dtype``, C and n."""
    mask = (torch.arange(c, device=q.device)[:, None]
            >= torch.arange(c, device=q.device)[None, :])[None, :, :, None]

    def chunk(carry, xs):
        C_st, n_st = carry
        qb, kb, vb, ib, fb = xs
        fcum = _prefix_sum(fb)                             # (B,c,H)
        # decay of the carried state to each position t: exp(fcum_t)
        dec_in = torch.exp(fcum)                           # (B,c,H)
        # intra-chunk weights: exp(fcum_t - fcum_s + i_s), s <= t
        logw = (fcum[:, :, None, :] - fcum[:, None, :, :]
                + ib[:, None, :, :])                       # (B,t,s,H)
        w = torch.exp(torch.where(mask, logw, -math.inf))
        qf, kf, vf = qb.float(), kb.float(), vb.float()
        # intra contribution: sum_s w[t,s] (q_t . k_s) v_s
        scores = torch.einsum("bthd,bshd->bths", qf, kf) * w.permute(
            0, 1, 3, 2)
        intra = torch.einsum("bths,bshd->bthd", scores, vf)
        norm_intra = torch.einsum(
            "bths,bshd->bthd", scores, torch.ones_like(vf[..., :1])
        )[..., 0]
        # inter: q_t . C_carry, decayed
        inter = torch.einsum("bthd,bhde->bthe", qf, C_st) \
            * dec_in[..., None]
        norm_inter = torch.einsum("bthd,bhd->bth", qf, n_st) * dec_in
        denom = torch.clamp(torch.abs(norm_intra + norm_inter), min=1.0)
        h = (intra + inter) / denom[..., None]
        # state update to end of chunk
        dec_all = torch.exp(fcum[:, -1, None, :] - fcum)   # (B,c,H)
        # XLA keeps exp(i) in float32 where a float32 product consumes it
        wk = dec_all * torch.exp(ib.float())
        kv = torch.einsum("bshd,bshe,bsh->bhde", kf, vf, wk)
        C_st = C_st * torch.exp(fcum[:, -1])[:, :, None, None] + kv
        n_st = n_st * torch.exp(fcum[:, -1])[:, :, None] + torch.einsum(
            "bshd,bsh->bhd", kf, wk)
        return (C_st, n_st), h.to(dtype)

    (C_st, n_st), h = scan(remat(chunk), (C_st, n_st),
                           (q, k, v, i_gate, f_gate), size=c)
    return h, C_st, n_st


def mlstm(x, p, cfg: ModelConfig, state: Optional[Dict] = None):
    """Chunkwise mLSTM with matrix memory C (B,H,dh,dh) and normalizer n.

    Within a chunk the recurrence is evaluated in matmul form (decay-
    weighted attention-like products); chunks chain through the carried
    (C, n) state — the standard chunk-recurrent formulation.

    Under a mesh context the chunk loop runs on each rank's shards
    (``shard_map``): the batch over the batch axes; where the
    ``act_ssm_heads`` rule shards the head dim over an axis, v, C's last
    dim and h's head dim over it, q, k and n whole on each of its ranks,
    so that ``k (x) v`` is the rank's block of C and the loop needs no
    collective (``repro`` shards q, k and v alike and lets GSPMD reduce
    the contractions over the head dim).
    """
    B, S, D = x.shape
    H = cfg.n_heads
    di = D * max(cfg.ssm_expand, 1)
    dh = di // H
    xz = x @ p["in_proj"]
    u, z = torch.split(xz, xz.shape[-1] // 2, dim=-1)
    u = dctx.constrain(u, "act_btf")
    q = split_heads(u @ p["wq"], H, dh)
    q = q / weak(math.sqrt(dh), q)
    k = split_heads(u @ p["wk"], H, dh)
    v = split_heads(u @ p["wv"], H, dh)
    # qkv heads are few: under a mesh ``repro`` shards head_dim over the
    # model axis instead (``act_ssm_heads``)
    q = dctx.constrain(q, "act_ssm_heads")
    k = dctx.constrain(k, "act_ssm_heads")
    v = dctx.constrain(v, "act_ssm_heads")
    # a sum over the model-sharded inner dim: laid out whole before the
    # gates are cut apart (DTensor cannot plan the cut's backward from a
    # partial sum on every mesh)
    gates = dctx.constrain(u @ p["w_if"], "act_btd")       # (B,S,2H)
    i_gate = gates[..., :H]
    f_gate = dctx.elementwise(F.logsigmoid, gates[..., H:].float())

    c = min(CHUNK, S)
    assert S % c == 0
    st = () if state is None else (state["C"], state["n"])
    ctx = dctx.current()
    hv = None                  # the axis that cuts v's head dim
    if ctx is not None:
        batch = _batch_axes(ctx, B)
        rule = ctx.spec("act_ssm_heads") or P()
        hv = rule[3] if len(rule) > 3 else None
        whole, cut = P(batch, None, None, None), P(batch, None, None, hv)
        gate = P(batch, None, None)

    def loop(q, k, v, i_gate, f_gate, *st):
        Bl, dv = q.shape[0], v.shape[-1]
        if st:
            C0, n0 = st
        else:
            C0 = torch.zeros((Bl, H, dh, dv), dtype=torch.float32,
                             device=x.device)
            n0 = torch.zeros((Bl, H, dh), dtype=torch.float32,
                             device=x.device)
        h, C_new, n_new = _mlstm_chunks(q, k, v, i_gate, f_gate, C0, n0, c,
                                        x.dtype)
        if not st:
            return h
        if dv < dh:            # n whole on each rank: return its block
            n_new = n_new.narrow(2, dctx.axis_index(hv) * dv, dv)
        return h, C_new, n_new

    if ctx is None:
        res = loop(q, k, v, i_gate, f_gate, *st)
    else:
        ins, outs = (whole, whole, cut, gate, gate), cut
        if st:
            ins, outs = ins + (cut, gate), (cut, cut, P(batch, None, hv))
        res = dctx.shard_map(loop, mesh=ctx.mesh, in_specs=ins,
                             out_specs=outs)(q, k, v, i_gate, f_gate, *st)
    h, new_state = (res, None) if state is None else (res[0], {
        "C": res[1], "n": res[2]})
    if ctx is not None:
        # whole over ``model`` on both sides of the head merge: DTensor
        # merges a cut head dim into a strided shard, whose indices a fake
        # tensor cannot give, and cannot view a gradient cut over more
        # ranks than divide the heads back into heads (``split_heads``)
        h = dctx.constrain_spec(h, whole)
    h = dctx.constrain(h.reshape(B, S, di), "act_btd")
    out = (h * silu(z)) @ p["out_proj"]
    return out, new_state


def init_mlstm_state(cfg: ModelConfig, batch: int, device) -> Dict:
    di = cfg.d_model * max(cfg.ssm_expand, 1)
    dh = di // cfg.n_heads
    return {"C": torch.zeros((batch, cfg.n_heads, dh, dh),
                             dtype=torch.float32, device=device),
            "n": torch.zeros((batch, cfg.n_heads, dh), dtype=torch.float32,
                             device=device)}


def init_slstm(gen, cfg: ModelConfig, dtype, device) -> Dict:
    d = cfg.d_model
    return {
        "w_in": _dense_init(gen, (d, 4 * d), d, dtype, device),
        "r_rec": _dense_init(gen, (d, 4 * d), d, dtype, device),
        "out_proj": _dense_init(gen, (d, d), d, dtype, device),
    }


def slstm(x, p, cfg: ModelConfig, state: Optional[Dict] = None):
    """sLSTM with exponential gating (sequential scan over time).

    Under a mesh context the time loop runs on each rank's shards
    (``shard_map``): the batch over the batch axes, the features and the
    recurrent matrix whole, so that no step needs a collective; a state
    given is gathered once, and the new one is returned cut over
    ``model`` as ``cache_shardings`` lays it."""
    B, S, D = x.shape
    pre = x @ p["w_in"]                                    # (B,S,4D)
    # used at every time step: replicated once here under a mesh
    r_rec = dctx.constrain(p["r_rec"].float(), "replicated2d")

    st = () if state is None else tuple(state[k] for k in "hcnm")
    ctx = dctx.current()
    cut = None                 # the axis the new state is returned cut over
    if ctx is not None:
        batch = _batch_axes(ctx, B)
        sizes = dctx.axis_sizes(ctx.mesh)
        if "model" in sizes and D % sizes["model"] == 0:
            cut = "model"

    def loop(pre, r_rec, *st):
        def step(carry, xs):
            h, c, n, m = carry
            g = xs[0].float() + h @ r_rec
            zi, ii, fi, oi = torch.split(g, D, dim=-1)
            z = torch.tanh(zi)
            o = torch.sigmoid(oi)
            log_f_m = F.logsigmoid(fi) + m
            m_new = torch.maximum(log_f_m, ii)
            i_e = torch.exp(ii - m_new)
            f_e = torch.exp(log_f_m - m_new)
            c = f_e * c + i_e * z
            n = f_e * n + i_e
            h = o * c / torch.clamp(n, min=1.0)
            return (h, c, n, m_new), h.to(x.dtype)

        if not st:
            h = torch.zeros((pre.shape[0], D), dtype=torch.float32,
                            device=x.device)
            st = (h, torch.zeros_like(h), torch.ones_like(h),
                  torch.zeros_like(h))
        st, hs = scan(step, st, (pre,))
        if state is None:
            return hs
        if cut is not None:
            n = D // dctx.axis_size(cut)
            st = tuple(t.narrow(1, dctx.axis_index(cut) * n, n) for t in st)
        return (hs,) + st

    if ctx is None:
        res = loop(pre, r_rec, *st)
    else:
        seq = P(batch, None, None)
        outs = seq if state is None else (seq,) + (P(batch, cut),) * 4
        res = dctx.shard_map(
            loop, mesh=ctx.mesh,
            in_specs=(seq, P(None, None)) + (P(batch, None),) * len(st),
            out_specs=outs)(pre, r_rec, *st)
    if state is None:
        return res @ p["out_proj"], None
    return res[0] @ p["out_proj"], dict(zip("hcnm", res[1:]))


def init_slstm_state(cfg: ModelConfig, batch: int, device) -> Dict:
    D = cfg.d_model
    z = torch.zeros((batch, D), dtype=torch.float32, device=device)
    return {"h": z, "c": z.clone(), "n": torch.ones_like(z),
            "m": z.clone()}


class Mamba(ParamTree):
    def forward(self, x, state=None):
        return mamba(x, self.tree(), self.cfg, state=state)


class MLSTM(ParamTree):
    def forward(self, x, state=None):
        return mlstm(x, self.tree(), self.cfg, state=state)


class SLSTM(ParamTree):
    def forward(self, x, state=None):
        return slstm(x, self.tree(), self.cfg, state=state)
