"""State-space / recurrent blocks: Mamba (Hymba's parallel heads) and
xLSTM's mLSTM + sLSTM.

A port of ``repro.models.ssm``.  All recurrences are chunked as there:
within a chunk Mamba's recurrence runs as a log-depth inclusive scan
(``repro`` uses ``jax.lax.associative_scan``; the two differ only by
float32 rounding) and mLSTM's in matmul form; chunks chain through a
Python loop carrying O(state) memory.  sLSTM steps through time.  As in
``layers``, the port follows XLA's float32 where ``repro``'s results
depend on it: mLSTM's exp of the input gate stays float32 for its float32
product, and its gate cumsum sums in XLA's order (:func:`_prefix_sum`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import context as dctx
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (ParamTree, _dense_init, silu,
                                      softplus, split_heads, weak)

CHUNK = 256


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
    O(B*c*Di*N), never O(B*S*Di*N).
    """
    Bsz, S, Di = u.shape
    c = min(CHUNK, S)
    assert S % c == 0
    A = -torch.exp(a_log.float())                        # (Di, N)
    h = h0.float()
    ys = []
    for i in range(0, S, c):
        uc, dtc = u[:, i:i + c], dt[:, i:i + c]
        bc, cc = B_t[:, i:i + c], C_t[:, i:i + c]
        dec = torch.exp(dtc[..., None].float() * A)
        xin = (dtc * uc)[..., None].float() * bc[:, :, None, :].float()
        a_scan, b_scan = _inclusive_scan(dec, xin)
        hs = a_scan * h[:, None] + b_scan                # (B,c,Di,N)
        y = torch.einsum("bcdn,bcn->bcd", hs, cc.float())
        h = hs[:, -1]
        ys.append(y.to(u.dtype))
    y = torch.cat(ys, dim=1)
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


def mlstm(x, p, cfg: ModelConfig, state: Optional[Dict] = None):
    """Chunkwise mLSTM with matrix memory C (B,H,dh,dh) and normalizer n.

    Within a chunk the recurrence is evaluated in matmul form (decay-
    weighted attention-like products); chunks chain through the carried
    (C, n) state — the standard chunk-recurrent formulation.
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
    gates = u @ p["w_if"]                                  # (B,S,2H)
    i_gate = gates[..., :H]
    f_gate = dctx.elementwise(F.logsigmoid, gates[..., H:].float())

    c = min(CHUNK, S)
    assert S % c == 0
    if state is None:
        C_st = torch.zeros((B, H, dh, dh), dtype=torch.float32,
                           device=x.device)
        n_st = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
    else:
        C_st, n_st = state["C"], state["n"]
    mask = (torch.arange(c, device=x.device)[:, None]
            >= torch.arange(c, device=x.device)[None, :])[None, :, :, None]
    hs = []
    for i in range(0, S, c):
        qb, kb, vb = q[:, i:i + c], k[:, i:i + c], v[:, i:i + c]
        ib, fb = i_gate[:, i:i + c], f_gate[:, i:i + c]
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
        hs.append(h.to(x.dtype))
    h = torch.cat(hs, dim=1).reshape(B, S, di)
    out = (h * silu(z)) @ p["out_proj"]
    new_state = {"C": C_st, "n": n_st} if state is not None else None
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
    """sLSTM with exponential gating (sequential scan over time)."""
    B, S, D = x.shape
    pre = x @ p["w_in"]                                    # (B,S,4D)
    if state is None:
        h = torch.zeros((B, D), dtype=torch.float32, device=x.device)
        c = torch.zeros_like(h)
        n = torch.ones_like(h)
        m = torch.zeros_like(h)
    else:
        h, c, n, m = (state["h"], state["c"], state["n"], state["m"])
    # used at every time step: replicated once here under a mesh
    r_rec = dctx.constrain(p["r_rec"].float(), "replicated2d")
    hs = []
    for t in range(S):
        g = pre[:, t].float() + h @ r_rec
        zi, ii, fi, oi = torch.split(g, D, dim=-1)
        z = torch.tanh(zi)
        o = torch.sigmoid(oi)
        log_f = dctx.elementwise(F.logsigmoid, fi)
        m_new = torch.maximum(log_f + m, ii)
        i_e = torch.exp(ii - m_new)
        f_e = torch.exp(log_f + m - m_new)
        c = f_e * c + i_e * z
        n = f_e * n + i_e
        h = o * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h.to(x.dtype))
    out = torch.stack(hs, dim=1) @ p["out_proj"]
    new_state = ({"h": h, "c": c, "n": n, "m": m}
                 if state is not None else None)
    return out, new_state


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
