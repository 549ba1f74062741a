"""Analytic FLOP / HBM-byte model per (architecture x shape) cell (a port
of ``repro.launch.costmodel``: the same float operations in the same
order, so every number equals ``repro``'s).

Why analytic: a compiler's cost analysis counts while-loop bodies once,
so under scan-over-layers and chunked attention it understates true work
by ~n_layers x chunk factors.  Collective bytes come from the caller;
compute and memory terms come from the formulas below.

Conventions:
* MODEL_FLOPS = 6 * N_active * tokens (the reporting convention).
* total train flops = (6 + 2*remat) * N_matmul * tokens + attention
  (4*B*S^2*H*hd per fwd pass, x(3 + remat) for train).
* decode flops per step = 2 * N_matmul * B + attention reads of the
  cache (4 * B * S_kv * H * hd).
"""

from __future__ import annotations

import dataclasses

from repro_torch.launch.specs import SHAPE_SPECS
from repro_torch.models.config import ModelConfig

#: ``repro``'s model of one TPU v5e chip, copied for parity: the peaks its
#: roofline divides by.  Not the H100's, and not measured here.
TPU_V5E = {
    "peak_flops": 197e12,        # bf16 / chip
    "hbm_gbps": 819e9,           # bytes/s / chip
    "ici_gbps": 50e9,            # bytes/s / link (intra-pod)
    "dci_gbps": 9e9,             # bytes/s / link (inter-pod, pod axis)
    "hbm_bytes": 16 * 2**30,
}


def matmul_params(cfg: ModelConfig, active: bool = True) -> int:
    """Parameters participating in matmuls per token (excl. embedding
    gather; incl. the LM head once)."""
    n = cfg.active_param_count() if active else cfg.param_count()
    # embedding gather is not a matmul; tied head counts once (it is in
    # param_count once already)
    return int(n)


def attention_flops_fwd(cfg: ModelConfig, B: int, S: int,
                        S_kv: int | None = None) -> float:
    if cfg.family == "ssm":
        # mLSTM chunk-recurrent work ~ 4*B*S*c*di + state updates
        c = 256
        di = cfg.d_model * max(cfg.ssm_expand, 1)
        return 4.0 * B * S * c * di + 4.0 * B * S * di * (di // cfg.n_heads)
    S_kv = S if S_kv is None else S_kv
    win = cfg.sliding_window
    eff_kv = min(S_kv, win) if win else S_kv
    f = 4.0 * B * S * eff_kv * cfg.n_heads * cfg.hd
    if cfg.family == "hybrid":
        di = cfg.d_inner
        f += 6.0 * B * S * di * cfg.ssm_state      # selective scan
    if cfg.family == "audio":
        f += 4.0 * B * S * cfg.enc_frames * cfg.n_heads * cfg.hd  # cross
        f += 4.0 * B * cfg.enc_frames ** 2 * cfg.n_heads * cfg.hd \
            * (cfg.enc_layers / max(cfg.n_layers, 1))
    return f * cfg.n_layers


@dataclasses.dataclass
class CellCost:
    model_flops: float          # 6 * N_active * tokens
    total_flops: float          # incl. attention + remat recompute
    hbm_bytes_per_chip: float
    tokens: int

    @property
    def useful_fraction(self) -> float:
        return self.model_flops / max(self.total_flops, 1.0)


def cell_cost(cfg: ModelConfig, shape: str, chips: int) -> CellCost:
    ss = SHAPE_SPECS[shape]
    B, S = ss.global_batch, ss.seq_len
    N = matmul_params(cfg)
    P_total_bytes = cfg.param_count() * 4          # fp32 master params

    if ss.kind == "train":
        T = B * S
        model = 6.0 * N * T
        remat_extra = 2.0 * N * T if cfg.remat else 0.0
        attn = attention_flops_fwd(cfg, B, S) * (4 if cfg.remat else 3)
        total = model + remat_extra + attn
        # HBM: params+opt r/w (sharded) + layer-boundary activations
        # (bf16, written fwd / read bwd / re-read for remat)
        act = (3.0 * cfg.n_layers * B * S * cfg.d_model * 2) / chips
        opt_traffic = 4.0 * P_total_bytes / chips
        logits = 3.0 * B * S * cfg.vocab * 2 / chips
        hbm = opt_traffic + act + logits
        return CellCost(model, total, hbm, T)

    if ss.kind == "prefill":
        T = B * S
        model = 2.0 * N * T
        total = model + attention_flops_fwd(cfg, B, S)
        act = (2.0 * cfg.n_layers * B * S * cfg.d_model * 2) / chips
        hbm = P_total_bytes / 2 / chips + act      # bf16 weight reads
        return CellCost(6.0 * N * T, total, hbm, T)

    # decode: one token against an S_kv cache
    T = B
    model = 2.0 * N * T
    total = model + attention_flops_fwd(cfg, B, 1, S_kv=S)
    win = cfg.sliding_window
    eff_kv = min(S, win) if win else S
    if cfg.family == "ssm":
        di = cfg.d_model * max(cfg.ssm_expand, 1)
        dh = di // cfg.n_heads
        cache_bytes = cfg.n_layers * B * cfg.n_heads * dh * dh * 4
    else:
        cache_bytes = (2.0 * cfg.n_layers * B * cfg.n_kv_heads * cfg.hd
                       * eff_kv * 2)
    hbm = (P_total_bytes / 2 + cache_bytes) / chips
    return CellCost(6.0 * N * T, total, hbm, T)
