"""Unified model configuration covering the 10 assigned architectures
(a copy of ``repro.models.config``, field for field).

One config dataclass drives the whole stack (models/model.py); family
selects the block structure:

* ``dense``  — pre-norm transformer, GQA (+qk-norm), SiLU/GeGLU MLP
* ``moe``    — dense blocks with MoE FFN (+ optional parallel dense FFN —
  Arctic's dense residual / Llama-4's shared expert)
* ``hybrid`` — Hymba: parallel attention + Mamba heads per block,
  sliding-window attention
* ``vlm``    — dense backbone + stub patch-embedding prefix (Phi-3-vision)
* ``audio``  — Whisper: encoder (stub frame embeddings) + causal decoder
  with cross-attention
* ``ssm``    — xLSTM: groups of mLSTM blocks with an sLSTM block each
  (7:1), no attention
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | vlm | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    act: str = "silu"               # silu | geglu | gelu
    qk_norm: bool = False
    attn_bias: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False   # Arctic dense residual / L4 shared
    moe_dense_ff: int = 0              # d_ff of the parallel dense branch
    capacity_factor: float = 2.0
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    sliding_window: int = 0            # 0 = full attention
    # --- xLSTM ---
    xlstm_group: int = 0               # mLSTM blocks per sLSTM block
    # --- audio (whisper) ---
    enc_layers: int = 0
    enc_frames: int = 0                # stub frame-embedding count
    # --- vlm ---
    img_tokens: int = 0                # stub patch-embedding count
    # --- numerics ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    # long-context handling: chunk size for scanned attention at long S
    attn_chunk: int = 1024
    scan_layers: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_subquadratic(self) -> bool:
        """Can this architecture serve 500k-token contexts?  True for SSM
        state recurrences and sliding-window hybrids; False for pure full
        attention (DESIGN.md §4 skip notes)."""
        return self.family == "ssm" or (
            self.family == "hybrid" and self.sliding_window > 0)

    @property
    def has_decoder_cache(self) -> bool:
        return True                    # all assigned archs can decode

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, dff, L = self.d_model, self.d_ff, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = d * self.hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * self.hd * d
        n_mlp_mats = 3 if self.act in ("silu", "geglu") else 2
        mlp = n_mlp_mats * d * dff
        per_layer = 0
        if self.family in ("dense", "vlm"):
            per_layer = attn + mlp
        elif self.family == "moe":
            moe = n_mlp_mats * d * self.d_ff * self.n_experts
            dense = (3 * d * self.moe_dense_ff
                     if self.moe_dense_residual else 0)
            per_layer = attn + moe + dense
        elif self.family == "hybrid":
            ssm = (2 * d * self.d_inner + self.d_inner * d
                   + self.d_inner * (self.ssm_conv + 2 * self.ssm_state))
            per_layer = attn + ssm + mlp
        elif self.family == "audio":
            per_layer = 2 * attn + mlp          # self + cross attn
        elif self.family == "ssm":
            dh = d // self.n_heads
            mlstm = 4 * d * d + 2 * d            # qkv+out + gates
            per_layer = mlstm + mlp if dff else mlstm + 2 * d * 4 * d
        total = emb + L * per_layer
        if self.family == "audio":
            total += self.enc_layers * (attn + mlp)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.family != "moe" or self.n_experts == 0:
            return self.param_count()
        d, dff, L = self.d_model, self.d_ff, self.n_layers
        full = self.param_count()
        moe_all = L * 3 * d * dff * self.n_experts
        moe_active = L * 3 * d * dff * self.top_k
        return int(full - moe_all + moe_active)
