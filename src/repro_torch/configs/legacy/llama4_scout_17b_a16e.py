"""llama4-scout-17b-a16e [moe]: 48L d=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16e top-1 + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048, head_dim=128,
    act="silu", tie_embeddings=True,
    n_experts=16, top_k=1, moe_dense_residual=True, moe_dense_ff=8192,
)

SMOKE = dataclasses.replace(
    CONFIG, name="llama4-smoke", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, head_dim=32, d_ff=128, vocab=512, n_experts=4, top_k=1,
    moe_dense_ff=128, attn_chunk=64,
)
