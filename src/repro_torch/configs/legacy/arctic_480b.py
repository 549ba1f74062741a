"""arctic-480b [moe]: 35L d=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128e top-2 + dense residual [hf:Snowflake/snowflake-arctic-base; hf]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe", n_layers=35, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=4864, vocab=32000, head_dim=128,
    act="silu", tie_embeddings=True,
    n_experts=128, top_k=2, moe_dense_residual=True, moe_dense_ff=4864,
)

SMOKE = dataclasses.replace(
    CONFIG, name="arctic-smoke", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, head_dim=32, d_ff=128, vocab=512, n_experts=4, top_k=2,
    moe_dense_ff=128, attn_chunk=64,
)
