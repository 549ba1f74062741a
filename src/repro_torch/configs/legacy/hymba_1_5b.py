"""hymba-1.5b [hybrid]: 32L d=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16 — parallel attn + mamba heads, sliding-window attention
[arXiv:2411.13676; hf]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, d_ff=5504, vocab=32001, head_dim=64,
    act="silu", tie_embeddings=True,
    ssm_state=16, ssm_conv=4, ssm_expand=2, sliding_window=1024,
)

SMOKE = dataclasses.replace(
    CONFIG, name="hymba-smoke", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, head_dim=32, d_ff=256, vocab=512, ssm_state=8,
    sliding_window=32, attn_chunk=64,
)
