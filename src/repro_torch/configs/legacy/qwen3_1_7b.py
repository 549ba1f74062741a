"""qwen3-1.7b [dense]: 28L d=2048 16H (GQA kv=8) d_ff=6144 vocab=151936
— qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense", n_layers=28, d_model=2048,
    n_heads=16, n_kv_heads=8, d_ff=6144, vocab=151936, head_dim=128,
    act="silu", qk_norm=True, tie_embeddings=True, rope_theta=1_000_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen3-1.7b-smoke", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, head_dim=32, d_ff=256, vocab=512, attn_chunk=64,
)
