"""gemma-2b [dense]: 18L d=2048 8H (MQA kv=1) d_ff=16384 vocab=256000
— GeGLU, head_dim=256, MQA on 2b [arXiv:2403.08295; hf]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense", n_layers=18, d_model=2048,
    n_heads=8, n_kv_heads=1, d_ff=16384, vocab=256000, head_dim=256,
    act="geglu", tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="gemma-smoke", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=1, head_dim=32, d_ff=256, vocab=512, attn_chunk=64,
)
