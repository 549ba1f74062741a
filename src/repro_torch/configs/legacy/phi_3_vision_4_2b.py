"""phi-3-vision-4.2b [vlm]: 32L d=3072 32H (kv=32) d_ff=8192 vocab=32064
— phi3-mini backbone + CLIP tower stub (precomputed patch embeddings)
[hf:microsoft/Phi-3-vision-128k-instruct; hf]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm", n_layers=32, d_model=3072,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32064, head_dim=96,
    act="silu", tie_embeddings=True, img_tokens=576,
)

SMOKE = dataclasses.replace(
    CONFIG, name="phi3v-smoke", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=4, head_dim=32, d_ff=256, vocab=512, img_tokens=8,
    attn_chunk=64,
)
