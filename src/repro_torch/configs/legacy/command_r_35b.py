"""command-r-35b [dense]: 40L d=8192 64H (GQA kv=8) d_ff=22528 vocab=256000
— GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01; unverified]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense", n_layers=40, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=22528, vocab=256000, head_dim=128,
    act="silu", attn_bias=False, tie_embeddings=True, rope_theta=8_000_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="command-r-smoke", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, head_dim=32, d_ff=256, vocab=512, attn_chunk=64,
)
