"""xlstm-1.3b [ssm]: 48L d=2048 4H vocab=50304 — mLSTM blocks with one
sLSTM block per group of 8 (xLSTM[7:1]) [arXiv:2405.04517; unverified]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm", n_layers=48, d_model=2048,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304,
    tie_embeddings=True, xlstm_group=8, ssm_expand=1,
)

SMOKE = dataclasses.replace(
    CONFIG, name="xlstm-smoke", n_layers=4, d_model=128, n_heads=2,
    n_kv_heads=2, vocab=512, xlstm_group=2, attn_chunk=64,
)
