"""whisper-tiny [audio]: 4L d=384 6H (kv=6) d_ff=1536 vocab=51865 —
enc-dec, conv frontend STUB (input_specs provides precomputed frame
embeddings) [arXiv:2212.04356; unverified]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio", n_layers=4, d_model=384,
    n_heads=6, n_kv_heads=6, d_ff=1536, vocab=51865, head_dim=64,
    act="gelu", tie_embeddings=True, enc_layers=4, enc_frames=1500,
)

SMOKE = dataclasses.replace(
    CONFIG, name="whisper-smoke", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=4, head_dim=32, d_ff=256, vocab=512, enc_layers=2,
    enc_frames=16, attn_chunk=64,
)
