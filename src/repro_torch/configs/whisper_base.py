"""whisper-base [audio] — 6L enc + 6L dec, d_model=512 8H d_ff=2048
vocab=51865, enc-dec; conv/mel frontend is a stub (input_specs supplies
precomputed 1500-frame embeddings) [arXiv:2212.04356]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", block="encdec",
    n_layers=6, enc_layers=6, dec_layers=6,
    d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048, vocab=51865, act="gelu", norm="layernorm",
    rope_mode="none", n_audio_frames=1500,
    dtype="bfloat16", scan_layers=True, remat=True,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, enc_layers=2, dec_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=128, vocab=512, n_audio_frames=16,
    dtype="float32",
)
