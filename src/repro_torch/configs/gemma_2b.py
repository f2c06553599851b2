"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=256000, GeGLU, head_dim=256 [arXiv:2403.08295]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", block="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=256000, act="geglu", norm="rmsnorm",
    rope_mode="full", tie_embeddings=True,
    dtype="bfloat16", scan_layers=True, remat=True,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=32,
    d_ff=128, vocab=512, dtype="float32", remat=False,
)
