"""chatglm3-6b [dense] — 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024, 2d (partial) RoPE [arXiv:2406.12793]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", block="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=13696, vocab=65024, act="swiglu", norm="rmsnorm",
    rope_mode="2d",
    dtype="bfloat16", scan_layers=True, remat=True,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, dtype="float32", remat=False,
)
