"""stablelm-3b [dense] — 32L d_model=2560 32H (kv=32) d_ff=6912
vocab=50304, partial rotary (25%), LayerNorm
[hf:stabilityai/stablelm-2-1_6b lineage]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", block="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=6912, vocab=50304, act="swiglu", norm="layernorm",
    rope_mode="partial", rope_fraction=0.25,
    dtype="bfloat16", scan_layers=True, remat=True,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512, dtype="float32", remat=False,
)
