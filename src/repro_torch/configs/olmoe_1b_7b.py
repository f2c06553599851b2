"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (kv=16) d_ff=1024/expert,
vocab=50304, 64 experts top-8 [arXiv:2409.02060]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", block="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab=50304, act="swiglu", norm="rmsnorm",
    rope_mode="full",
    n_experts=64, top_k=8, capacity_factor=1.25,
    dtype="bfloat16", scan_layers=True, remat=True,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=64, vocab=512, n_experts=8, top_k=2, dtype="float32",
    remat=False, capacity_factor=4.0,  # no-drop at smoke scale: decode
    # routing then matches teacher-forcing routing exactly
)
