"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655; InternViT frontend is a stub (precomputed patch embeddings),
LM backbone is Qwen2-0.5B-like [arXiv:2404.16821]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", block="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864, vocab=151655, act="swiglu", norm="rmsnorm",
    rope_mode="full", rope_theta=1e6, tie_embeddings=True,
    frontend="vision_stub", n_vision_tokens=256,
    dtype="bfloat16", scan_layers=True, remat=True,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, n_vision_tokens=8, dtype="float32",
)
