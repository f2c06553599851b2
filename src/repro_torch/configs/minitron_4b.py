"""minitron-4b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000, pruned Nemotron (squared-ReLU MLP) [arXiv:2407.14679]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", block="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=9216, vocab=256000, act="relu2", norm="layernorm",
    rope_mode="full",
    dtype="bfloat16", scan_layers=True, remat=True,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, dtype="float32", remat=False,
)
