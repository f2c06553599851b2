"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048/expert,
vocab=163840, 384 experts top-8; trillion-parameter MoE (paper-table config)
[arXiv:2501.kimi2].

Fits 512 x 16GB only with FSDP(ZeRO-3) over all devices + EP-16 + full remat
+ Adafactor (see DESIGN.md §5) — the launcher selects these automatically.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", block="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=2048, vocab=163840, act="swiglu", norm="rmsnorm",
    rope_mode="full",
    n_experts=384, top_k=8, capacity_factor=1.25,
    dtype="bfloat16", fsdp=True, seq_shard_activations=True, scan_layers=True, remat=True,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64, vocab=512, n_experts=8, top_k=2, dtype="float32",
    fsdp=False, remat=False,
)
