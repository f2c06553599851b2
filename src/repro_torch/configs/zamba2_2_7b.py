"""zamba2-2.7b [hybrid] — 54 Mamba-2 layers d_model=2560 ssm_state=64 with a
shared attention block (32H, kv=32, d_ff=10240) applied every 6 layers
[arXiv:2411.15242].  Per-invocation LoRA on the shared block is omitted
(see DESIGN.md §Arch-applicability)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", block="mamba2_hybrid",
    n_layers=54, d_model=2560, ssm_state=64, mamba2_headdim=64,
    expand=2, d_conv=4, hybrid_period=6,
    n_heads=32, n_kv_heads=32, head_dim=80, d_ff=10240,
    vocab=32000, act="gelu", norm="rmsnorm", rope_mode="full",
    dtype="bfloat16", fsdp=True, seq_shard_activations=True, remat=True, scan_layers=True,
    ssm_chunk=256,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=4, d_model=64, ssm_state=8, mamba2_headdim=32,
    hybrid_period=2, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab=256, dtype="float32", fsdp=False, remat=False, ssm_chunk=8,
)
