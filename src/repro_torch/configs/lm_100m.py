"""lm-100m — a ~110M-parameter dense LM for the end-to-end training example
(examples/train_end_to_end.py).  Not part of the assigned 10; included so the
example exercises the full substrate at a size a CPU can train."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="lm-100m", block="dense",
    n_layers=16, d_model=640, n_heads=10, n_kv_heads=5, head_dim=64,
    d_ff=2560, vocab=8192, act="swiglu", norm="rmsnorm", rope_mode="full",
    dtype="float32", scan_layers=True,
)

SMOKE_CONFIG = CONFIG.replace(n_layers=2, d_model=64, n_heads=4,
                              n_kv_heads=2, head_dim=16, d_ff=128, vocab=512)
