"""falcon-mamba-7b [ssm] — 64L d_model=4096 attn-free, vocab=65024,
ssm_state=16, Mamba-1 architecture [arXiv:2410.05355], with Falcon-Mamba's
weightless RMS normalisation (eps 1e-6) of the scan's Delta input, B and C
after x_proj (HF transformers' ``FalconMambaMixer``), which the JAX
package's config lacks: ``mixer_rms_eps``, inherited by SMOKE_CONFIG."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", block="mamba1",
    n_layers=64, d_model=4096, vocab=65024,
    ssm_state=16, d_conv=4, expand=2, dt_rank=256,
    n_heads=1, n_kv_heads=1, d_ff=0,
    norm="rmsnorm", rope_mode="none", tie_embeddings=False,
    dtype="bfloat16", fsdp=True, seq_shard_activations=True, remat=True, scan_layers=True,
    ssm_chunk=256, mixer_rms_eps=1e-6,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, vocab=256, dt_rank=8, ssm_state=8,
    dtype="float32", fsdp=False, remat=False, ssm_chunk=8,
)
