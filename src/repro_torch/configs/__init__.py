"""Architecture registry: one module per assigned architecture.

Each module exports CONFIG (the exact published configuration) and
SMOKE_CONFIG (a reduced same-family config for CPU tests).
"""
from . import (chatglm3_6b, falcon_mamba_7b, gemma_2b, internvl2_1b,
               kimi_k2_1t_a32b, lm_100m, minitron_4b, olmoe_1b_7b,
               stablelm_3b, whisper_base, zamba2_2_7b)
from .shapes import (SHAPES, ShapeCfg, applicable, input_specs,
                     model_flops_per_step)

ARCHS = {
    "falcon-mamba-7b": falcon_mamba_7b,
    "internvl2-1b": internvl2_1b,
    "zamba2-2.7b": zamba2_2_7b,
    "chatglm3-6b": chatglm3_6b,
    "gemma-2b": gemma_2b,
    "minitron-4b": minitron_4b,
    "stablelm-3b": stablelm_3b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b,
    "whisper-base": whisper_base,
    # extra (not an assigned arch): end-to-end example model
    "lm-100m": lm_100m,
}

# the 10 assigned architectures (dry-run / roofline scope)
ASSIGNED = [a for a in ARCHS if a != "lm-100m"]


def get_config(arch: str, smoke: bool = False):
    mod = ARCHS[arch.replace("_", "-")]
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


__all__ = ["ARCHS", "get_config", "SHAPES", "ShapeCfg", "applicable",
           "input_specs", "model_flops_per_step"]
