"""Assigned input shapes and their spec factories (no allocation): a copy of
``repro/configs/shapes.py`` whose ``ShapeDtypeStruct``s are tensors on the
``meta`` device (shape and dtype, no storage).

  train_4k     seq 4,096   global_batch 256   -> train_step
  prefill_32k  seq 32,768  global_batch 32    -> serve prefill
  decode_32k   seq 32,768  global_batch 128   -> serve_step (1 new token,
                                                KV cache of seq_len)
  long_500k    seq 524,288 global_batch 1     -> serve_step, SSM/hybrid only
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCfg("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCfg("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCfg("long_500k", "decode", 524288, 1),
}


def applicable(cfg: ModelConfig, shape: ShapeCfg) -> Tuple[bool, str]:
    """Whether this (arch x shape) cell runs (assignment skip rules)."""
    if shape.seq_len >= 2 ** 19 and not cfg.supports_long_context:
        return False, ("long_500k needs sub-quadratic attention; "
                       f"{cfg.name} is full-attention — skipped per "
                       "assignment (DESIGN.md §Arch-applicability)")
    return True, ""


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeCfg,
                smoke_scale: Optional[int] = None) -> Dict:
    """Meta tensors for the model-input batch of this shape."""
    b, s = shape.global_batch, shape.seq_len
    if smoke_scale:
        b, s = max(b // smoke_scale, 1), max(s // smoke_scale, 8)
    specs: Dict = {}
    if shape.kind == "train":
        specs["tokens"] = _sds((b, s), torch.int32)
        specs["labels"] = _sds((b, s), torch.int32)
    elif shape.kind == "prefill":
        specs["tokens"] = _sds((b, s), torch.int32)
    else:  # decode: one new token; the cache covers seq_len
        specs["tokens"] = _sds((b, 1), torch.int32)
    if cfg.frontend == "vision_stub" and shape.kind != "decode":
        specs["vision_embeds"] = _sds((b, cfg.n_vision_tokens, cfg.d_model),
                                      cfg.torch_dtype)
    if cfg.block == "encdec" and shape.kind != "decode":
        specs["audio_frames"] = _sds((b, cfg.n_audio_frames, cfg.d_model),
                                     cfg.torch_dtype)
    return specs


def cache_specs(cfg: ModelConfig, shape: ShapeCfg,
                smoke_scale: Optional[int] = None):
    """The decode/prefill cache built on the meta device (the reference's
    ``jax.eval_shape``); its fill counters are host tensors."""
    from ..models.model import init_cache
    b, s = shape.global_batch, shape.seq_len
    if smoke_scale:
        b, s = max(b // smoke_scale, 1), max(s // smoke_scale, 8)
    return init_cache(cfg, b, s, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str,
                smoke_scale: Optional[int] = None) -> Dict:
    """All model inputs as meta tensors (assignment §2)."""
    shape = SHAPES[shape_name]
    specs = {"batch": batch_specs(cfg, shape, smoke_scale)}
    if shape.kind in ("prefill", "decode"):
        specs["cache"] = cache_specs(cfg, shape, smoke_scale)
    return specs


# --------------------------------------------------------------------------
# MODEL_FLOPS for the roofline's "useful compute" numerator
# --------------------------------------------------------------------------

def model_flops_per_step(cfg: ModelConfig, shape: ShapeCfg) -> float:
    """6·N·D for training (fwd+bwd), 2·N·D forward-only; N = active params."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
