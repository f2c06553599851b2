"""Model substrate of the port: the assigned LM-family architectures built
from composable functional blocks (attention / MoE / Mamba / enc-dec), the
counterpart of ``repro/models``: inference, and the loss that training
differentiates, on one device or, as ``DTensor``s, over a device mesh
(``dist/``)."""
from .config import ModelConfig
from .model import (decode_step, forward, init_cache, init_params,
                    loss_fn, prefill)

__all__ = ["ModelConfig", "init_params", "forward", "loss_fn", "prefill",
           "decode_step", "init_cache"]
