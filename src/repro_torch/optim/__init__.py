"""Optimizers of the port: AdamW, Adafactor and SGD with global-norm
clipping and a warmup-cosine schedule, updating params in place."""
from .optimizers import (Optimizer, adafactor, adamw, opt_shardings,
                         schedule_cosine, sgd)

__all__ = ["Optimizer", "adamw", "adafactor", "sgd", "schedule_cosine",
           "opt_shardings"]
