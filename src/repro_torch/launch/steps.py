"""Step factories: train_step / grad-accumulation train_step / prefill_step /
serve_step, the counterpart of ``repro/launch/steps.py`` on one device.

A train step takes the loss of the params and its gradients by autograd
(``torch.autograd.grad`` over the param leaves, which it marks as needing
grad; no ``.grad`` is left behind), then applies the optimizer, which
updates params and state in place.  The factories that shard a step over a
device mesh (``train_shardings``, ``jit_train_step``, ``serve_shardings``,
``jit_serve_step``, ``jit_prefill_step``) need the distribution layer,
which the port does not have yet.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from ..models import ModelConfig, decode_step, init_params, loss_fn, prefill
from ..optim import Optimizer, adafactor, adamw
from ..tree import leaves, unflatten


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: torch.Tensor   # () int32, on the params' device


def default_optimizer(cfg: ModelConfig) -> Optimizer:
    """Adafactor for trillion-class models (factored 2nd moment), else
    AdamW."""
    if cfg.param_count() > 100e9:
        return adafactor(1e-2)
    return adamw(3e-4)


def _grads(cfg: ModelConfig, params, batch: Dict
           ) -> Tuple[List[torch.Tensor], Dict]:
    """The param leaves' gradients of the total loss (in leaf order) and
    the loss's metrics, detached."""
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    with torch.enable_grad():
        total, metrics = loss_fn(cfg, params, batch)
        grads = torch.autograd.grad(total, flat)
    return list(grads), {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg: ModelConfig, opt: Optimizer):
    """(state, batch) -> (state, metrics)."""

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        grads, metrics = _grads(cfg, state.params, batch)
        new_params, new_opt = opt.update(unflatten(state.params, grads),
                                         state.opt, state.params, state.step)
        return (TrainState(params=new_params, opt=new_opt,
                           step=state.step + 1),
                {"loss": metrics["loss"], "aux_loss": metrics["aux_loss"],
                 "step": state.step})

    return train_step


def make_grad_accum_train_step(cfg: ModelConfig, opt: Optimizer,
                               n_micro: int):
    """Gradient-accumulation variant: the T axis (microbatch size) of the
    TOPS bridge.  Batch is split along dim 0 into n_micro slices; their
    gradients are summed in float32 and averaged."""

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves(state.params)]
        loss_sum = 0.0
        for i in range(n_micro):
            micro = {k: x[i * (x.shape[0] // n_micro):
                          (i + 1) * (x.shape[0] // n_micro)]
                     for k, x in batch.items()}
            grads, metrics = _grads(cfg, state.params, micro)
            for a, g in zip(acc, grads):
                a.add_(g)
            del grads
            loss_sum = loss_sum + metrics["loss"]
        for a in acc:
            a.div_(n_micro)
        new_params, new_opt = opt.update(unflatten(state.params, acc),
                                         state.opt, state.params, state.step)
        return (TrainState(params=new_params, opt=new_opt,
                           step=state.step + 1),
                {"loss": loss_sum / n_micro, "step": state.step})

    return train_step


def state_specs(cfg: ModelConfig, opt: Optimizer) -> TrainState:
    """The abstract TrainState: ``meta`` tensors of its shapes and dtypes
    (no allocation)."""
    p_spec = init_params(cfg, None, "meta")
    return TrainState(params=p_spec, opt=opt.init(p_spec),
                      step=torch.empty((), dtype=torch.int32,
                                       device="meta"))


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch, cache):
        return prefill(cfg, params, batch, cache)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One decode step: (params, tokens (B,1), cache) -> (logits, cache)."""
    def serve_step(params, tokens, cache):
        return decode_step(cfg, params, tokens, cache)
    return serve_step
