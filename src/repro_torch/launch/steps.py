"""Step factories: train_step / grad-accumulation train_step / prefill_step /
serve_step, on one device and sharded over a device mesh; the counterpart
of ``repro/launch/steps.py``.

A train step takes the loss of the params and its gradients by autograd
(``torch.autograd.grad`` over the param leaves, which it marks as needing
grad; no ``.grad`` is left behind), then applies the optimizer, which
updates params and state in place.

The ``jit_*`` builders keep the reference's names, but nothing is
compiled: each builds an *eager sharded step* over a ``DeviceMesh``.  The
step distributes its state, batch and cache onto the shardings of
``train_shardings`` / ``serve_shardings`` as ``DTensor``s (plain tensors,
the same whole value on every rank, are cut into shards; ``DTensor``s are
redistributed only where their placements differ), then runs the
one-device step under ``axis_rules(mesh, rules)``, where the model's
``constrain`` calls redistribute activations, and under
``implicit_replication()``, where the plain tensors a step makes (rope
angles, positions, masks) count as replicated.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from ..dist.api import NamedSharding, P, axis_rules, is_dtensor
from ..dist.sharding import (batch_spec, cache_shardings, distribute_tree,
                             make_rules, param_shardings)
from ..models import (ModelConfig, decode_step, init_cache, init_params,
                      loss_fn, prefill)
from ..optim import Optimizer, adafactor, adamw, opt_shardings
from ..runtime import trace
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
    with torch.enable_grad(), trace.span("train.grads"):
        total, metrics = loss_fn(cfg, params, batch)
        grads = torch.autograd.grad(total, flat)
    return list(grads), {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg: ModelConfig, opt: Optimizer):
    """(state, batch) -> (state, metrics)."""

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        with trace.span("train.step", device=True):
            grads, metrics = _grads(cfg, state.params, batch)
            with trace.span("optim.update"):
                new_params, new_opt = opt.update(
                    unflatten(state.params, grads), state.opt, state.params,
                    state.step)
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
        acc = [torch.zeros_like(p, dtype=torch.float32)
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


def _rules(cfg: ModelConfig, mesh, rules=None):
    return rules or make_rules(mesh, fsdp=cfg.fsdp,
                               seq_activations=cfg.seq_shard_activations)


def _sharded(mesh, rules, fn):
    """``fn`` run under the mesh's rules, with the plain tensors it makes
    counted as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    def wrapped(*args):
        with axis_rules(mesh, rules), implicit_replication():
            return fn(*args)

    return wrapped


def _whole(metrics: Dict) -> Dict:
    """Replicated metrics as plain tensors on this rank."""
    return {k: v.full_tensor() if is_dtensor(v) else v
            for k, v in metrics.items()}


def train_shardings(cfg: ModelConfig, opt: Optimizer, mesh, rules=None
                    ) -> Tuple[TrainState, Any]:
    """The TrainState's shardings (params, optimizer state, step) and the
    batch's ``batch_spec``."""
    rules = _rules(cfg, mesh, rules)
    specs = state_specs(cfg, opt)
    ps = param_shardings(cfg, specs.params, mesh, rules)
    os_ = opt_shardings(opt, ps, specs.params, mesh)
    state_sh = TrainState(params=ps, opt=os_, step=NamedSharding(mesh, P()))
    return state_sh, batch_spec(mesh, rules)


def jit_train_step(cfg: ModelConfig, opt: Optimizer, mesh, batch_specs: Dict,
                   rules=None, n_micro: int = 1):
    """An eager sharded train step over ``mesh`` (nothing is compiled; the
    name is the reference's).  Returns ``(fn, state_sh, bsh_tree)``:
    ``fn(state, batch) -> (state, metrics)`` distributes state and batch
    onto ``state_sh`` / ``bsh_tree`` and returns the state as ``DTensor``s
    and the metrics as plain tensors, the same on every rank."""
    rules = _rules(cfg, mesh, rules)
    state_sh, bshard = train_shardings(cfg, opt, mesh, rules)
    bsh_tree = {k: bshard(v) for k, v in batch_specs.items()}
    base = _sharded(mesh, rules,
                    make_train_step(cfg, opt) if n_micro <= 1
                    else make_grad_accum_train_step(cfg, opt, n_micro))

    def fn(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        state = distribute_tree(state, state_sh)
        batch = distribute_tree(batch, bsh_tree)
        new_state, metrics = base(state, batch)
        return new_state, _whole(metrics)

    return fn, state_sh, bsh_tree


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


# a KV cache's fill counters and the cross-attention flag stay host tensors
_HOST_LEAVES = ("pos", "ready")


def serve_shardings(cfg: ModelConfig, mesh, batch: int, max_len: int,
                    rules=None, long_context: bool = False):
    """(param shardings, cache shardings, batch_spec, rules) for serving:
    no FSDP, the cache's sequence over 'model' when ``long_context``."""
    rules = rules or make_rules(mesh, fsdp=False, long_context=long_context)
    p_spec = init_params(cfg, None, "meta")
    ps = param_shardings(cfg, p_spec, mesh, rules)
    c_spec = init_cache(cfg, batch, max_len, "meta")
    cs = cache_shardings(cfg, c_spec, mesh, rules)
    return ps, cs, batch_spec(mesh, rules), rules


def _eager_serve(cfg: ModelConfig, mesh, batch: int, max_len: int,
                 long_context: bool, step, inputs_sh):
    """``(fn, ps, cs)`` of an eager sharded ``step(params, inputs, cache)
    -> (logits, cache)``; ``inputs_sh`` maps the batch's sharding factory
    to the inputs' shardings."""
    ps, cs, bshard, rules = serve_shardings(cfg, mesh, batch, max_len,
                                            long_context=long_context)
    base = _sharded(mesh, rules, step)
    in_sh = inputs_sh(bshard)
    out_sh = bshard(torch.empty((batch, cfg.vocab_padded), device="meta"))

    def fn(params, inputs, cache):
        logits, cache = base(distribute_tree(params, ps),
                             distribute_tree(inputs, in_sh),
                             distribute_tree(cache, cs, keep=_HOST_LEAVES))
        return (distribute_tree(logits, out_sh),
                distribute_tree(cache, cs, keep=_HOST_LEAVES))

    return fn, ps, cs


def jit_serve_step(cfg: ModelConfig, mesh, batch: int, max_len: int,
                   long_context: bool = False):
    """An eager sharded decode step (the reference's name; nothing is
    compiled).  Returns ``(fn, ps, cs)``: ``fn(params, tokens, cache) ->
    (logits, cache)`` with the logits a ``DTensor`` sharded over the batch
    axes and the cache's tensors ``DTensor``s on ``cs``."""
    return _eager_serve(
        cfg, mesh, batch, max_len, long_context, make_serve_step(cfg),
        lambda bshard: bshard(torch.empty((batch, 1), device="meta")))


def jit_prefill_step(cfg: ModelConfig, mesh, batch_specs: Dict, batch: int,
                     max_len: int, long_context: bool = False):
    """An eager sharded prefill (the reference's name; nothing is
    compiled).  Returns ``(fn, ps, cs)``: ``fn(params, batch, cache) ->
    (last-token logits, cache)``, laid out as ``jit_serve_step``'s."""
    return _eager_serve(
        cfg, mesh, batch, max_len, long_context, make_prefill_step(cfg),
        lambda bshard: {k: bshard(v) for k, v in batch_specs.items()})
