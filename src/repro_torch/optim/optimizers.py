"""Optimizers (AdamW / Adafactor / SGD), gradient clipping by global norm and
a warmup-cosine schedule, the counterpart of ``repro/optim/optimizers.py``.

The contract is the reference's: ``update(grads, state, params, step) ->
(new_params, new_state)``, with states that mirror the params tree leaf
for leaf (Adafactor's factored leaves keep a row and a column second
moment).  The update runs under ``torch.no_grad()`` one leaf at a time and
writes into the params' and the states' storage, so the returned trees
are the ones passed in: at any moment only one leaf's float32 temporaries
exist beside them, never a second ``m`` or ``v`` tree.  The arithmetic is
the reference's, in float32 and in its order: the clip scale folded into
each leaf's update, ``t = step + 1`` and the bias corrections in float32,
the weight decay added to the update before the learning rate.

Over a device mesh the params, grads and states are ``DTensor``s.  The
clip norm is then a global reduction; AdamW's and SGD's leaf updates are
elementwise, so they run on each rank's local shards (every leaf's grad
and states first take the param's placements), entry for entry the
one-device arithmetic.  Adafactor's row, column and RMS means reduce over
whole leaves, so it runs on the ``DTensor``s themselves.  ``opt_shardings``
gives the states' shardings (``dist.sharding.param_shardings`` the
params').
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Tuple

import torch

from ..dist.api import NamedSharding, P, is_dtensor
from ..tree import leaves, map_leaves, named_leaves, unflatten


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, torch.Tensor], Tuple[Any, Any]]
    # update(grads, state, params, step) -> (new_params, new_state)
    name: str = "opt"


def schedule_cosine(base_lr: float, warmup: int = 100,
                    total: int = 10_000, min_frac: float = 0.1
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi
                                                               * prog))
        return base_lr * warm * cos
    return lr


def _constant(base: float) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda step: torch.full((), base, dtype=torch.float32,
                                   device=step.device)


def _global_norm(flat_grads: List[torch.Tensor]) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(g.float())) for g in flat_grads)
    return torch.sqrt(sq)


def _clip_scale(flat_grads: List[torch.Tensor], max_norm: float
                ) -> torch.Tensor:
    """The factor ``min(1, max_norm / norm)`` that callers fold into each
    leaf's update, so no clipped float32 gradient tree is ever made."""
    norm = _global_norm(flat_grads)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def _value(x):
    """A scalar's value on this rank: a ``DTensor``'s full value."""
    return x.full_tensor() if is_dtensor(x) else x


def _laid_out_as(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` with ``like``'s placements (``x`` itself off a mesh)."""
    if is_dtensor(like) and tuple(x.placements) != tuple(like.placements):
        return x.redistribute(like.device_mesh, like.placements)
    return x


def _local(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's shard of ``x`` laid out as ``like`` (``x`` itself off a
    mesh), so that elementwise arithmetic on shards is the arithmetic on
    the whole leaves."""
    x = _laid_out_as(x, like)
    return x.to_local() if is_dtensor(x) else x


def _apply(p: torch.Tensor, u: torch.Tensor) -> None:
    """``p <- float32(p) - u`` in ``p``'s dtype; ``u`` is a float32
    temporary of the leaf, overwritten here."""
    if p.dtype == torch.float32:
        p.sub_(u)
    else:
        p.copy_(torch.sub(p.float(), u, out=u))


def sgd(lr: float = 1e-2, clip: float = 1.0) -> Optimizer:
    def init(params):
        return {}

    @torch.no_grad()
    def update(grads, state, params, step):
        flat_p, flat_g = leaves(params), leaves(grads)
        scale = _value(_clip_scale(flat_g, clip))
        for p, g in zip(flat_p, flat_g):
            g = _local(g, p)
            _apply(_local(p, p),
                   g.to(torch.float32, copy=True).mul_(lr).mul_(scale))
        return params, state

    return Optimizer(init=init, update=update, name="sgd")


def adamw(lr_fn: Callable | float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          clip: float = 1.0) -> Optimizer:
    if not callable(lr_fn):
        lr_fn = _constant(lr_fn)

    def init(params):
        def zeros(p):   # a DTensor's state is laid out as the DTensor
            return torch.zeros_like(p, dtype=torch.float32)
        return {"m": map_leaves(zeros, params), "v": map_leaves(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        flat_p, flat_g = leaves(params), leaves(grads)
        scale = _value(_clip_scale(flat_g, clip))
        step = _value(step)
        t = step.float() + 1.0
        lr = lr_fn(step)
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        for p, g, m, v in zip(flat_p, flat_g, leaves(state["m"]),
                              leaves(state["v"])):
            p, g, m, v = [_local(x, p) for x in (p, g, m, v)]
            g32 = g.to(torch.float32, copy=True)
            tmp = torch.mul(g32, 1 - b1).mul_(scale)
            m.mul_(b1).add_(tmp)                  # b1*m + (1-b1)*g*scale
            torch.mul(g32, scale, out=tmp).square_().mul_(1 - b2)
            v.mul_(b2).add_(tmp)                  # b2*v + (1-b2)*(g*scale)^2
            u = torch.div(m, bc1, out=g32)
            u.div_(torch.div(v, bc2, out=tmp).sqrt_().add_(eps))
            u = torch.mul(p.float(), weight_decay, out=tmp).add_(u)
            _apply(p, u.mul_(lr))
        return params, state

    return Optimizer(init=init, update=update, name="adamw")


def adafactor(lr_fn: Callable | float = 1e-2, decay: float = 0.8,
              eps: float = 1e-30, clip: float = 1.0,
              min_dim_factored: int = 128) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern 2018, simplified)."""
    if not callable(lr_fn):
        lr_fn = _constant(lr_fn)

    def factored(p) -> bool:
        return (p.dim() >= 2 and p.shape[-1] >= min_dim_factored
                and p.shape[-2] >= min_dim_factored)

    def init(params):
        def leaf(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          **f32)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}
        return map_leaves(leaf, params)

    @torch.no_grad()
    def update(grads, state, params, step):
        flat_p, flat_g = leaves(params), leaves(grads)
        scale = _clip_scale(flat_g, clip)
        t = step.float() + 1.0
        beta = 1.0 - t ** (-decay)
        lr = lr_fn(step)
        for p, g, s in zip(flat_p, flat_g, _per_param(params, state)):
            g = _laid_out_as(g, p).to(torch.float32, copy=True).mul_(scale)
            g2 = torch.mul(g, g).add_(eps)
            if factored(p):
                vr, vc = s["vr"], s["vc"]
                vr.mul_(beta).add_((1 - beta) * g2.mean(dim=-1))
                vc.mul_(beta).add_((1 - beta) * g2.mean(dim=-2))
                rmean = torch.clamp(vr.mean(dim=-1), min=eps)
                denom = torch.mul(vr[..., :, None], vc[..., None, :],
                                  out=g2).div_(rmean[..., None, None])
            else:
                v = s["v"]
                v.mul_(beta).add_(g2.mul_(1 - beta))
                denom = g2.copy_(v)
            u = g.div_(denom.add_(eps).sqrt_())
            del g2, denom
            # update clipping (RMS <= 1)
            rms = torch.sqrt(torch.mean(u * u) + eps)
            _apply(p, u.div_(torch.clamp(rms, min=1.0)).mul_(lr))
        return params, state

    return Optimizer(init=init, update=update, name="adafactor")


def _per_param(params, state) -> List[Any]:
    """``state`` cut at ``params``' leaves: one subtree a param, in the
    params' leaf order (the reference's ``flatten_up_to``)."""
    if isinstance(params, dict):
        return [sub for k in sorted(params)
                for sub in _per_param(params[k], state[k])]
    if isinstance(params, (list, tuple)):
        return [sub for p, s in zip(params, state)
                for sub in _per_param(p, s)]
    return [state]


def opt_shardings(opt: Optimizer, param_shardings: Any, params_spec: Any,
                  mesh) -> Any:
    """Shardings for the optimizer state: AdamW's ``m`` and ``v`` mirror the
    params'; SGD has no state; a factored Adafactor leaf drops the reduced
    axis from its param's spec (``vr`` the last, ``vc`` the one before),
    matched by shape in that order as the reference matches them."""
    if opt.name == "adamw":
        return {"m": param_shardings, "v": param_shardings}
    if opt.name == "sgd":
        return opt.init(params_spec)  # stateless: {}

    state_spec = opt.init(params_spec)
    flat_ps, flat_pv = leaves(param_shardings), leaves(params_spec)

    def leaf_sharding(psh: NamedSharding, pval, subtree):
        pshape, nd = tuple(pval.shape), pval.dim()

        def match(s) -> NamedSharding:
            shape = tuple(s.shape)
            if shape == pshape:
                return psh
            spec = list(psh.spec) + [None] * (nd - len(psh.spec))
            if len(shape) == nd - 1 and shape == pshape[:-1]:
                return NamedSharding(mesh, P(*spec[:-1]))             # vr
            if len(shape) == nd - 1 \
                    and shape == pshape[:-2] + pshape[-1:]:
                return NamedSharding(mesh, P(*(spec[:-2] + spec[-1:])))  # vc
            return NamedSharding(mesh, P())
        return unflatten(subtree, [match(s) for _, s in
                                   named_leaves(subtree)])

    per_param = _per_param(params_spec, state_spec)
    return _rebuild(params_spec, state_spec,
                    [leaf_sharding(psh, pv, ss) for psh, pv, ss
                     in zip(flat_ps, flat_pv, per_param)])


def _rebuild(params, state, subtrees: List[Any]):
    """``state`` with its per-param subtrees (``_per_param``'s cut)
    replaced, in order, by ``subtrees``."""
    it = iter(subtrees)

    def build(p, s):
        if isinstance(p, dict):
            return {k: build(p[k], s[k]) for k in sorted(p)}
        if isinstance(p, (list, tuple)):
            rebuilt = [build(pi, si) for pi, si in zip(p, s)]
            return type(s)(*rebuilt) if hasattr(s, "_fields") \
                else type(s)(rebuilt)
        return next(it)

    return build(params, state)
