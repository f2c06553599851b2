"""Mixture-of-Experts FFN with top-k routing and capacity-bounded scatter
dispatch, expert-parallel over the 'model' mesh axis; the counterpart of
``repro/models/moe.py``.

Nothing larger than (T, D) or (E, cap, D) is materialized: the k routing
slots are processed as k separate (T, D) scatters and gathers, assignment
ranks come from one stable argsort over (T·k,) expert ids, and the
load-balance loss counts each expert's assignments with one scatter-add
into (E,) (a count of static shape, which fake tensors can trace).

``moe_block`` dispatches as the reference does: under a mesh whose
'model' axis divides the experts and the sequence, with enough tokens,
it takes the expert-parallel all-to-all (``_moe_block_a2a``), which
computes on each rank's local shards with explicit collectives (the
reference's ``shard_map``); otherwise the scatter path
(``_moe_block_jit``).  On ``DTensor``s the scatter path
(``_moe_block_mesh``) routes the whole tokens on every rank, since
routing (the counts, ``argsort``) has no sharding rule, and runs each
rank's own experts on its shard of the weights.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..dist.api import (constrain, current_rules, is_dtensor,
                        logical_to_spec, mesh_sizes, spec_to_placements,
                        validate_spec)
from .config import ModelConfig
from .layers import Init, activate, dense_init, is_gated


def moe_init(init: Init, cfg: ModelConfig, lead: Tuple[int, ...] = ()
             ) -> Dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.torch_dtype
    p = {
        "router": dense_init(init, d, e, torch.float32, lead=lead),
        "w_gate": init.normal(lead + (e, d, f), d ** -0.5, dt),
        "w_down": init.normal(lead + (e, f, d), f ** -0.5, dt),
    }
    if is_gated(cfg.act):
        p["w_up"] = init.normal(lead + (e, d, f), d ** -0.5, dt)
    return p


def route_topk(router: torch.Tensor, xt: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (weights (T,k) fp32 normalized, experts (T,k) int64, aux).

    Ties break to the lower expert index, as ``jax.lax.top_k`` does: a
    stable descending sort keeps equal probabilities in index order."""
    E, k = cfg.n_experts, cfg.top_k
    logits = xt.float() @ router
    probs = torch.softmax(logits, dim=-1)
    w_sorted, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    w_topk, experts = w_sorted[:, :k], order[:, :k]
    w_topk = w_topk / torch.clamp(w_topk.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss via per-expert counts (no (T,k,E)
    # one-hot)
    counts = expert_counts(experts.reshape(-1), E).float()
    density = counts / torch.clamp(counts.sum(), min=1.0)
    aux = E * torch.sum(density * probs.mean(0)) * cfg.router_aux_coef
    return w_topk, experts, aux


def expert_counts(ids: torch.Tensor, E: int) -> torch.Tensor:
    """Assignments per expert, (E,) int64: ``bincount(ids, minlength=E)``
    for ids below E, with an output of static shape."""
    return torch.zeros(E, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids.long(), torch.ones_like(ids, dtype=torch.int64))


def assignment_ranks(experts: torch.Tensor, E: int) -> torch.Tensor:
    """Rank of each (token, slot) assignment within its expert: (T, k).
    One stable argsort over (T·k,) ids — indices only, never features."""
    T, k = experts.shape
    e_flat = experts.reshape(-1)
    sort_idx = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[sort_idx]
    counts = expert_counts(e_flat, E)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(T * k, device=experts.device) \
        - starts[e_sorted]
    pos_flat = torch.zeros_like(e_flat).scatter_(0, sort_idx, pos_sorted)
    return pos_flat.reshape(T, k)


def _expert_ffn(params: Dict, buf: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """buf: (E?, cap, D) -> (E?, cap, D) through the stacked expert MLPs."""
    g = torch.bmm(buf, params["w_gate"])
    up = torch.bmm(buf, params["w_up"]) if is_gated(cfg.act) else None
    h = activate(cfg.act, g, up)
    return torch.bmm(h, params["w_down"])


def moe_block(params: Dict, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch: the all-to-all expert parallelism when a mesh context is
    active and the shapes allow (training at scale); the scatter path
    otherwise (one device, decode steps with tiny T)."""
    ctx = current_rules()
    if ctx is not None and is_dtensor(x):
        mesh, rules = ctx
        tp_axis = rules.get("expert")
        tp = (mesh_sizes(mesh).get(tp_axis, 1)
              if isinstance(tp_axis, str) else 1)
        S = x.shape[1]
        if (tp > 1 and cfg.n_experts % tp == 0 and S % tp == 0
                and x.shape[0] * S >= 16 * tp):
            return _moe_block_a2a(params, x, cfg, mesh, rules.get("batch"),
                                  tp_axis, tp)
        return _moe_block_mesh(params, x, cfg, mesh, rules)
    return _moe_block_jit(params, x, cfg)


def _capacity(cfg: ModelConfig, T: int) -> int:
    """The scatter path's slots an expert: rounded up to 512 once
    T >= 4096, as in the reference."""
    cap = max(1, int(cfg.capacity_factor * cfg.top_k * T / cfg.n_experts))
    return -(-cap // 512) * 512 if T >= 4096 else cap


def _dispatch(router: torch.Tensor, xt: torch.Tensor, cfg: ModelConfig,
              cap: int):
    """Route ``xt`` (T, D) and scatter it, k (T, D) scatters, into the
    (E, cap, D) expert buffer: (buf, (weights, experts, ranks), aux).
    Assignments ranked past the capacity drop into a sink slot (index
    cap) that is cut off, so no host sync picks them out."""
    w_topk, experts, aux = route_topk(router, xt, cfg)
    ranks = assignment_ranks(experts, cfg.n_experts)     # (T, k)
    buf = torch.zeros((cfg.n_experts, cap + 1, xt.shape[1]),
                      dtype=xt.dtype, device=xt.device)
    for j in range(cfg.top_k):
        slot = torch.clamp(ranks[:, j], max=cap)
        buf.index_put_((experts[:, j], slot), xt, accumulate=True)
    return buf[:, :cap], (w_topk, experts, ranks), aux


def _combine(y_buf: torch.Tensor, route, like: torch.Tensor
             ) -> torch.Tensor:
    """k (T, D) gathers from the (E, cap, D) results, each weighed by its
    routing weight; dropped assignments weigh 0."""
    w_topk, experts, ranks = route
    cap = y_buf.shape[1]
    out = torch.zeros_like(like)
    for j in range(experts.shape[1]):
        kept = ranks[:, j] < cap
        safe = torch.clamp(ranks[:, j], max=cap - 1)
        w_j = (w_topk[:, j] * kept).to(like.dtype)
        out = out + w_j[:, None] * y_buf[experts[:, j], safe]
    return out


def _moe_block_mesh(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                    mesh, rules) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scatter path on ``DTensor``s, for the shapes the all-to-all
    cannot split (decode steps).  Routing and the scatters run on the whole
    tokens, which are few, the same on every rank; the (E, cap, D) buffer,
    the FFN and its results are sharded over the experts as the
    reference's ``constrain(buf, ("expert", "batch", None))`` lays them, so
    a rank holds and runs only its own experts' weights; an all-gather of
    the results over the expert axis feeds the combine.  The slots are
    not split over the batch axes: every data rank runs its experts on all
    of them."""
    from torch.distributed.tensor import DTensor, Replicate

    rep = [Replicate()] * mesh.ndim
    spec = validate_spec(logical_to_spec(("expert", None, None), rules),
                         params["w_gate"].shape, mesh)
    e_pl = spec_to_placements(spec, mesh)

    def whole(t):
        return t.redistribute(mesh, rep).to_local()

    def experts_shard(t):
        # this rank's experts; the local gradient is that shard's whole one
        return t.redistribute(mesh, e_pl).to_local()

    B, S, D = x.shape
    xt = whole(x).reshape(B * S, D)
    buf, route, aux = _dispatch(whole(params["router"]), xt, cfg,
                                _capacity(cfg, B * S))
    buf = experts_shard(DTensor.from_local(buf, mesh, rep, run_check=False))
    lp = {name: experts_shard(params[name])
          for name in ("w_gate", "w_up", "w_down") if name in params}
    y_buf = DTensor.from_local(_expert_ffn(lp, buf, cfg), mesh, e_pl,
                               run_check=False)
    out = _combine(whole(y_buf), route, xt)
    out = DTensor.from_local(out.reshape(B, S, D), mesh, rep,
                             run_check=False)
    aux = DTensor.from_local(aux, mesh, rep, run_check=False)
    return constrain(out, ("batch", None, None)), aux


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over ``group`` along dim 0 in equal chunks:
    chunk j goes to the group's rank j.  The exchange is its own inverse,
    so the backward sends the gradient's chunks back the same way."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g.contiguous(), ctx.group), None


class _MeanOverRanks(torch.autograd.Function):
    """The mean of a per-rank value over the ranks of ``groups`` (one
    process group a mesh axis), the same on every rank: ``pmean``.  The
    gradient of the replicated result reaches each rank's value divided
    by the number of ranks."""

    @staticmethod
    def forward(ctx, x, groups):
        import torch.distributed as dist
        out = x.detach().clone()
        ctx.n = 1
        for group in groups:
            dist.all_reduce(out, group=group)
            ctx.n *= dist.get_world_size(group)
        return out / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _moe_block_a2a(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                   mesh, dp_axes, tp_axis: str, tp: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism on local shards: tokens sharded (batch x seq)
    over (data axes x 'model'), experts over 'model'.  Each rank routes and
    ranks its local tokens with a per-shard capacity, scatters them into
    (E, cap, D) send buffers, and an all-to-all over the 'model' group
    routes each expert's chunk to the rank owning it; the FFN runs on
    (E/tp, tp*cap, D), the reverse all-to-all brings the results back, and
    the local combine gathers them.  The aux loss is the mean of the
    ranks' local ones.  No (T, D) tensor is ever replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    E_loc = E // tp
    dpt = (dp_axes if isinstance(dp_axes, tuple)
           else ((dp_axes,) if dp_axes else ()))
    x_pl = spec_to_placements((dp_axes, tp_axis, None), mesh)
    w_pl = spec_to_placements((tp_axis, None, None), mesh)
    # a replicated input's local gradient is this rank's share of a sum
    partial = [Partial() if isinstance(p, Replicate) else p for p in w_pl]
    n_mesh = len(mesh.mesh_dim_names)

    def local(t, placements, grad_placements):
        return t.redistribute(mesh, placements).to_local(
            grad_placements=grad_placements)

    router = local(params["router"], [Replicate()] * n_mesh,
                   [Partial()] * n_mesh)
    lp = {name: local(params[name], w_pl, partial)
          for name in ("w_gate", "w_up", "w_down") if name in params}
    x_loc = local(x, x_pl, x_pl)

    b_loc, s_loc, _ = x_loc.shape
    t_loc = b_loc * s_loc
    xt = x_loc.reshape(t_loc, D)
    cap = max(8, -(-int(cfg.capacity_factor * k * t_loc / E) // 8) * 8)
    send, route, aux = _dispatch(router, xt, cfg, cap)
    # route chunks to expert owners: (E, cap, D) -> (E/tp, tp*cap, D)
    group = mesh.get_group(tp_axis)
    recv = _AllToAll.apply(send, group)
    recv = recv.reshape(tp, E_loc, cap, D).transpose(0, 1) \
        .reshape(E_loc, tp * cap, D)
    y = _expert_ffn(lp, recv, cfg)
    # route results back: (E/tp, tp*cap, D) -> (E, cap, D)
    y = y.reshape(E_loc, tp, cap, D).transpose(0, 1).reshape(E, cap, D)
    out = _combine(_AllToAll.apply(y, group), route, xt)
    aux = _MeanOverRanks.apply(
        aux, [mesh.get_group(ax) for ax in dpt + (tp_axis,)])
    out = DTensor.from_local(out.reshape(b_loc, s_loc, D), mesh, x_pl,
                             run_check=False)
    aux = DTensor.from_local(aux, mesh, [Replicate()] * n_mesh,
                             run_check=False)
    return constrain(out, ("batch", "seq", None)), aux


def _moe_block_jit(params: Dict, x: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter dispatch: k (T, D) scatters into (E, cap, D), the stacked
    expert FFNs, k (T, D) gathers back; assignments ranked past the
    capacity are dropped and weigh 0 in the combine."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    buf, route, aux = _dispatch(params["router"], xt, cfg,
                                _capacity(cfg, B * S))
    y_buf = _expert_ffn(params, buf, cfg)     # batched over experts
    return _combine(y_buf, route, xt).reshape(B, S, D), aux
