"""Mixture-of-Experts FFN with top-k routing and capacity-bounded scatter
dispatch, the counterpart of ``repro/models/moe.py`` on one device.

Nothing larger than (T, D) or (E, cap, D) is materialized: the k routing
slots are processed as k separate (T, D) scatters and gathers, assignment
ranks come from one stable argsort over (T·k,) expert ids, and the
load-balance loss uses bincount.  ``moe_block`` always takes the scatter
path (``_moe_block_jit``); the reference's expert-parallel all-to-all
(``_moe_block_a2a``) needs a mesh, which the port does not have yet.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

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
    # Switch-style load-balance loss via bincount (no (T,k,E) one-hot)
    counts = torch.bincount(experts.reshape(-1), minlength=E).float()
    density = counts / torch.clamp(counts.sum(), min=1.0)
    aux = E * torch.sum(density * probs.mean(0)) * cfg.router_aux_coef
    return w_topk, experts, aux


def assignment_ranks(experts: torch.Tensor, E: int) -> torch.Tensor:
    """Rank of each (token, slot) assignment within its expert: (T, k).
    One stable argsort over (T·k,) ids — indices only, never features."""
    T, k = experts.shape
    e_flat = experts.reshape(-1)
    sort_idx = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[sort_idx]
    counts = torch.bincount(e_flat, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(T * k, device=experts.device) \
        - starts[e_sorted]
    pos_flat = torch.zeros_like(e_flat).scatter_(0, sort_idx, pos_sorted)
    return pos_flat.reshape(T, k)


def moe_block(params: Dict, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scatter path on one device (the reference's choice whenever no
    mesh context is active)."""
    return _moe_block_jit(params, x, cfg)


def _moe_block_jit(params: Dict, x: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter dispatch: k (T, D) scatters into (E, cap, D), the stacked
    expert FFNs, k (T, D) gathers back; assignments ranked past the
    capacity are dropped and weigh 0 in the combine."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, D)

    w_topk, experts, aux = route_topk(params["router"], xt, cfg)
    ranks = assignment_ranks(experts, E)                 # (T, k)

    # capacity rounded up to 512 once T >= 4096, as in the reference
    cap = max(1, int(cfg.capacity_factor * k * T / E))
    cap = -(-cap // 512) * 512 if T >= 4096 else cap

    # ---- dispatch: k scatters of (T, D) — overflow ranks drop into a sink
    # slot (index cap) that is cut off, so no host sync picks them out ------
    buf = torch.zeros((E, cap + 1, D), dtype=x.dtype, device=x.device)
    for j in range(k):
        slot = torch.clamp(ranks[:, j], max=cap)
        buf.index_put_((experts[:, j], slot), xt, accumulate=True)
    buf = buf[:, :cap]

    # ---- expert FFN (batched over experts) ------------------------------
    g = torch.bmm(buf, params["w_gate"])
    up = torch.bmm(buf, params["w_up"]) if is_gated(cfg.act) else None
    h = activate(cfg.act, g, up)
    y_buf = torch.bmm(h, params["w_down"])

    # ---- combine: k gathers of (T, D) -----------------------------------
    out = torch.zeros((T, D), dtype=x.dtype, device=x.device)
    for j in range(k):
        kept = ranks[:, j] < cap
        safe = torch.clamp(ranks[:, j], max=cap - 1)
        y_j = y_buf[experts[:, j], safe]
        w_j = (w_topk[:, j] * kept).to(x.dtype)
        out = out + w_j[:, None] * y_j
    return out.reshape(B, S, D), aux
