"""Attention blocks: GQA/MQA/MHA with KV cache, dense and flash (online
softmax, never materializes S×S) implementations — the counterpart of
``repro/models/attention.py``.

The flash path (``flash_jnp``) is the twin of the reference's jnp flash
attention, the same blocking over KV as its Pallas kernel.  As in the
reference, ``impl="pallas"`` runs that twin: no model layer launches a
hand-written kernel yet.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..dist.api import P, is_dtensor
from ..runtime import trace
from .config import ModelConfig
from .layers import Init, apply_rope, dense_init

NEG_INF = -1e30


def attn_init(init: Init, cfg: ModelConfig, d_model: Optional[int] = None,
              lead: Tuple[int, ...] = ()) -> Dict:
    d = d_model or cfg.d_model
    hd, nh, nkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    dt = cfg.torch_dtype
    return {
        "wq": dense_init(init, d, nh * hd, dt, lead=lead),
        "wk": dense_init(init, d, nkv * hd, dt, lead=lead),
        "wv": dense_init(init, d, nkv * hd, dt, lead=lead),
        "wo": dense_init(init, nh * hd, d, dt, lead=lead),
    }


class KVCache(NamedTuple):
    """``k``/``v`` live on the model's device.  ``pos`` (tokens filled so far)
    is an int32 tensor on the host: slicing needs it as a number, and reading
    it from the card would wait for the card at every layer."""
    k: torch.Tensor       # (B, S_max, n_kv, hd)
    v: torch.Tensor       # (B, S_max, n_kv, hd)
    pos: torch.Tensor     # () int32, on the host


def init_kv_cache(batch: int, max_len: int, cfg: ModelConfig, device,
                  lead: Tuple[int, ...] = ()) -> KVCache:
    shp = lead + (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return KVCache(
        k=torch.zeros(shp, dtype=cfg.torch_dtype, device=device),
        v=torch.zeros(shp, dtype=cfg.torch_dtype, device=device),
        pos=torch.zeros(lead, dtype=torch.int32))


def _mask_logits(logits, mask, kv_len_mask):
    """logits (b, kv, g, sq, skv); mask (sq, skv); kv_len_mask (b, skv)."""
    if kv_len_mask is not None:
        full = mask[None] & kv_len_mask[:, None, :]
        return torch.where(full[:, None, None], logits, NEG_INF)
    return torch.where(mask[None, None, None], logits, NEG_INF)


def _dense_attention(q, k, v, causal: bool, q_pos, kv_len_mask=None,
                     scale: Optional[float] = None):
    """q: (B,Sq,H,hd) k/v: (B,Skv,KV,hd). GQA via head grouping."""
    b, sq, h, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    group = h // nkv
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(b, sq, nkv, group, hd)
    # float32 logits from the operands' dtype (preferred_element_type)
    logits = torch.einsum("bqkgd,bskd->bkgqs", (qg * scale).float(),
                          k.float())
    if causal:
        kv_pos = torch.arange(skv, device=q.device)
        mask = q_pos[:, None] >= kv_pos[None, :]
    else:
        mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    logits = _mask_logits(logits, mask, kv_len_mask)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, h, hd)


def _flash_attention_jnp(q, k, v, causal: bool, q_pos, kv_len_mask=None,
                         block_kv: int = 1024,
                         scale: Optional[float] = None):
    """Online-softmax blockwise attention; O(Sq * block) memory."""
    b, sq, h, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    group = h // nkv
    scale = scale if scale is not None else hd ** -0.5
    qg = (q * scale).reshape(b, sq, nkv, group, hd)

    block_kv = min(block_kv, skv)
    n_blocks = -(-skv // block_kv)
    pad = n_blocks * block_kv - skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        if kv_len_mask is None:
            kv_len_mask = (torch.arange(skv + pad, device=q.device)
                           < skv).expand(b, skv + pad)
        else:
            kv_len_mask = torch.nn.functional.pad(kv_len_mask, (0, pad))

    m = torch.full((b, nkv, group, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, nkv, group, sq), dtype=torch.float32,
                    device=q.device)
    acc = torch.zeros((b, nkv, group, sq, hd), dtype=torch.float32,
                      device=q.device)
    qf = qg.float()
    for idx in range(n_blocks):
        lo = idx * block_kv
        kblk, vblk = k[:, lo:lo + block_kv], v[:, lo:lo + block_kv]
        logits = torch.einsum("bqkgd,bskd->bkgqs", qf, kblk.float())
        if causal:
            kv_pos = lo + torch.arange(block_kv, device=q.device)
            mask = q_pos[:, None] >= kv_pos[None, :]
        else:
            mask = torch.ones((sq, block_kv), dtype=torch.bool,
                              device=q.device)
        mblk = (None if kv_len_mask is None
                else kv_len_mask[:, lo:lo + block_kv])
        logits = _mask_logits(logits, mask, mblk)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.to(vblk.dtype), vblk).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def multihead_attention(q, k, v, *, causal: bool, q_positions,
                        kv_len_mask=None, impl: str = "auto",
                        block_kv: int = 1024):
    """Dispatch on implementation.  'auto': dense attention for short query
    spans (incl. decode, sq=1), flash beyond (never materializes
    Sq x Skv)."""
    if impl == "auto":
        impl = "flash_jnp" if q.shape[1] > 1024 else "dense"
    if impl == "dense":
        core = _dense_attention
    elif impl in ("flash_jnp", "pallas"):
        # as in the reference, "pallas" runs the twin
        def core(*args):
            return _flash_attention_jnp(*args, block_kv)
    else:
        raise ValueError(impl)
    with trace.span("attn.core", attrs={"impl": impl, "sq": q.shape[1],
                                        "skv": k.shape[1]}):
        if is_dtensor(q):
            return _on_local_shards(core, q, k, v, causal, q_positions,
                                    kv_len_mask)
        return core(q, k, v, causal, q_positions, kv_len_mask)


def _on_local_shards(core, q, k, v, causal, q_pos, kv_len_mask):
    """``core`` on ``DTensor`` q, k, v, run on their local shards.  They are
    laid out once so that each rank holds whole batch rows and whole KV
    groups: the batch over the rules' batch axes; k and v's heads over
    the 'heads' axes where ``n_kv`` divides over them, q's heads split to
    match (by KV head, or by group where one KV head serves them all).
    Where q's heads do not split, q's positions do (each rank attends for
    a slice of the queries, and the output is gathered back to whole
    positions), and where neither does, q replicates.  Each rank then
    attends on its own shards, as one device does, and the output keeps
    q's layout on the other dims.  Where q is split and k, v are not, each
    rank's k, v gradient is its share of a sum (``Partial``), so the
    backward stays local too."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from ..dist.api import (current_rules, shard_start, spec_to_placements,
                            validate_spec)
    from ..dist.sharding import make_rules

    mesh = q.device_mesh
    ctx = current_rules()
    rules = ctx[1] if ctx is not None else make_rules(mesh)
    batch, heads = rules.get("batch"), rules.get("heads")
    kv_spec = validate_spec(P(batch, None, heads, None), k.shape, mesh)
    q_spec = validate_spec(P(batch, None, kv_spec[2] if k.shape[2] > 1
                             else heads, None), q.shape, mesh)
    if q_spec[2] is None:
        q_spec = validate_spec(P(batch, heads, None, None), q.shape, mesh)
    q_pl = spec_to_placements(q_spec, mesh)
    kv_pl = spec_to_placements(kv_spec, mesh)
    kv_grad = [Partial() if isinstance(q_p, Shard) and q_p != kv_p else kv_p
               for q_p, kv_p in zip(q_pl, kv_pl)]
    ql = q.redistribute(mesh, q_pl).to_local()
    kl, vl = (t.redistribute(mesh, kv_pl).to_local(grad_placements=kv_grad)
              for t in (k, v))
    seq = [i for i, p in enumerate(q_pl) if p == Shard(1)]
    if seq and q_pos is not None:
        start = shard_start(mesh, seq, ql.shape[1])
        q_pos = q_pos[start:start + ql.shape[1]]
    if kv_len_mask is not None:
        rows = [Shard(0) if p == Shard(0) else Replicate() for p in q_pl]
        if not is_dtensor(kv_len_mask):
            kv_len_mask = DTensor.from_local(
                kv_len_mask, mesh, [Replicate()] * mesh.ndim,
                run_check=False)
        kv_len_mask = kv_len_mask.redistribute(mesh, rows).to_local()
    out = DTensor.from_local(core(ql, kl, vl, causal, q_pos, kv_len_mask),
                             mesh, q_pl, run_check=False)
    if seq:
        # whole positions again: the output projection views the batch and
        # position dims as one, which DTensor refuses where both are split
        out = out.redistribute(mesh, [Replicate() if p == Shard(1) else p
                                      for p in q_pl])
    return out


def project_kv(params: Dict, src: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K and V of ``src`` (B, S, D) -> (B, S, n_kv, hd) each, no rope."""
    b, s, _ = src.shape
    k = split_heads(src @ params["wk"], cfg.n_kv_heads, cfg.hd)
    v = split_heads(src @ params["wv"], cfg.n_kv_heads, cfg.hd)
    return k, v


def divisible(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``t`` laid out so that dim ``dim`` can split into ``n`` leading
    parts: a ``DTensor`` splits a sharded dim only where its ranks divide
    ``n`` (or ``n`` is 1); over more ranks than that (8 heads over a
    16-way 'model' axis), the dim is gathered first and replicates."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    dim = dim % t.ndim
    on_dim = [i for i, p in enumerate(t.placements)
              if isinstance(p, Shard) and p.dim == dim]
    ranks = 1
    for i in on_dim:
        ranks *= t.device_mesh.size(i)
    if n == 1 or n % ranks == 0:
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if i in on_dim else p
        for i, p in enumerate(t.placements)])


def mergeable(t: torch.Tensor, first: int, last: int) -> torch.Tensor:
    """``t`` laid out so that dims ``first``..``last`` can merge into one:
    a ``DTensor`` flattens dims of which only the first may be sharded, so
    a shard of a later one is gathered first."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    inner = [isinstance(p, Shard) and first < p.dim % t.ndim <= last
             for p in t.placements]
    if not any(inner):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if gather else p
        for gather, p in zip(inner, t.placements)])


class _GradLayout(torch.autograd.Function):
    """The identity; its gradient laid out by ``layout``."""

    @staticmethod
    def forward(ctx, t, layout):
        ctx.layout = layout
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.layout(g), None


def grad_laid_out(t: torch.Tensor, layout) -> torch.Tensor:
    """``t`` as it is; on a ``DTensor`` its gradient goes through
    ``layout`` first.  A view's backward is the inverse view (a merge's a
    split, a split's a merge), which needs the same legal layout."""
    if not (is_dtensor(t) and t.requires_grad):
        return t
    return _GradLayout.apply(t, layout)


def merged(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``t``, the result of merging ``n`` leading parts into dim ``dim``,
    with its gradient laid out for the backward's split."""
    return grad_laid_out(t, lambda g: divisible(g, dim, n))


def split(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t``, the result of splitting one dim into ``dim`` and ``dim + 1``,
    with its gradient laid out for the backward's merge."""
    return grad_laid_out(t, lambda g: mergeable(g, dim, dim + 1))


def split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n·hd) -> (B, S, n, hd) (see ``divisible``)."""
    return split(divisible(t, -1, n).reshape(*t.shape[:-1], n, hd),
                 t.ndim - 1)


def attention_block(params: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, causal: bool = True,
                    cache: Optional[KVCache] = None,
                    xkv: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Full attention sub-block: projections + rope + (cached) attention.

    x: (B, S, D).  With `cache`, writes the new K/V at cache.pos (in place:
    the filled prefix is never rewritten) and attends over everything
    filled so far (decode or chunked prefill).  `xkv` switches to
    cross-attention (no rope on k, no causal mask).
    """
    b, s, _ = x.shape
    hd, nh = cfg.hd, cfg.n_heads
    src = x if xkv is None else xkv
    with trace.span("attn.qkv"):
        q = split_heads(x @ params["wq"], nh, hd)
        k, v = project_kv(params, src, cfg)

        if xkv is None:
            q = apply_rope(q, positions, cfg.rope_mode, cfg.rope_fraction,
                           cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_mode, cfg.rope_fraction,
                           cfg.rope_theta)

        new_cache = None
        kv_len_mask = None
        if cache is not None:
            pos = int(cache.pos)
            max_len = cache.k.shape[1]
            if pos + s > max_len:
                raise ValueError(f"KV cache overflow: {pos} filled + {s} "
                                 f"new > max_len {max_len}")
            cache.k[:, pos:pos + s] = k.to(cache.k.dtype)
            cache.v[:, pos:pos + s] = v.to(cache.v.dtype)
            new_cache = KVCache(k=cache.k, v=cache.v, pos=cache.pos + s)
            k, v = cache.k, cache.v
            kv_len_mask = (torch.arange(max_len, device=x.device)[None, :]
                           < pos + s).expand(b, max_len)

    q_pos = positions if positions.dim() == 1 else positions[0]
    out = multihead_attention(q, k, v, causal=causal and xkv is None,
                              q_positions=q_pos, kv_len_mask=kv_len_mask,
                              impl=cfg.attn_impl, block_kv=cfg.attn_block_kv)
    with trace.span("attn.out"):
        # the attention core never splits hd, so the merge needs no gather
        y = merged(out.reshape(b, s, nh * hd), -1, nh) @ params["wo"]
    return y, new_cache
