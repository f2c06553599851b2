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
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return out.to(q.dtype)


def multihead_attention(q, k, v, *, causal: bool, q_positions,
                        kv_len_mask=None, impl: str = "auto",
                        block_kv: int = 1024):
    """Dispatch on implementation.  'auto': dense attention for short query
    spans (incl. decode, sq=1), flash beyond (never materializes
    Sq x Skv)."""
    if impl == "auto":
        impl = "flash_jnp" if q.shape[1] > 1024 else "dense"
    if impl == "dense":
        return _dense_attention(q, k, v, causal, q_positions, kv_len_mask)
    if impl in ("flash_jnp", "pallas"):
        # as in the reference, "pallas" runs the twin
        return _flash_attention_jnp(q, k, v, causal, q_positions,
                                    kv_len_mask, block_kv)
    raise ValueError(impl)


def project_kv(params: Dict, src: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K and V of ``src`` (B, S, D) -> (B, S, n_kv, hd) each, no rope."""
    b, s, _ = src.shape
    k = (src @ params["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = (src @ params["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    return k, v


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
    q = (x @ params["wq"]).reshape(b, s, nh, hd)
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
            raise ValueError(f"KV cache overflow: {pos} filled + {s} new > "
                             f"max_len {max_len}")
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
    y = out.reshape(b, s, nh * hd) @ params["wo"]
    return y, new_cache
