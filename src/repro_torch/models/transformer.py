"""Layer-stack composition: dense / MoE / Mamba / hybrid / enc-dec stacks,
the counterpart of ``repro/models/transformer.py``.

Params keep the reference's stacked leading layer axis; the stacks loop over
it in Python (the reference's ``lax.scan``), taking each layer's params and
caches as views.  The Zamba2 hybrid runs groups of `hybrid_period` Mamba-2
layers, each followed by one *shared* attention block (same weights every
invocation).  KV caches are written in place; SSM and cross-attention caches
are rebuilt, as the reference builds every cache.

Without a cache (the training forward) ``cfg.remat`` checkpoints each site
the reference wraps in ``jax.checkpoint``: every layer, and in the hybrid
each Mamba layer inside its checkpointed group.  The backward then replays
the forward instead of keeping its activations; the values are the same.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..dist.api import axis_rules, constrain, current_rules, unshard_dim
from ..runtime import trace
from .attention import (KVCache, attention_block, attn_init, init_kv_cache,
                        multihead_attention, project_kv)
from .config import ModelConfig
from .layers import Init, activate, apply_norm, dense_init, is_gated, \
    norm_init
from .moe import moe_block, moe_init
from .ssm import (init_ssm_cache, mamba1_block, mamba2_block,
                  mamba1_init, mamba2_init)


def _layer(tree, i):
    """Layer ``i`` of a stacked param or cache tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):           # KVCache / SSMCache
        return type(tree)(*(_layer(v, i) for v in tree))
    return tree[i]


def _unstack(tree, n: int) -> List:
    """The ``n`` layers of a stacked param tree, each leaf unbound once
    along its layer axis (views).  Under autograd the backward then stacks
    the layers' grads in one write, where taking ``tree[i]`` a layer would
    write a zero tensor of the whole stack for each layer's grad."""
    if isinstance(tree, dict):
        split = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: split[k][i] for k in tree} for i in range(n)]
    out = torch.unbind(unshard_dim(tree, 0))
    if len(out) != n:
        raise ValueError(f"stacked leaf of {len(out)} layers, expected {n}")
    return list(out)


def _remat(fn: Callable, cfg: ModelConfig, *args):
    """``fn(*args)``, checkpointed when ``cfg.remat``.  The backward's
    recompute runs under the rules bound now: autograd runs it on the
    device's own thread, where this thread's binding is not seen, and a
    recompute under other layouts (or another MoE path) than the forward's
    would save other tensors."""
    if cfg.remat:
        ctx = current_rules()
        if ctx is not None:
            inner = fn

            def fn(*a):
                with axis_rules(*ctx):
                    return inner(*a)
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _restack(old, new: List):
    """The stacked cache ``old`` after its layers' updates ``new``: a KV
    cache's k/v were written in place into ``old``'s tensors, so only its
    fill counters are stacked anew; every other leaf is stacked."""
    if isinstance(old, dict):
        return {k: _restack(old[k], [c[k] for c in new]) for k in old}
    if isinstance(old, KVCache):
        return KVCache(k=old.k, v=old.v,
                       pos=torch.stack([c.pos for c in new]))
    return type(old)(*(torch.stack(leaves) for leaves in zip(*new)))


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def mlp_init(init: Init, cfg: ModelConfig, d: Optional[int] = None,
             f: Optional[int] = None, lead: Tuple[int, ...] = ()) -> Dict:
    d = d or cfg.d_model
    f = f or cfg.d_ff
    dt = cfg.torch_dtype
    p = {"w_gate": dense_init(init, d, f, dt, lead=lead),
         "w_down": dense_init(init, f, d, dt, lead=lead)}
    if is_gated(cfg.act):
        p["w_up"] = dense_init(init, d, f, dt, lead=lead)
    return p


def mlp_block(params: Dict, x: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    with trace.span("mlp"):
        g = x @ params["w_gate"]
        up = x @ params["w_up"] if is_gated(cfg.act) else None
        h = constrain(activate(cfg.act, g, up), ("batch", "seq", "ff"))
        return h @ params["w_down"]


# --------------------------------------------------------------------------
# per-layer inits
# --------------------------------------------------------------------------

def dense_layer_init(init: Init, cfg: ModelConfig,
                     lead: Tuple[int, ...] = ()) -> Dict:
    dt = cfg.torch_dtype
    return {"ln1": norm_init(cfg.norm, init, cfg.d_model, dt, lead),
            "attn": attn_init(init, cfg, lead=lead),
            "ln2": norm_init(cfg.norm, init, cfg.d_model, dt, lead),
            "mlp": mlp_init(init, cfg, lead=lead)}


def moe_layer_init(init: Init, cfg: ModelConfig,
                   lead: Tuple[int, ...] = ()) -> Dict:
    dt = cfg.torch_dtype
    return {"ln1": norm_init(cfg.norm, init, cfg.d_model, dt, lead),
            "attn": attn_init(init, cfg, lead=lead),
            "ln2": norm_init(cfg.norm, init, cfg.d_model, dt, lead),
            "moe": moe_init(init, cfg, lead=lead)}


def mamba_layer_init(init: Init, cfg: ModelConfig,
                     lead: Tuple[int, ...] = ()) -> Dict:
    block_init = mamba1_init if cfg.block == "mamba1" else mamba2_init
    return {"ln1": norm_init(cfg.norm, init, cfg.d_model, cfg.torch_dtype,
                             lead),
            "mamba": block_init(init, cfg, lead=lead)}


# --------------------------------------------------------------------------
# per-layer applies  (x, cache) -> (x, new_cache, aux)
# --------------------------------------------------------------------------

def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def dense_layer(params, x, cfg: ModelConfig, positions, cache):
    h = apply_norm(cfg.norm, x, params["ln1"])
    a, new_cache = attention_block(params["attn"], h, cfg,
                                   positions=positions, cache=cache)
    x = constrain(x + a, ("batch", "seq", None))
    h = apply_norm(cfg.norm, x, params["ln2"])
    x = constrain(x + mlp_block(params["mlp"], h, cfg),
                  ("batch", "act_seq", None))
    return x, new_cache, _zero(x)


def moe_layer(params, x, cfg: ModelConfig, positions, cache):
    h = apply_norm(cfg.norm, x, params["ln1"])
    a, new_cache = attention_block(params["attn"], h, cfg,
                                   positions=positions, cache=cache)
    x = constrain(x + a, ("batch", "seq", None))
    h = apply_norm(cfg.norm, x, params["ln2"])
    m, aux = moe_block(params["moe"], h, cfg)
    return constrain(x + m, ("batch", "act_seq", None)), new_cache, aux


def mamba_layer(params, x, cfg: ModelConfig, positions, cache):
    del positions
    h = apply_norm(cfg.norm, x, params["ln1"])
    block = mamba1_block if cfg.block == "mamba1" else mamba2_block
    m, new_cache = block(params["mamba"], h, cfg, cache)
    return (constrain(x + m, ("batch", "act_seq", None)), new_cache,
            _zero(x))


_LAYER = {"dense": (dense_layer_init, dense_layer),
          "moe": (moe_layer_init, moe_layer),
          "mamba1": (mamba_layer_init, mamba_layer),
          "mamba2_hybrid": (mamba_layer_init, mamba_layer)}


# --------------------------------------------------------------------------
# stacks
# --------------------------------------------------------------------------

def stack_init(init: Init, cfg: ModelConfig) -> Dict:
    init_fn, _ = _LAYER[cfg.block]
    p: Dict[str, Any] = {"layers": init_fn(init, cfg, lead=(cfg.n_layers,))}
    if cfg.block == "mamba2_hybrid":
        p["shared"] = dense_layer_init(init, cfg)
    return p


def stack_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, caches=None
                ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Apply the whole layer stack.  caches: stacked cache tree or None.
    Returns (x, new_caches, aux_sum)."""
    if cfg.block == "mamba2_hybrid":
        return _hybrid_apply(params, x, cfg, positions, caches)
    _, layer_fn = _LAYER[cfg.block]
    layers = _unstack(params["layers"], cfg.n_layers)

    def body(i, lp, h, cache):
        with trace.span("layer", attrs={"i": i}):
            return layer_fn(lp, h, cfg, positions, cache)

    new_caches, aux_sum = [], _zero(x)
    for i in range(cfg.n_layers):
        if caches is None:
            x, nc, aux = _remat(body, cfg, i, layers[i], x, None)
        else:
            x, nc, aux = body(i, layers[i], x, _layer(caches, i))
        new_caches.append(nc)
        aux_sum = aux_sum + aux
    return x, (None if caches is None else _restack(caches, new_caches)), \
        aux_sum


def _hybrid_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, caches=None):
    """Zamba2: groups of `hybrid_period` mamba layers, each group followed
    by the shared attention block (weights reused every time)."""
    period = cfg.hybrid_period
    n_groups = cfg.n_layers // period
    assert n_groups * period == cfg.n_layers, \
        "hybrid stack requires n_layers % hybrid_period == 0"
    shared = params["shared"]
    layers = _unstack(params["layers"], cfg.n_layers)
    if caches is None:
        def mamba(lp, h):
            return mamba_layer(lp, h, cfg, positions, None)

        def group(lps, h):
            aux_sum = _zero(h)
            for lp in lps:
                h, _, aux = _remat(mamba, cfg, lp, h)
                aux_sum = aux_sum + aux
            h, _, aux2 = dense_layer(shared, h, cfg, positions, None)
            return h, aux_sum + aux2

        aux_sum = _zero(x)
        for g in range(n_groups):
            x, aux = _remat(group, cfg, layers[g * period:(g + 1) * period],
                            x)
            aux_sum = aux_sum + aux
        return x, None, aux_sum
    new_ms, new_as, aux_sum = [], [], _zero(x)
    for g in range(n_groups):
        group_m = []
        for j in range(period):
            mc = _layer(_layer(caches["mamba"], g), j)
            x, nmc, aux = mamba_layer(layers[g * period + j], x, cfg,
                                      positions, mc)
            group_m.append(nmc)
            aux_sum = aux_sum + aux
        x, nac, aux2 = dense_layer(shared, x, cfg, positions,
                                   _layer(caches["attn"], g))
        aux_sum = aux_sum + aux2
        new_ms.append(group_m)
        new_as.append(nac)
    old_m = caches["mamba"]
    new_m = _restack(old_m, [_restack(_layer(old_m, g), gm)
                             for g, gm in enumerate(new_ms)])
    return x, {"mamba": new_m, "attn": _restack(caches["attn"], new_as)}, \
        aux_sum


def stack_init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    """Stacked decode caches matching stack_apply's expectations."""
    if cfg.block in ("dense", "moe"):
        return init_kv_cache(batch, max_len, cfg, device, (cfg.n_layers,))
    if cfg.block == "mamba1":
        return init_ssm_cache(batch, cfg, device, (cfg.n_layers,))
    if cfg.block == "mamba2_hybrid":
        n_groups = cfg.n_layers // cfg.hybrid_period
        return {"mamba": init_ssm_cache(batch, cfg, device,
                                        (n_groups, cfg.hybrid_period)),
                "attn": init_kv_cache(batch, max_len, cfg, device,
                                      (n_groups,))}
    raise ValueError(cfg.block)


# --------------------------------------------------------------------------
# encoder-decoder (whisper)
# --------------------------------------------------------------------------

class EncDecCache(NamedTuple):
    self_kv: Any            # stacked KVCache over decoder layers
    cross_k: torch.Tensor   # (Ld, B, S_enc, n_kv, hd)
    cross_v: torch.Tensor
    ready: torch.Tensor     # () int32 — cross KV computed


def encdec_init(init: Init, cfg: ModelConfig) -> Dict:
    dt = cfg.torch_dtype
    enc, dec = (cfg.enc_layers,), (cfg.dec_layers,)
    return {
        "enc_layers": {"ln1": norm_init(cfg.norm, init, cfg.d_model, dt, enc),
                       "attn": attn_init(init, cfg, lead=enc),
                       "ln2": norm_init(cfg.norm, init, cfg.d_model, dt, enc),
                       "mlp": mlp_init(init, cfg, lead=enc)},
        "dec_layers": {"ln1": norm_init(cfg.norm, init, cfg.d_model, dt, dec),
                       "self_attn": attn_init(init, cfg, lead=dec),
                       "ln_x": norm_init(cfg.norm, init, cfg.d_model, dt, dec),
                       "cross_attn": attn_init(init, cfg, lead=dec),
                       "ln2": norm_init(cfg.norm, init, cfg.d_model, dt, dec),
                       "mlp": mlp_init(init, cfg, lead=dec)},
        "ln_enc": norm_init(cfg.norm, init, cfg.d_model, dt)}


def _sinusoidal(positions: torch.Tensor, d: int, dtype) -> torch.Tensor:
    half = d // 2
    steps = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-steps / max(half - 1, 1)
                      * torch.log(torch.tensor(10000.0)).item())
    ang = positions.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


def encode(params: Dict, frames: torch.Tensor, cfg: ModelConfig
           ) -> torch.Tensor:
    """frames: (B, S_enc, D) precomputed conv/mel stub embeddings."""
    s = frames.shape[1]
    positions = torch.arange(s, device=frames.device)
    x = frames + _sinusoidal(positions, cfg.d_model, frames.dtype)[None]

    def body(lp, h):
        a, _ = attention_block(lp["attn"], apply_norm(cfg.norm, h, lp["ln1"]),
                               cfg, positions=positions, causal=False)
        h = h + a
        return h + mlp_block(lp["mlp"], apply_norm(cfg.norm, h, lp["ln2"]),
                             cfg)

    for lp in _unstack(params["enc_layers"], cfg.enc_layers):
        x = _remat(body, cfg, lp, x)
    return apply_norm(cfg.norm, x, params["ln_enc"])


def decode_stack(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, cache: Optional[EncDecCache],
                 enc_out: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, Optional[EncDecCache]]:
    """Decoder stack; at prefill, enc_out is given and cross-KV is cached.
    Without a cache (the training forward) enc_out is always given."""
    layers = _unstack(params["dec_layers"], cfg.dec_layers)

    def body(lp, h, kv_cache, cross):
        a, new_kv = attention_block(
            lp["self_attn"], apply_norm(cfg.norm, h, lp["ln1"]), cfg,
            positions=positions, cache=kv_cache)
        h = h + a
        hq = apply_norm(cfg.norm, h, lp["ln_x"])
        if cross is None:
            # cross attention from the encoder output
            ca, _ = attention_block(lp["cross_attn"], hq, cfg,
                                    positions=positions, causal=False,
                                    xkv=enc_out)
        else:
            # reuse the cached cross K/V
            b, sq, _ = hq.shape
            q = (hq @ lp["cross_attn"]["wq"]).reshape(b, sq, cfg.n_heads,
                                                      cfg.hd)
            o = multihead_attention(q, *cross, causal=False,
                                    q_positions=positions,
                                    impl=cfg.attn_impl,
                                    block_kv=cfg.attn_block_kv)
            ca = o.reshape(b, sq, cfg.n_heads * cfg.hd) \
                @ lp["cross_attn"]["wo"]
        h = h + ca
        h = h + mlp_block(lp["mlp"], apply_norm(cfg.norm, h, lp["ln2"]), cfg)
        return h, new_kv

    if cache is None:
        def train_body(lp, h):
            return body(lp, h, None, None)[0]

        for lp in layers:
            x = _remat(train_body, cfg, lp, x)
        return x, None
    new_kvs, cks, cvs = [], [], []
    for i, lp in enumerate(layers):
        if enc_out is not None:
            # prefill: the cross K/V of the encoder output are cached
            cross = None
            ck, cv = project_kv(lp["cross_attn"], enc_out, cfg)
        else:
            cross = ck, cv = cache.cross_k[i], cache.cross_v[i]
        x, new_kv = body(lp, x, _layer(cache.self_kv, i), cross)
        new_kvs.append(new_kv)
        cks.append(ck)
        cvs.append(cv)
    return x, EncDecCache(self_kv=_restack(cache.self_kv, new_kvs),
                          cross_k=torch.stack(cks), cross_v=torch.stack(cvs),
                          ready=torch.ones((), dtype=torch.int32))


def encdec_init_cache(cfg: ModelConfig, batch: int, max_len: int, device
                      ) -> EncDecCache:
    self_kv = init_kv_cache(batch, max_len, cfg, device, (cfg.dec_layers,))
    ck = torch.zeros((cfg.dec_layers, batch, cfg.n_audio_frames,
                      cfg.n_kv_heads, cfg.hd), dtype=cfg.torch_dtype,
                     device=device)
    return EncDecCache(self_kv=self_kv, cross_k=ck, cross_v=ck,
                       ready=torch.zeros((), dtype=torch.int32))
