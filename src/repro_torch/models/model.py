"""Public model API: init / forward / loss / prefill / decode_step, the
counterpart of ``repro/models/model.py``.

`batch` is a dict of tensors on the params' device:
  tokens        (B, S) int           — always present (decoder tokens)
  labels        (B, S) int           — training
  vision_embeds (B, n_vis, D)        — frontend='vision_stub'
  audio_frames  (B, n_frames, D)     — block='encdec' (conv stub output)
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..device import resolve_device
from ..dist.api import constrain, is_dtensor, shard_start
from ..runtime import trace
from .config import ModelConfig
from .layers import Init, apply_norm, dense_init, norm_init, softcap
from .transformer import (_sinusoidal, decode_stack, encdec_init,
                          encdec_init_cache, encode, stack_apply, stack_init,
                          stack_init_cache)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Dict:
    """Params at the reference's shapes, dtypes and scales, drawn from
    ``generator`` (a ``torch.Generator`` on ``device``).  On the ``meta``
    device (no generator) they are shapes and dtypes only."""
    init = Init(generator, resolve_device(device))
    dt = cfg.torch_dtype
    params: Dict[str, Any] = {
        "embed": init.normal((cfg.vocab_padded, cfg.d_model),
                             cfg.d_model ** -0.5, dt),
        "ln_f": norm_init(cfg.norm, init, cfg.d_model, dt),
    }
    if cfg.block == "encdec":
        params["encdec"] = encdec_init(init, cfg)
    else:
        params["stack"] = stack_init(init, cfg)
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(init, cfg.d_model, cfg.vocab_padded,
                                       dt)
    return params


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the embedding table.  On a ``DTensor`` table whose vocab is
    sharded, vocab-parallel on the local shards: each rank looks up the
    tokens that fall in its rows (zeros for the others) and the result is
    a sum over the vocab ranks (``Partial``), where DTensor's indexing
    would gather the whole table and fill a replicated table-sized
    gradient.  Its values are the lookup's: one rank's row plus zeros."""
    if not (is_dtensor(embed) and is_dtensor(tokens)):
        return embed[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = embed.device_mesh
    vocab = [i for i, p in enumerate(embed.placements)
             if isinstance(p, Shard) and p.dim == 0]
    if not vocab:
        return embed[tokens]
    table_pl = [Shard(0) if i in vocab else Replicate()
                for i in range(mesh.ndim)]
    tok_pl = [Replicate() if i in vocab else p
              for i, p in enumerate(tokens.placements)]
    # over a mesh dim that splits the tokens, a rank's table gradient
    # covers its own tokens: a share of a sum
    grad_pl = [Shard(0) if i in vocab else
               Partial() if isinstance(p, Shard) else Replicate()
               for i, p in enumerate(tok_pl)]
    table = embed.redistribute(mesh, table_pl).to_local(
        grad_placements=grad_pl)
    tok = tokens.redistribute(mesh, tok_pl).to_local()
    start = shard_start(mesh, vocab, table.shape[0])
    inside = (tok >= start) & (tok < start + table.shape[0])
    rows = torch.nn.functional.embedding((tok - start) * inside, table)
    rows = rows * inside.unsqueeze(-1).to(rows.dtype)
    out_pl = [Partial() if i in vocab else p for i, p in enumerate(tok_pl)]
    return DTensor.from_local(rows, mesh, out_pl, run_check=False)


def _embed_inputs(cfg: ModelConfig, params: Dict, batch: Dict
                  ) -> torch.Tensor:
    with trace.span("model.embed"):
        x = embed_lookup(params["embed"], batch["tokens"])
        if cfg.frontend == "vision_stub" and "vision_embeds" in batch:
            # precomputed ViT patch embeddings replace the leading positions
            vis = batch["vision_embeds"].to(x.dtype)
            n = vis.shape[1]
            x = torch.cat([vis, x[:, n:]], dim=1)
        return constrain(x, ("batch", "seq", None))


def _logits(cfg: ModelConfig, params: Dict, x: torch.Tensor
            ) -> torch.Tensor:
    with trace.span("model.head"):
        x = apply_norm(cfg.norm, x, params["ln_f"])
        if cfg.tie_embeddings:
            logits = x @ params["embed"].T
        else:
            logits = x @ params["unembed"]
        logits = softcap(logits.float(), cfg.logit_softcap)
        if cfg.vocab_padded != cfg.vocab:
            # padded ids can never win or contribute to logsumexp
            mask = torch.arange(cfg.vocab_padded,
                                device=x.device) < cfg.vocab
            logits = torch.where(mask, logits, -1e30)
        return constrain(logits, ("batch", "seq", "vocab"))


def _arange(s: int, like: torch.Tensor, start: int = 0) -> torch.Tensor:
    return torch.arange(start, start + s, device=like.device)


def forward(cfg: ModelConfig, params: Dict, batch: Dict
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training/eval forward.  Returns (logits (B,S,V) fp32, aux_loss)."""
    x = _embed_inputs(cfg, params, batch)
    s = x.shape[1]
    positions = _arange(s, x)
    if cfg.block == "encdec":
        enc_out = encode(params["encdec"], batch["audio_frames"], cfg)
        x = x + _sinusoidal(positions, cfg.d_model, x.dtype)[None]
        x, _ = decode_stack(params["encdec"], x, cfg, positions, None,
                            enc_out)
        return _logits(cfg, params, x), torch.zeros(
            (), dtype=torch.float32, device=x.device)
    x, _, aux = stack_apply(params["stack"], x, cfg, positions, None)
    return _logits(cfg, params, x), aux


def vocab_parallel_logz_gold(logits: torch.Tensor, labels: torch.Tensor
                             ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """``(logsumexp(logits), logits[label])`` over the last dim, computed
    on the local shards of a ``DTensor`` whose vocab (last) dim is
    sharded; ``None`` for any other ``logits``.  The row maximum is a
    detached all-reduce MAX over the vocab ranks; the sum of
    ``exp(logits - max)`` and the gold logit (the rank's own where the
    label falls in its vocab range, zero elsewhere) are sums over the
    vocab ranks (``Partial`` redistributed to ``Replicate``).  Where
    DTensor's ``logsumexp`` and ``gather`` would all-gather the vocab and
    the gather's backward would fill a replicated (B, S, V) gradient, no
    tensor of the global shape is made, forward or backward.  The other
    dims keep the logits' layout, and the labels are laid out to match."""
    if not is_dtensor(logits):
        return None
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh, last = logits.device_mesh, logits.ndim - 1
    vocab = [i for i, p in enumerate(logits.placements)
             if isinstance(p, Shard) and p.dim == last]
    if not vocab:
        return None
    row_pl = [Replicate() if i in vocab else p
              for i, p in enumerate(logits.placements)]
    if not is_dtensor(labels):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    lab = labels.redistribute(mesh, row_pl).to_local()
    local = logits.to_local()

    def over_vocab(t: torch.Tensor, op: str) -> torch.Tensor:
        pl = [Partial(op) if i in vocab else p for i, p in enumerate(row_pl)]
        return DTensor.from_local(t, mesh, pl, run_check=False
                                  ).redistribute(mesh, row_pl)

    m = over_vocab(local.detach().amax(dim=-1), "max").to_local()
    sumexp = over_vocab(torch.exp(local - m.unsqueeze(-1)).sum(dim=-1),
                        "sum")
    start = shard_start(mesh, vocab, local.shape[-1])
    inside = (lab >= start) & (lab < start + local.shape[-1])
    mine = torch.gather(local, -1, ((lab - start) * inside).unsqueeze(-1)
                        ).squeeze(-1)
    gold = over_vocab(torch.where(inside, mine, torch.zeros_like(mine)),
                      "sum")
    logz = torch.log(sumexp) + DTensor.from_local(m, mesh, row_pl,
                                                  run_check=False)
    return logz, gold


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each token's ``logsumexp(logits) - logits[label]``; vocab-parallel
    (``vocab_parallel_logz_gold``) on logits whose vocab is sharded."""
    labels = labels.long()
    parts = vocab_parallel_logz_gold(logits, labels)
    if parts is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.unsqueeze(-1)).squeeze(-1)
    else:
        logz, gold = parts
    return logz - gold


def loss_fn(cfg: ModelConfig, params: Dict, batch: Dict
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's loss: mean next-token NLL over the loss mask plus
    the MoE aux loss, as (total, metrics).  Gradients come from autograd
    through the same ops (``launch/steps.py``); ``cfg.remat`` changes the
    backward's memory, not its values."""
    logits, aux = forward(cfg, params, batch)
    with trace.span("model.head"):
        nll = token_nll(logits, batch["labels"])
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones_like(nll)
        loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
        total = loss + aux
        return total, {"loss": loss, "aux_loss": aux,
                       "tokens": torch.sum(mask)}


# --------------------------------------------------------------------------
# inference: prefill + decode
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, device=None):
    """Zeroed decode caches on ``device`` (their fill counters on the
    host)."""
    dev = resolve_device(device)
    if cfg.block == "encdec":
        return encdec_init_cache(cfg, batch_size, max_len, dev)
    return stack_init_cache(cfg, batch_size, max_len, dev)


def prefill(cfg: ModelConfig, params: Dict, batch: Dict, cache
            ) -> Tuple[torch.Tensor, Any]:
    """Run the prompt through the model, filling the cache.
    Returns (last-token logits (B, V), cache)."""
    x = _embed_inputs(cfg, params, batch)
    s = x.shape[1]
    positions = _arange(s, x)
    if cfg.block == "encdec":
        enc_out = encode(params["encdec"], batch["audio_frames"], cfg)
        x = x + _sinusoidal(positions, cfg.d_model, x.dtype)[None]
        x, new_cache = decode_stack(params["encdec"], x, cfg, positions,
                                    cache, enc_out)
        return _logits(cfg, params, x[:, -1:])[:, 0], new_cache
    x, new_cache, _ = stack_apply(params["stack"], x, cfg, positions, cache)
    return _logits(cfg, params, x[:, -1:])[:, 0], new_cache


def _cache_pos(cfg: ModelConfig, cache) -> Optional[int]:
    if cfg.block == "encdec":
        return int(cache.self_kv.pos[0])
    if cfg.block in ("dense", "moe"):
        return int(cache.pos[0])
    if cfg.block == "mamba2_hybrid":
        return int(cache["attn"].pos[0])
    return None  # mamba1: position-free


def decode_step(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, cache
                ) -> Tuple[torch.Tensor, Any]:
    """One decode step.  tokens: (B, 1).  Returns (logits (B, V), cache)."""
    # laid out as the prefill's inputs are: a vocab-parallel lookup's sum
    # left pending would carry into the first layer's projections, which
    # would then run replicated over the vocab ranks
    with trace.span("model.embed"):
        x = constrain(embed_lookup(params["embed"], tokens),
                      ("batch", "seq", None))
    pos0 = _cache_pos(cfg, cache)
    positions = _arange(tokens.shape[1], x, 0 if pos0 is None else pos0)
    if cfg.block == "encdec":
        x = x + _sinusoidal(positions, cfg.d_model, x.dtype)[None]
        x, new_cache = decode_stack(params["encdec"], x, cfg, positions,
                                    cache, None)
        return _logits(cfg, params, x)[:, -1], new_cache
    x, new_cache, _ = stack_apply(params["stack"], x, cfg, positions, cache)
    return _logits(cfg, params, x)[:, -1], new_cache
