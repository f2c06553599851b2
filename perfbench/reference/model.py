"""Plain PyTorch reference of the decoder family
(``perfbench/families/decoder.py``).

Dense and mixture-of-experts decoder stacks written from the published
layer equations, in float32 with TF32 off, with no kernel, cache or
batching of the program under test.  It imports nothing of the program.
The parameters come in the layout the benchmark draws them in
(``perfbench/weights.py``): a flat ``{path: tensor}`` dict whose stacked
leaves carry a leading layer axis.  Another architecture's reference is
a module of its own beside this one, named by its family; what every
reference shares (products, the float8 control, AdamW) is
``common.py``.

Memory is bounded by blocks, not by a smaller problem: each layer is
checkpointed, attention runs over one sequence and a few heads at a time
(each block checkpointed too), and the loss runs over blocks of rows.

``quant="fp8"`` is the control: every matrix product but the router's
takes its operands through float8 e4m3 with a per-tensor scale (and a
straight-through gradient), the precision a later change might be
tempted to run the configuration's bfloat16 products in.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import common
from .common import mm


@dataclasses.dataclass(frozen=True)
class Spec:
    """The sizes the reference needs, read from a configuration file."""
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    vocab_stored: int
    norm: str
    norm_eps: float
    rope_fraction: float
    rope_theta: float
    tie_embeddings: bool
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 0.0
    capacity_round: int = 1
    capacity_round_from: int = 0
    router_aux_coef: float = 0.0
    norm_topk: bool = True

    @classmethod
    def from_config(cls, conf: Dict) -> "Spec":
        """The sizes of a configuration file as the program runs it: its
        ``as_run`` values, where the program departs from the published
        ones, over the published."""
        conf = {**conf, **conf.get("as_run", {})}
        if conf["hidden_act"] != "silu" or not conf.get("gated_mlp", True):
            raise ValueError("the reference implements the SwiGLU MLP only")
        pad = conf.get("vocab_pad_multiple", 1)
        moe = conf.get("num_experts", 0)
        return cls(
            n_layers=conf["num_hidden_layers"], d_model=conf["hidden_size"],
            n_heads=conf["num_attention_heads"],
            n_kv_heads=conf["num_key_value_heads"],
            head_dim=conf["head_dim"], d_ff=conf["intermediate_size"],
            vocab=conf["vocab_size"],
            vocab_stored=-(-conf["vocab_size"] // pad) * pad,
            norm=conf["norm"],
            norm_eps=conf["layer_norm_eps" if conf["norm"] == "layernorm"
                          else "rms_norm_eps"],
            rope_fraction=conf.get("partial_rotary_factor", 1.0),
            rope_theta=conf["rope_theta"],
            tie_embeddings=conf["tie_word_embeddings"],
            n_experts=moe, top_k=conf.get("num_experts_per_tok", 0),
            capacity_factor=conf.get("capacity_factor", 0.0),
            capacity_round=conf.get("capacity_round", 1),
            capacity_round_from=conf.get("capacity_round_from_tokens", 0),
            router_aux_coef=conf.get("router_aux_loss_coef", 0.0),
            norm_topk=conf.get("norm_topk_prob", True))


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def norm(spec: Spec, x: torch.Tensor, p: Dict[str, torch.Tensor]
         ) -> torch.Tensor:
    if spec.norm == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + spec.norm_eps) * p["scale"] \
            + p["bias"]
    if spec.norm == "rmsnorm":
        return x / torch.sqrt((x * x).mean(-1, keepdim=True)
                              + spec.norm_eps) * p["scale"]
    raise ValueError(spec.norm)


def rope(spec: Spec, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Rotary embedding of the first ``rope_fraction`` of each head, its
    two halves rotated as pairs (x_i, x_{i+rot/2}).  x: (..., S, H, hd)."""
    rot = max(2, int(spec.head_dim * spec.rope_fraction) // 2 * 2)
    half = rot // 2
    inv = spec.rope_theta ** (-torch.arange(0, rot, 2, dtype=torch.float32,
                                            device=x.device) / rot)
    ang = pos.float()[:, None] * inv[None, :]           # (S, half)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2, rest = x[..., :half], x[..., half:rot], x[..., rot:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, rest], -1)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: float, quant: Optional[str]) -> torch.Tensor:
    """Causal softmax attention of one block: q (h, S, hd), k/v (h, S,
    hd)."""
    s = q.shape[1]
    scores = mm(q, k.transpose(1, 2), quant) * scale
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    return mm(torch.softmax(scores, dim=-1), v, quant)


def attention(spec: Spec, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, S, KV, hd) -> (B, S, H·hd), one sequence
    and a block of heads at a time."""
    b, s, h, hd = q.shape
    group = h // k.shape[2]
    heads = max(1, min(h, (1 << 29) // (4 * s * s)))
    scale = hd ** -0.5
    out = []
    for i in range(b):
        parts = []
        for h0 in range(0, h, heads):
            h1 = min(h, h0 + heads)
            kv = torch.arange(h0, h1, device=q.device) // group
            qb = q[i, :, h0:h1].transpose(0, 1)
            kb = k[i][:, kv].transpose(0, 1)
            vb = v[i][:, kv].transpose(0, 1)
            if torch.is_grad_enabled():
                o = checkpoint(_attend, qb, kb, vb, scale, quant,
                               use_reentrant=False)
            else:
                o = _attend(qb, kb, vb, scale, quant)
            parts.append(o.transpose(0, 1))
        out.append(torch.cat(parts, 1))
    return torch.stack(out).reshape(b, s, h * hd)


def capacity(spec: Spec, tokens: int) -> int:
    """Slots an expert keeps, as the configuration states them."""
    cap = max(1, int(spec.capacity_factor * spec.top_k * tokens
                     / spec.n_experts))
    if spec.capacity_round_from and tokens >= spec.capacity_round_from:
        cap = -(-cap // spec.capacity_round) * spec.capacity_round
    return cap


def moe(spec: Spec, h: torch.Tensor, p: Dict[str, torch.Tensor],
        quant: Optional[str]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing over all experts with per-expert capacity: an
    expert keeps its first ``capacity`` assignments in (token, slot)
    order and drops the rest.  Returns (output (T, D), aux loss)."""
    t, d = h.shape
    e, k = spec.n_experts, spec.top_k
    probs = torch.softmax(h @ p["router"], dim=-1)           # (T, E)
    w, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, experts = w[:, :k], experts[:, :k]
    if spec.norm_topk:
        w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    flat = experts.reshape(-1)
    onehot = F.one_hot(flat, e)                               # (T·k, E)
    counts = onehot.sum(0).float()
    aux = e * torch.sum(counts / counts.sum().clamp(min=1.0)
                        * probs.mean(0)) * spec.router_aux_coef
    rank = (onehot.cumsum(0) - 1).gather(1, flat[:, None])[:, 0]
    kept = rank < capacity(spec, t)
    wflat = w.reshape(-1)
    out = torch.zeros_like(h)
    for ex in range(e):
        sel = torch.nonzero((flat == ex) & kept)[:, 0]
        if sel.numel() == 0:
            continue
        tok = sel // k
        x = h[tok]
        y = mm(F.silu(mm(x, p["w_gate"][ex], quant))
               * mm(x, p["w_up"][ex], quant), p["w_down"][ex], quant)
        out = out.index_add(0, tok, y * wflat[sel][:, None])
    return out, aux


def layer(spec: Spec, x: torch.Tensor, p: Dict[str, torch.Tensor],
          quant: Optional[str]) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, d = x.shape
    pos = torch.arange(s, device=x.device)
    h = norm(spec, x, {"scale": p["ln1/scale"], "bias": p.get("ln1/bias")})
    q = mm(h, p["attn/wq"], quant).reshape(b, s, spec.n_heads,
                                            spec.head_dim)
    kk = mm(h, p["attn/wk"], quant).reshape(b, s, spec.n_kv_heads,
                                             spec.head_dim)
    vv = mm(h, p["attn/wv"], quant).reshape(b, s, spec.n_kv_heads,
                                             spec.head_dim)
    a = attention(spec, rope(spec, q, pos), rope(spec, kk, pos), vv, quant)
    x = x + mm(a, p["attn/wo"], quant)
    h = norm(spec, x, {"scale": p["ln2/scale"], "bias": p.get("ln2/bias")})
    if spec.n_experts:
        y, aux = moe(spec, h.reshape(b * s, d),
                     {n: p["moe/" + n] for n in
                      ("router", "w_gate", "w_up", "w_down")}, quant)
        return x + y.reshape(b, s, d), aux
    y = mm(F.silu(mm(h, p["mlp/w_gate"], quant)) * mm(h, p["mlp/w_up"],
                                                      quant),
           p["mlp/w_down"], quant)
    return x + y, torch.zeros((), device=x.device)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

LAYERS = "stack/layers/"


def _norm_params(params: Dict[str, torch.Tensor], prefix: str) -> Dict:
    if prefix + "/scale" in params:
        return {"scale": params[prefix + "/scale"],
                "bias": params.get(prefix + "/bias")}
    return {"scale": params[prefix], "bias": None}


def _layers(spec: Spec, params: Dict[str, torch.Tensor]) -> List[Dict]:
    """Each layer's params as views, each stacked leaf unbound once."""
    per = [dict() for _ in range(spec.n_layers)]
    for path, leaf in params.items():
        if not path.startswith(LAYERS):
            continue
        name = path[len(LAYERS):]
        if name in ("ln1", "ln2"):          # an RMSNorm scale
            name += "/scale"
        for i, view in enumerate(torch.unbind(leaf)):
            per[i][name] = view
    return per


def hidden(spec: Spec, params: Dict[str, torch.Tensor],
           tokens: torch.Tensor, quant: Optional[str]
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The final-normed hidden states (B, S, D) and the summed aux loss."""
    x = params["embed"][tokens]
    aux = torch.zeros((), device=x.device)
    grad = torch.is_grad_enabled()
    for p in _layers(spec, params):
        if grad:
            x, a = checkpoint(layer, spec, x, p, quant, use_reentrant=False)
        else:
            x, a = layer(spec, x, p, quant)
        aux = aux + a
    return norm(spec, x, _norm_params(params, "ln_f")), aux


def _head(spec: Spec, params: Dict[str, torch.Tensor]) -> torch.Tensor:
    if spec.tie_embeddings:
        return params["embed"][:spec.vocab].T
    return params["unembed"][:, :spec.vocab]


def _nll_sum(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
             quant: Optional[str]) -> torch.Tensor:
    logits = mm(h, head, quant)
    gold = logits.gather(1, labels[:, None])[:, 0]
    return (torch.logsumexp(logits, -1) - gold).sum()


def loss(spec: Spec, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
         labels: torch.Tensor, quant: Optional[str] = None,
         rows: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the mean next-token loss over every token plus the MoE aux loss,
    the mean next-token loss alone)."""
    h, aux = hidden(spec, params, tokens, quant)
    h = h.reshape(-1, h.shape[-1])
    labels = labels.reshape(-1).long()
    head = _head(spec, params)
    total = torch.zeros((), device=h.device)
    for r in range(0, h.shape[0], rows):
        total = total + checkpoint(_nll_sum, h[r:r + rows], head,
                                   labels[r:r + rows], quant,
                                   use_reentrant=False)
    nll = total / h.shape[0]
    return nll + aux, nll


@torch.no_grad()
def logits_at(spec: Spec, params: Dict[str, torch.Tensor],
              tokens: torch.Tensor, first: int,
              quant: Optional[str] = None) -> torch.Tensor:
    """Logits (n, vocab) of one sequence ``tokens`` (S,) at positions
    ``first`` .. S-1."""
    h, _ = hidden(spec, params, tokens[None], quant)
    return mm(h[0, first:], _head(spec, params), quant)


# --------------------------------------------------------------------------
# training: AdamW on parameters stored in the configuration's type
# --------------------------------------------------------------------------

def train(spec: Spec, params: Dict[str, torch.Tensor],
          stored: Dict[str, torch.dtype],
          batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
          hyper: Dict, initial: Callable[[str], torch.Tensor],
          quant: Optional[str] = None) -> Dict:
    """``common.train`` on this model's loss (its next-token loss plus
    the MoE aux loss)."""
    return common.train(
        lambda p, tokens, labels: loss(spec, p, tokens, labels, quant),
        params, stored, batches, hyper, initial)
