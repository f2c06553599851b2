"""Plain PyTorch reference of the mamba1 family
(``perfbench/families/mamba1.py``): Falcon-Mamba's stack written from its
published equations (arXiv:2410.05355; HF transformers' ``FalconMambaMixer``)
in float32 with TF32 off, with no kernel, cache or batching of the program
under test.  It imports nothing of the program.

A layer is x + mixer(RMSNorm(x)); the mixer projects to (x, z), runs a
causal depthwise convolution (an explicit windowed sum) and SiLU, projects
x to (Delta input, B, C), normalises each of the three by a weightless RMS
norm, takes Delta = softplus(dt_proj(Delta input) + dt_bias), and scans

    h_t = exp(Delta_t A) h_{t-1} + Delta_t x_t B_t,   y_t = <h_t, C_t> + D x_t

one position at a time, then gates y by SiLU(z) and projects it out.  The
gradients come from autograd through that sequential recurrence, not from
a hand-written adjoint.

Memory is bounded by blocks, not by a smaller problem: the layer stack
keeps only each layer's input and recomputes one layer at a time in the
backward, writing its parameters' gradients into the stacked gradients
at once (``_Stack``); a layer keeps only the boundaries of its stages
around the scan (each checkpointed); the scan's time loop runs in
segments of ``SEGMENT`` positions, each checkpointed, so that only the
states at segment ends are kept and a segment's (batch, SEGMENT,
d_inner, N) decays and states live one segment at a time; the loss runs
over blocks of rows.  ``quant="fp8"`` takes every matrix product's
operands through float8 e4m3 (``common.mm``), the control.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import common
from .common import mm

SEGMENT = 128
LAYERS = "stack/layers/"
MIXER = LAYERS + "mamba/"


@dataclasses.dataclass(frozen=True)
class Spec:
    """The sizes the reference needs, read from a configuration file."""
    n_layers: int
    d_inner: int
    state: int
    conv: int
    dt_rank: int
    vocab: int
    norm_eps: float
    mixer_eps: float
    tie_embeddings: bool

    @classmethod
    def from_config(cls, conf: Dict) -> "Spec":
        """The sizes as the program runs them: ``as_run`` over the
        published values."""
        conf = {**conf, **conf.get("as_run", {})}
        return cls(n_layers=conf["num_hidden_layers"],
                   d_inner=conf["intermediate_size"],
                   state=conf["state_size"], conv=conf["conv_kernel"],
                   dt_rank=conf["time_step_rank"], vocab=conf["vocab_size"],
                   norm_eps=conf["rms_norm_eps"],
                   mixer_eps=conf["mixer_rms_eps"],
                   tie_embeddings=conf["tie_word_embeddings"])


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
            ) -> torch.Tensor:
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _segment(h: torch.Tensor, dt: torch.Tensor, x: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, a: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence over one segment from state h (batch, d_inner, N):
    returns y (batch, seg, d_inner) without the D term, and the last
    state."""
    decay = torch.exp(dt[..., None] * a)                      # (B, s, di, N)
    drive = (dt * x)[..., None] * b[:, :, None, :]            # (B, s, di, N)
    states = []
    for d_t, u_t in zip(decay.unbind(1), drive.unbind(1)):
        h = torch.addcmul(u_t, d_t, h)                        # d_t h + u_t
        states.append(h)
    y = (torch.stack(states, 1) * c[:, :, None, :]).sum(-1)
    return y, h


def scan(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
         c: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """y_t = <h_t, C_t> over the whole sequence, a segment at a time."""
    h = dt.new_zeros(dt.shape[0], dt.shape[2], a.shape[1])
    ys = []
    for t0 in range(0, dt.shape[1], SEGMENT):
        part = [t[:, t0:t0 + SEGMENT] for t in (dt, x, b, c)]
        if torch.is_grad_enabled():
            y, h = checkpoint(_segment, h, *part, a, use_reentrant=False)
        else:
            y, h = _segment(h, *part, a)
        ys.append(y)
    return torch.cat(ys, 1)


def _before_scan(spec: Spec, h: torch.Tensor, in_proj: torch.Tensor,
                 conv_w: torch.Tensor, conv_b: torch.Tensor,
                 x_proj: torch.Tensor, dt_proj: torch.Tensor,
                 dt_bias: torch.Tensor, quant: Optional[str]):
    """in_proj, the causal conv and SiLU, x_proj, the mixer norms and
    Delta: returns (Delta, x, B, C, z)."""
    s, n = h.shape[1], spec.state
    xin, z = mm(h, in_proj, quant).chunk(2, -1)
    xp = F.pad(xin, (0, 0, spec.conv - 1, 0))
    xin = F.silu(sum(xp[:, k:k + s] * conv_w[k] for k in range(spec.conv))
                 + conv_b)
    dt, b, c = mm(xin, x_proj, quant).split([spec.dt_rank, n, n], -1)
    dt, b, c = (t / torch.sqrt((t * t).mean(-1, keepdim=True)
                               + spec.mixer_eps) for t in (dt, b, c))
    dt = F.softplus(mm(dt, dt_proj, quant) + dt_bias)
    return dt, xin, b, c, z.contiguous()


def _after_scan(y: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                d: torch.Tensor, out_proj: torch.Tensor,
                quant: Optional[str]) -> torch.Tensor:
    return mm((y + d * x) * F.silu(z), out_proj, quant)


def mixer(spec: Spec, x: torch.Tensor, p: Dict[str, torch.Tensor],
          quant: Optional[str]) -> torch.Tensor:
    """The mixer in three stages, the two around the scan checkpointed
    under autograd, so that a layer keeps only their boundaries."""
    def run(fn, *args):
        if torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    dt, xin, b, c, z = run(_before_scan, spec, x, p["in_proj"],
                           p["conv_w"], p["conv_b"], p["x_proj"],
                           p["dt_proj"], p["dt_bias"], quant)
    y = scan(dt, xin, b, c, -torch.exp(p["A_log"]))
    return run(_after_scan, y, xin, z, p["D"], p["out_proj"], quant)


def layer(spec: Spec, x: torch.Tensor, p: Dict[str, torch.Tensor],
          quant: Optional[str]) -> torch.Tensor:
    return x + mixer(spec, rmsnorm(x, p["ln1"], spec.norm_eps), p, quant)


def _stacked(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The stacked (per-layer) leaves, by the name a layer uses."""
    out = {path[len(MIXER):]: leaf for path, leaf in params.items()
           if path.startswith(MIXER)}
    out["ln1"] = params[LAYERS + "ln1"]
    return out


class _Stack(torch.autograd.Function):
    """The layer stack, differentiable in its input and in every stacked
    leaf.  The forward keeps each layer's input; the backward recomputes
    one layer at a time under autograd and writes its parameters' gradients
    into gradients of the stacked leaves allocated once, so that a layer's
    activations and parameter gradients never outlive it (and no small
    long-lived gradient splits the memory the large ones need)."""

    @staticmethod
    def forward(ctx, spec, quant, names, x, *stacked):
        inputs = []
        for i in range(spec.n_layers):
            inputs.append(x)
            x = layer(spec, x, {n: s[i] for n, s in zip(names, stacked)},
                      quant)
        ctx.spec, ctx.quant, ctx.names = spec, quant, names
        ctx.save_for_backward(*inputs, *stacked)
        return x

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        n = ctx.spec.n_layers
        inputs, stacked = saved[:n], saved[n:]
        torch.cuda.empty_cache()
        grads = [torch.empty_like(s) for s in stacked]
        for i in reversed(range(n)):
            with torch.enable_grad():
                x = inputs[i].detach().requires_grad_()
                p = [s[i].detach().requires_grad_() for s in stacked]
                out = layer(ctx.spec, x, dict(zip(ctx.names, p)), ctx.quant)
                g = torch.autograd.grad(out, [x] + p, dy)
            dy = g[0]
            for acc, gk in zip(grads, g[1:]):
                acc[i] = gk
            del out, g
        return (None, None, None, dy, *grads)


def hidden(spec: Spec, params: Dict[str, torch.Tensor],
           tokens: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """The final-normed hidden states (B, S, D)."""
    x = params["embed"][tokens]
    stacked = _stacked(params)
    names = tuple(stacked)
    if torch.is_grad_enabled():
        x = _Stack.apply(spec, quant, names, x,
                         *(stacked[n] for n in names))
    else:
        for i in range(spec.n_layers):
            x = layer(spec, x, {n: stacked[n][i] for n in names}, quant)
    return rmsnorm(x, params["ln_f"], spec.norm_eps)


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
    """(the mean next-token loss, the same): the family has no aux loss."""
    common.no_tf32()
    h = hidden(spec, params, tokens, quant)
    h = h.reshape(-1, h.shape[-1])
    labels = labels.reshape(-1).long()
    head = _head(spec, params)
    total = torch.zeros((), device=h.device)
    for r in range(0, h.shape[0], rows):
        total = total + checkpoint(_nll_sum, h[r:r + rows], head,
                                   labels[r:r + rows], quant,
                                   use_reentrant=False)
    nll = total / h.shape[0]
    return nll, nll


@torch.no_grad()
def logits_at(spec: Spec, params: Dict[str, torch.Tensor],
              tokens: torch.Tensor, first: int,
              quant: Optional[str] = None) -> torch.Tensor:
    """Logits (n, vocab) of one sequence ``tokens`` (S,) at positions
    ``first`` .. S-1."""
    common.no_tf32()
    h = hidden(spec, params, tokens[None], quant)
    return mm(h[0, first:], _head(spec, params), quant)


def train(spec: Spec, params: Dict[str, torch.Tensor],
          stored: Dict[str, torch.dtype],
          batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
          hyper: Dict, initial: Callable[[str], torch.Tensor],
          quant: Optional[str] = None) -> Dict:
    """``common.train`` on this model's next-token loss."""
    return common.train(
        lambda p, tokens, labels: loss(spec, p, tokens, labels, quant),
        params, stored, batches, hyper, initial)
