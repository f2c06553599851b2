"""A plain float32 reference of the program's Mamba-1 stack, as
``mamba1_block`` (``repro_torch/models/ssm.py``) computes it: RMSNorm,
in_proj, a causal depthwise convolution, SiLU, x_proj, softplus of
dt_proj, then the selective scan h_t = exp(dt_t A) h_(t-1) +
dt_t x_t B_t, y_t = <h_t, C_t> + D x_t, run token by token, gated by
SiLU(z) and projected out.  A fixture of the harness's test that adds a
model family, not a published model's reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import common
from .common import mm


@dataclasses.dataclass(frozen=True)
class Spec:
    n_layers: int
    d_inner: int
    state: int
    conv: int
    dt_rank: int
    vocab: int
    norm_eps: float
    tie_embeddings: bool

    @classmethod
    def from_config(cls, conf: Dict) -> "Spec":
        return cls(n_layers=conf["num_hidden_layers"],
                   d_inner=conf["intermediate_size"],
                   state=conf["state_size"], conv=conf["conv_kernel"],
                   dt_rank=conf["time_step_rank"], vocab=conf["vocab_size"],
                   norm_eps=conf["rms_norm_eps"],
                   tie_embeddings=conf["tie_word_embeddings"])


def rmsnorm(spec: Spec, x: torch.Tensor, scale: torch.Tensor
            ) -> torch.Tensor:
    return x / torch.sqrt((x * x).mean(-1, keepdim=True)
                          + spec.norm_eps) * scale


def mixer(spec: Spec, x: torch.Tensor, p: Dict[str, torch.Tensor],
          quant: Optional[str]) -> torch.Tensor:
    s = x.shape[1]
    xin, z = mm(x, p["in_proj"], quant).chunk(2, -1)
    xp = F.pad(xin, (0, 0, spec.conv - 1, 0))
    xin = F.silu(sum(xp[:, i:i + s] * p["conv_w"][i]
                     for i in range(spec.conv)) + p["conv_b"])
    dt, b, c = mm(xin, p["x_proj"], quant).split(
        [spec.dt_rank, spec.state, spec.state], -1)
    dt = F.softplus(mm(dt, p["dt_proj"], quant) + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    h = x.new_zeros(x.shape[0], spec.d_inner, spec.state)
    ys = []
    for t in range(s):
        h = torch.exp(dt[:, t, :, None] * a) * h \
            + (dt[:, t] * xin[:, t])[..., None] * b[:, t, None, :]
        ys.append((h * c[:, t, None, :]).sum(-1))
    y = torch.stack(ys, 1) + p["D"] * xin
    return mm(y * F.silu(z), p["out_proj"], quant)


def logits(spec: Spec, params: Dict[str, torch.Tensor],
           tokens: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    x = params["embed"][tokens]
    m = "stack/layers/mamba/"
    for i in range(spec.n_layers):
        p = {k[len(m):]: v[i] for k, v in params.items()
             if k.startswith(m)}
        x = x + mixer(spec, rmsnorm(spec, x, params["stack/layers/ln1"][i]),
                      p, quant)
    x = rmsnorm(spec, x, params["ln_f"])
    head = (params["embed"][:spec.vocab].T if spec.tie_embeddings
            else params["unembed"][:, :spec.vocab])
    return mm(x, head, quant)


def loss(spec: Spec, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
         labels: torch.Tensor, quant: Optional[str] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    out = logits(spec, params, tokens, quant)
    nll = F.cross_entropy(out.reshape(-1, spec.vocab),
                          labels.reshape(-1).long())
    return nll, nll


def train(spec: Spec, params: Dict[str, torch.Tensor],
          stored: Dict[str, torch.dtype],
          batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
          hyper: Dict, initial: Callable[[str], torch.Tensor],
          quant: Optional[str] = None) -> Dict:
    return common.train(
        lambda p, tokens, labels: loss(spec, p, tokens, labels, quant),
        params, stored, batches, hyper, initial)
