"""Composable primitive layers (pure functions over param dicts of tensors),
the counterpart of ``repro/models/layers.py``.

The reference threads a ``jax.random`` key through its inits and stacks
per-layer params with ``vmap``; here an :class:`Init` carries a
``torch.Generator`` and the device, and a stacked leaf is drawn at its
stacked shape (``lead`` is the stacking prefix, e.g. ``(n_layers,)``).  The
draws cannot replay ``jax.random``: parity checks convert the reference's
params instead (``repro_torch.core.convert.params_from_numpy``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


class Init:
    """The source of ``init_params``' draws: standard normals from
    ``generator`` on ``device``.  On the ``meta`` device (generator
    ``None``) nothing is drawn and the params are shapes and dtypes only."""

    def __init__(self, generator: Optional[torch.Generator],
                 device: torch.device):
        self.generator = generator
        self.device = torch.device(device)

    def normal(self, shape: Sequence[int], scale: float, dtype
               ) -> torch.Tensor:
        z = torch.randn(tuple(shape), generator=self.generator,
                        device=self.device)
        return (z * scale).to(dtype)

    def full(self, shape: Sequence[int], value: float, dtype
             ) -> torch.Tensor:
        return torch.full(tuple(shape), value, dtype=dtype,
                          device=self.device)


def dense_init(init: Init, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None, lead: Tuple[int, ...] = ()
               ) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    return init.normal(lead + (d_in, d_out), scale, dtype)


def rmsnorm_init(init: Init, d: int, dtype, lead: Tuple[int, ...] = ()
                 ) -> torch.Tensor:
    return init.full(lead + (d,), 1.0, dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layernorm_init(init: Init, d: int, dtype, lead: Tuple[int, ...] = ()
                   ) -> Dict[str, torch.Tensor]:
    return {"scale": init.full(lead + (d,), 1.0, dtype),
            "bias": init.full(lead + (d,), 0.0, dtype)}


def layernorm(x: torch.Tensor, p: Dict[str, torch.Tensor], eps: float = 1e-5
              ) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)  # population
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def norm_init(kind: str, init: Init, d: int, dtype,
              lead: Tuple[int, ...] = ()):
    return rmsnorm_init(init, d, dtype, lead) if kind == "rmsnorm" \
        else layernorm_init(init, d, dtype, lead)


def apply_norm(kind: str, x, p):
    return rmsnorm(x, p) if kind == "rmsnorm" else layernorm(x, p)


def activate(kind: str, gate: torch.Tensor,
             up: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gated (swiglu/geglu need `up`) or plain activations."""
    if kind == "swiglu":
        return F.silu(gate) * up
    if kind == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    if kind == "gelu":
        return F.gelu(gate, approximate="tanh")
    if kind == "relu2":
        r = F.relu(gate)
        return r * r
    raise ValueError(kind)


def is_gated(kind: str) -> bool:
    return kind in ("swiglu", "geglu")


# --------------------------------------------------------------------------
# Rotary position embeddings — full / partial (stablelm) / 2d (chatglm)
# --------------------------------------------------------------------------

def _rope_angles(positions: torch.Tensor, dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs         # (..., dim/2)
    return torch.cos(ang), torch.sin(ang)


def _rotate_half_pairs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                       ) -> torch.Tensor:
    # x: (..., dim) with pairs (x0, x1) interleaved as [even, odd] halves
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, mode: str,
               fraction: float = 1.0, theta: float = 10000.0
               ) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,).

    mode 'full'    — rotate the whole head_dim
    mode 'partial' — rotate the first `fraction` of head_dim (StableLM)
    mode '2d'      — ChatGLM RoPE-2d: rotate the first half with position ids
                     and the second half with the same ids (block ids equal
                     position ids for standard causal LM usage)
    mode 'none'    — identity
    """
    if mode == "none":
        return x
    hd = x.shape[-1]
    if mode == "full":
        rot = hd
    elif mode == "partial":
        rot = max(2, int(hd * fraction) // 2 * 2)
    elif mode == "2d":
        rot = hd // 2
    else:
        raise ValueError(mode)
    if positions.dim() == 1:
        positions = positions[None, :]
    cos, sin = _rope_angles(positions, rot, theta)     # (B, S, rot/2)
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    x_rot = _rotate_half_pairs(x[..., :rot], cos, sin)
    if mode == "2d":
        upper = _rotate_half_pairs(x[..., rot:2 * rot], cos, sin)
        return torch.cat([x_rot, upper, x[..., 2 * rot:]], dim=-1)
    return torch.cat([x_rot, x[..., rot:]], dim=-1)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(logits / cap)
    return logits
