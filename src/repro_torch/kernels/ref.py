"""Plain PyTorch oracles (the ground truth in kernel tests)."""
from __future__ import annotations

import torch

from . import cast


def matmul_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """float32 product over all of K, then one (saturating) cast back to
    the operand dtype."""
    return cast(torch.matmul(x.float(), y.float()), x.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, scale=None) -> torch.Tensor:
    """Softmax attention over the whole sequence in float32.
    q: (H, Sq, d), k/v: (H, Skv, d)."""
    sq, d = q.shape[1], q.shape[2]
    skv = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("hqd,hkd->hqk", q.float() * scale, k.float())
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(skv, device=q.device)[None, :])
        logits = torch.where(mask[None], logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, v.float()).to(q.dtype)


def mamba_scan_ref(x, dt, b, c, a_log_neg, d_skip) -> torch.Tensor:
    """Sequential oracle of the selective-scan recurrence.
    x, dt: (B, L, D); b, c: (B, L, N); a_log_neg: (D, N); d_skip: (D,)."""
    bsz, length, dim = x.shape
    xf, dtf, bf, cf = (t.float() for t in (x, dt, b, c))
    h = torch.zeros((bsz, dim, b.shape[-1]), device=x.device)
    ys = []
    for t in range(length):
        decay = torch.exp(dtf[:, t, :, None] * a_log_neg[None])
        h = decay * h + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
        ys.append((h * cf[:, t, None, :]).sum(dim=-1)
                  + d_skip[None] * xf[:, t])
    return torch.stack(ys, dim=1).to(x.dtype)
