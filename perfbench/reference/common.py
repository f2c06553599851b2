"""What every plain reference of the benchmark shares, whatever its model
family: float32 products with TF32 off, the float8 control's products,
and AdamW training over a reference's loss.

Plain PyTorch; it imports nothing of the program, of JAX or of the
harness.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3fn

# (params, tokens, labels) -> (the loss the gradient is taken of, the
# mean next-token loss alone)
Loss = Callable[[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor],
                Tuple[torch.Tensor, torch.Tensor]]


def no_tf32() -> None:
    """Full float32 products: the card would otherwise be allowed TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --------------------------------------------------------------------------
# products, in float32 or through float8
# --------------------------------------------------------------------------

def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, as float32;
    the gradient passes straight through."""
    amax = x.detach().abs().amax().clamp(min=1e-12)
    scale = FP8_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32)
    return x + (q / scale - x.detach())


def mm(a: torch.Tensor, b: torch.Tensor, quant: Optional[str]
       ) -> torch.Tensor:
    if quant == "fp8":
        a, b = fake_fp8(a), fake_fp8(b)
    elif quant is not None:
        raise ValueError(quant)
    return a @ b


# --------------------------------------------------------------------------
# training: AdamW on parameters stored in the configuration's type
# --------------------------------------------------------------------------

def train(loss: Loss, params: Dict[str, torch.Tensor],
          stored: Dict[str, torch.dtype],
          batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
          hyper: Dict, initial: Callable[[str], torch.Tensor]) -> Dict:
    """Steps of AdamW with global-norm clipping from float32 ``params``
    (updated in place), on the gradient of ``loss``.  Every product,
    gradient and moment is float32; after each update a parameter is
    rounded to the type it is stored in (``stored``), as the
    configuration keeps it.  ``initial(path)`` gives a parameter's value
    before the first step, for the change.

    Returns each step's next-token loss (without an aux loss), each
    leaf's norm of the first step's
    clipped gradient, and each leaf's norm of its change over the steps.
    """
    no_tf32()
    names = list(params)
    for p in params.values():
        p.requires_grad_(True)
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    b1, b2, eps = hyper["b1"], hyper["b2"], hyper["eps"]
    lr, wd, clip = hyper["lr"], hyper["weight_decay"], hyper["clip"]
    losses, first_grad = [], {}
    for t, (tokens, labels) in enumerate(batches):
        with torch.enable_grad():
            total, nll = loss(params, tokens, labels)
            grads = torch.autograd.grad(total, [params[n] for n in names])
        losses.append(float(nll.detach()))
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
            bc1, bc2 = 1 - b1 ** (t + 1), 1 - b2 ** (t + 1)
            for n, g in zip(names, grads):
                if t == 0:
                    first_grad[n] = float(torch.linalg.vector_norm(g)
                                          * scale)
                # a stacked leaf a layer at a time, to bound the
                # temporaries
                for i in (range(g.shape[0]) if g.dim() > 2 else [...]):
                    gi = g[i] * scale
                    mi, vi, p = m[n][i], v[n][i], params[n][i]
                    mi.mul_(b1).add_(gi, alpha=1 - b1)
                    vi.mul_(b2).add_(gi * gi, alpha=1 - b2)
                    u = (mi / bc1) / (torch.sqrt(vi / bc2) + eps) + wd * p
                    p.sub_(lr * u)
                    p.copy_(p.to(stored[n]).float())
            del grads
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(params[n] - initial(n)))
                  for n in names}
    return {"losses": losses, "first_grad": first_grad, "change": change}
