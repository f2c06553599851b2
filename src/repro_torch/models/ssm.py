"""Selective state-space blocks: Mamba-1 (falcon-mamba) and Mamba-2
(zamba2), the counterpart of ``repro/models/ssm.py``.

Both reduce to the diagonal linear recurrence

    h_t = a_t * h_{t-1} + b_t ,   y_t = <C_t, h_t> + D * x_t

with per-(channel, state) decay `a_t` (Mamba-1) or per-head scalar decay
(Mamba-2).  The scan is chunked: chunks in order carrying the state, and
inside each chunk a log-step (Hillis–Steele) inclusive scan in place of the
reference's ``lax.associative_scan``.  The two round differently, so the
port equals the reference at a tolerance, not bit for bit.  Decode carries
(conv_state, ssm_state) and is O(1)/token.

Mamba-1's training forward on the card (CUDA bfloat16, no cache) runs the
scan as one fused op instead (``kernels/selective_scan_train``: softplus,
recurrence, D skip and SiLU gate, with its backward), which never builds a
(B, L, d_inner, N) tensor; the chunked scan stays its twin everywhere else.
Falcon-Mamba's weightless RMS norms of the Delta input, B and C
(``ModelConfig.mixer_rms_eps``) sit between x_proj and the scan on both.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from ..dist.api import constrain, is_dtensor
from ..kernels.selective_scan_train import STATES as SCAN_STATES
from ..kernels.selective_scan_train import selective_scan
from ..runtime import trace
from .config import ModelConfig
from .layers import Init, dense_init


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, d_inner) rolling conv window
    state: torch.Tensor  # (B, d_inner, N) or (B, H, P, N) recurrent state


# --------------------------------------------------------------------------
# shared: chunked diagonal linear recurrence
# --------------------------------------------------------------------------

def _pad_seq(t: torch.Tensor, pad: int, value: float) -> torch.Tensor:
    """Pad axis 1 of ``t`` at its end by ``pad`` entries of ``value``."""
    widths = [0, 0] * (t.dim() - 2) + [0, pad]
    return F.pad(t, widths, value=value)


def _inclusive_scan(a: torch.Tensor, b: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefix composition along axis 1 of h -> a*h + b: returns (a_cum,
    b_cum) with h_t = a_cum_t * h_in + b_cum_t.  Hillis–Steele: log2(len)
    steps, each combining every entry with the one ``off`` before it."""
    n = a.shape[1]
    off = 1
    while off < n:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        a_cur, b_cur = a[:, off:], b[:, off:]
        a = torch.cat([a[:, :off], a_cur * a_prev], dim=1)
        b = torch.cat([b[:, :off], a_cur * b_prev + b_cur], dim=1)
        off *= 2
    return a, b


def _chunks(t: torch.Tensor, n_chunks: int, chunk: int) -> torch.Tensor:
    return t.reshape((t.shape[0], n_chunks, chunk) + tuple(t.shape[2:]))


def chunked_linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                        chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t ⊙ h_{t-1} + b_t along axis 1 (seq).

    a, b: (B, L, ...) broadcast-compatible; h0: (B, ...).
    Returns (h_all: (B, L, ...), h_last: (B, ...)).
    """
    B, L = b.shape[0], b.shape[1]
    chunk = max(1, min(chunk, L))
    n_chunks = -(-L // chunk)
    pad = n_chunks * chunk - L
    if pad:
        a = _pad_seq(a, pad, 1.0)
        b = _pad_seq(b, pad, 0.0)
    a = _chunks(a, n_chunks, chunk)
    b = _chunks(b, n_chunks, chunk)

    h = h0
    outs = []
    for i in range(n_chunks):
        a_cum, b_cum = _inclusive_scan(a[:, i], b[:, i])
        h_all = a_cum * h[:, None] + b_cum
        outs.append(h_all)
        h = h_all[:, -1]
    h_all = torch.cat(outs, dim=1)
    return h_all[:, :L], h


def chunked_selective_scan(a: torch.Tensor, b: torch.Tensor,
                           c: torch.Tensor, h0: torch.Tensor, chunk: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like chunked_linear_scan but contracts the state against C inside
    each chunk: y_t = <h_t, C_t> over the trailing state dim.  The full
    h_all (B, L, ..., N) is never materialized — only per-chunk transients.

    a, b: (B, L, ..., N); c: (B, L, N); h0: (B, ..., N).
    Returns (y: (B, L, ...), h_last)."""
    B, L = b.shape[0], b.shape[1]
    chunk = max(1, min(chunk, L))
    n_chunks = -(-L // chunk)
    pad = n_chunks * chunk - L
    if pad:
        a = _pad_seq(a, pad, 1.0)
        b = _pad_seq(b, pad, 0.0)
        c = _pad_seq(c, pad, 0.0)
    a = _chunks(a, n_chunks, chunk)
    b = _chunks(b, n_chunks, chunk)
    c = _chunks(c, n_chunks, chunk)

    h = h0
    ys = []
    for i in range(n_chunks):
        a_cum, b_cum = _inclusive_scan(a[:, i], b[:, i])
        h_all = a_cum * h[:, None] + b_cum          # transient (chunk-local)
        ys.append(torch.einsum("bl...n,bln->bl...", h_all, c[:, i]))
        h = h_all[:, -1]
    y = torch.cat(ys, dim=1)
    return y[:, :L], h


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  prev: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x: (B, L, D); w: (K, D); prev: (B, K-1, D).
    Returns (y, new_prev)."""
    K = w.shape[0]
    if prev is None:
        prev = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([prev, x], dim=1)
    # windowed sum: y[t] = sum_k w[k] * xp[t + k]
    y = sum(xp[:, k:k + x.shape[1], :] * w[k] for k in range(K))
    new_prev = xp[:, xp.shape[1] - (K - 1):, :] if K > 1 else prev
    return y + bias, new_prev


# --------------------------------------------------------------------------
# Mamba-1 (falcon-mamba-7b)
# --------------------------------------------------------------------------

def mamba1_init(init: Init, cfg: ModelConfig, lead: Tuple[int, ...] = ()
                ) -> Dict:
    d, di, ns, r = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dtr
    dt = cfg.torch_dtype
    a = torch.arange(1, ns + 1, dtype=torch.float32, device=init.device)
    return {
        "in_proj": dense_init(init, d, 2 * di, dt, lead=lead),
        "conv_w": init.normal(lead + (cfg.d_conv, di), 0.1, dt),
        "conv_b": init.full(lead + (di,), 0.0, dt),
        "x_proj": dense_init(init, di, r + 2 * ns, dt, lead=lead),
        "dt_proj": dense_init(init, r, di, dt, lead=lead),
        "dt_bias": init.full(lead + (di,), 0.0, dt),
        "A_log": torch.log(a).expand(lead + (di, ns)).clone(),  # fp32
        "D": init.full(lead + (di,), 1.0, torch.float32),
        "out_proj": dense_init(init, di, d, dt, lead=lead),
    }


def _takes_kernel(x: torch.Tensor, cfg: ModelConfig,
                  cache: Optional[SSMCache]) -> bool:
    """Whether :func:`mamba1_block` runs the scan through the hand-written
    op: the training forward (no cache) of a CUDA bfloat16 input with
    memory behind it (a dry run's fake tensors and sharded DTensors keep
    the twin) at an instantiated state size."""
    return (cache is None and x.is_cuda and x.dtype == torch.bfloat16
            and cfg.ssm_state in SCAN_STATES and not is_fake(x)
            and not is_dtensor(x))


def mixer_rms(t: torch.Tensor, eps: float) -> torch.Tensor:
    """Falcon-Mamba's weightless RMS normalisation over the last axis, in
    float32, cast back to ``t``'s dtype."""
    tf = t.float()
    return (tf * torch.rsqrt(tf.pow(2).mean(-1, keepdim=True) + eps)
            ).to(t.dtype)


def mamba1_block(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                 cache: Optional[SSMCache] = None
                 ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """x: (B, L, D) -> (B, L, D); cache makes it a stateful step.

    The scan runs through the fused op of ``kernels/selective_scan_train``
    ("op") where :func:`_takes_kernel` allows, else through the twin of
    the reference's scan ("chunked": a, b built at (B, L, d_inner, N)
    float32, :func:`chunked_selective_scan`).  With ``cfg.mixer_rms_eps``
    set, the Delta input, B and C are RMS-normalised after x_proj
    (Falcon-Mamba)."""
    B, L, _ = x.shape
    di, ns, r = cfg.d_inner, cfg.ssm_state, cfg.dtr
    impl = "op" if _takes_kernel(x, cfg, cache) else "chunked"
    with trace.span("ssm.in_proj"):
        xz = x @ params["in_proj"]
        xin, z = torch.chunk(xz, 2, dim=-1)

    with trace.span("ssm.conv"):
        prev = cache.conv if cache is not None else None
        xin, new_conv = causal_conv1d(xin, params["conv_w"],
                                      params["conv_b"], prev)
        xin = constrain(F.silu(xin), ("batch", None, "inner"))

    with trace.span("ssm.xproj"):
        # summed over the 'inner' ranks before the split: a pending sum
        # would reach dt_proj, whose 'inner'-sharded weight would then be
        # gathered and the dt and scan work replicated on every rank
        dbc = constrain(xin @ params["x_proj"], ("batch", None, None))
        dt, Bmat, Cmat = torch.split(dbc, [r, ns, ns], dim=-1)
        if cfg.mixer_rms_eps is not None:
            dt, Bmat, Cmat = (mixer_rms(t, cfg.mixer_rms_eps)
                              for t in (dt, Bmat, Cmat))
        dt = dt @ params["dt_proj"]                              # (B,L,di)
    A = -torch.exp(params["A_log"])                              # (di,ns)

    with trace.span("ssm.scan", attrs={"impl": impl, "L": L, "d_inner": di,
                                       "N": ns}):
        if impl == "op":
            trace.count("ssm.kernel_calls", 1)
            y = selective_scan(xin, dt, A, Bmat, Cmat, params["D"], z,
                               params["dt_bias"].float())
            h_last = None
        else:
            dt = F.softplus(dt + params["dt_bias"])
            dtf = dt.float()
            a = torch.exp(dtf[..., None] * A[None, None])         # (B,L,di,ns)
            b = (dtf * xin.float())[..., None] \
                * Bmat.float()[:, :, None, :]                     # (B,L,di,ns)
            a = constrain(a, ("batch", None, "inner", None))
            b = constrain(b, ("batch", None, "inner", None))

            h0 = (cache.state if cache is not None
                  else torch.zeros((B, di, ns), dtype=torch.float32,
                                   device=x.device))
            y, h_last = chunked_selective_scan(a, b, Cmat.float(), h0,
                                               cfg.ssm_chunk)     # (B,L,di)
            y = constrain(y, ("batch", None, "inner"))
            y = (y + params["D"][None, None] * xin.float()).to(x.dtype)
            y = y * F.silu(z)
    with trace.span("ssm.out_proj"):
        out = y @ params["out_proj"]
    new_cache = (SSMCache(conv=new_conv, state=h_last)
                 if cache is not None else None)
    return out, new_cache


# --------------------------------------------------------------------------
# Mamba-2 (zamba2): per-head scalar decay, B/C shared across head dims
# --------------------------------------------------------------------------

def mamba2_init(init: Init, cfg: ModelConfig, lead: Tuple[int, ...] = ()
                ) -> Dict:
    d, di, ns = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H = cfg.n_ssm_heads
    dt = cfg.torch_dtype
    return {
        "in_proj": dense_init(init, d, 2 * di, dt, lead=lead),
        "bc_proj": dense_init(init, d, 2 * ns, dt, lead=lead),
        "dt_proj": dense_init(init, d, H, dt, lead=lead),
        "dt_bias": init.full(lead + (H,), 0.0, dt),
        "conv_w": init.normal(lead + (cfg.d_conv, di), 0.1, dt),
        "conv_b": init.full(lead + (di,), 0.0, dt),
        "A_log": init.full(lead + (H,), 0.0, torch.float32),
        "D": init.full(lead + (H,), 1.0, torch.float32),
        "out_proj": dense_init(init, di, d, dt, lead=lead),
    }


def mamba2_block(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                 cache: Optional[SSMCache] = None
                 ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    B, L, _ = x.shape
    di, ns = cfg.d_inner, cfg.ssm_state
    H, P = cfg.n_ssm_heads, cfg.mamba2_headdim

    xz = x @ params["in_proj"]
    xin, z = torch.chunk(xz, 2, dim=-1)
    prev = cache.conv if cache is not None else None
    xin, new_conv = causal_conv1d(xin, params["conv_w"], params["conv_b"],
                                  prev)
    xin = constrain(F.silu(xin), ("batch", None, "inner"))

    bc = x @ params["bc_proj"]
    Bmat, Cmat = torch.chunk(bc, 2, dim=-1)                      # (B,L,ns)
    dt = F.softplus(x @ params["dt_proj"] + params["dt_bias"])   # (B,L,H)
    A = -torch.exp(params["A_log"])                              # (H,)

    xh = xin.reshape(B, L, H, P).float()
    dtf = dt.float()
    a = torch.exp(dtf * A[None, None])[..., None, None]          # (B,L,H,1,1)
    b = (dtf[..., None, None] * xh[..., :, None]
         * Bmat.float()[:, :, None, None, :])                    # (B,L,H,P,ns)
    b = constrain(b, ("batch", None, "inner", None, None))

    h0 = (cache.state if cache is not None
          else torch.zeros((B, H, P, ns), dtype=torch.float32,
                           device=x.device))
    y, h_last = chunked_selective_scan(a, b, Cmat.float(), h0,
                                       cfg.ssm_chunk)            # (B,L,H,P)
    y = constrain(y, ("batch", None, "inner", None))
    y = y + params["D"][None, None, :, None] * xh
    y = y.reshape(B, L, di).to(x.dtype) * F.silu(z)
    out = y @ params["out_proj"]
    new_cache = (SSMCache(conv=new_conv, state=h_last)
                 if cache is not None else None)
    return out, new_cache


def init_ssm_cache(batch: int, cfg: ModelConfig, device,
                   lead: Tuple[int, ...] = ()) -> SSMCache:
    if cfg.block == "mamba1":
        shp = (batch, cfg.d_inner, cfg.ssm_state)
    else:
        shp = (batch, cfg.n_ssm_heads, cfg.mamba2_headdim, cfg.ssm_state)
    state = torch.zeros(lead + shp, dtype=torch.float32, device=device)
    conv = torch.zeros(lead + (batch, cfg.d_conv - 1, cfg.d_inner),
                       dtype=cfg.torch_dtype, device=device)
    return SSMCache(conv=conv, state=state)
