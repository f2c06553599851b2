"""The mamba1 family: attention-free stacks of Mamba-1 mixers with
Falcon-Mamba's weightless RMS norms of the Delta input, B and C (the
program's ``mamba1`` block with ``mixer_rms_eps`` set), pre-norm RMSNorm
residual layers and an untied head.

What the harness knows of the architecture is here: the program block it
judges, the configuration keys checked against the program, the parameter
leaves and their starts, the model FLOPs, the selective scan's least bytes
(``scan_bytes``), its device time in a profile (``scan_ms``, which the
cell's scan metrics read) and the plain reference
(``perfbench/reference/mamba1.py``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from perfbench import weights
from perfbench.reference import mamba1 as reference  # noqa: F401

BLOCKS = ("mamba1",)

# configuration-file key -> the program's ModelConfig field
FIELDS = {
    "num_hidden_layers": "n_layers", "hidden_size": "d_model",
    "intermediate_size": "d_inner", "state_size": "ssm_state",
    "conv_kernel": "d_conv", "expand": "expand", "time_step_rank": "dtr",
    "vocab_size": "vocab", "norm": "norm", "mixer_rms_eps": "mixer_rms_eps",
    "tie_word_embeddings": "tie_embeddings", "torch_dtype": "dtype",
}
attention_flops = None

# Mamba's initial Delta (dt_init_floor aside): log-uniform in this range
DT_RANGE = (1e-3, 1e-1)


def check(conf: Dict, cfg) -> None:
    """Refuses what the reference does not compute."""
    if cfg.norm != "rmsnorm":
        raise ValueError(f"{conf['name']}: the mamba1 family judges RMSNorm "
                         "residual layers")
    if cfg.mixer_rms_eps is None:
        raise ValueError(f"{conf['name']}: the mamba1 family judges "
                         "Falcon-Mamba's mixer norms, which the program "
                         "runs without")


def s4d_real(g, shape, dtype, device) -> torch.Tensor:
    """A_log = log(1 .. N) along the state axis, as Mamba starts it (no
    draw)."""
    n = shape[-1]
    a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    return torch.log(a).expand(shape).clone().to(dtype)


def dt_bias(g, shape, dtype, device) -> torch.Tensor:
    """Mamba's Delta bias: Delta drawn log-uniform in ``DT_RANGE``, the
    bias its softplus inverse, Delta + log(-expm1(-Delta)), so the scan
    first carries its state over hundreds of positions."""
    lo, hi = math.log(DT_RANGE[0]), math.log(DT_RANGE[1])
    u = torch.rand(shape, generator=g, device=device, dtype=torch.float32)
    dt = torch.exp(lo + (hi - lo) * u)
    return (dt + torch.log(-torch.expm1(-dt))).to(dtype)


def leaves(conf: Dict, qk_gain: float = 1.0) -> List[weights.Leaf]:
    """The parameter leaves (``qk_gain`` has nothing to scale here)."""
    Leaf, f32 = weights.Leaf, weights.DTYPES["float32"]
    dt = weights.DTYPES[conf["torch_dtype"]]
    L, d, di = (conf["num_hidden_layers"], conf["hidden_size"],
                conf["intermediate_size"])
    n, k, r = conf["state_size"], conf["conv_kernel"], conf["time_step_rank"]
    vp = weights.vocab_stored(conf)
    m = "stack/layers/mamba/"
    out = [Leaf("embed", (vp, d), dt, "normal", d ** -0.5),
           Leaf("ln_f", (d,), dt, "ones"),
           Leaf("stack/layers/ln1", (L, d), dt, "ones"),
           Leaf(m + "A_log", (L, di, n), f32, s4d_real),
           Leaf(m + "D", (L, di), f32, "ones"),
           Leaf(m + "conv_b", (L, di), dt, "zeros"),
           Leaf(m + "conv_w", (L, k, di), dt, "normal", k ** -0.5),
           Leaf(m + "dt_bias", (L, di), dt, dt_bias),
           Leaf(m + "dt_proj", (L, r, di), dt, "normal", r ** -0.5),
           Leaf(m + "in_proj", (L, d, 2 * di), dt, "normal", d ** -0.5),
           Leaf(m + "out_proj", (L, di, d), dt, "normal", di ** -0.5),
           Leaf(m + "x_proj", (L, di, r + 2 * n), dt, "normal", di ** -0.5)]
    if not conf["tie_word_embeddings"]:
        out.append(Leaf("unembed", (d, vp), dt, "normal", d ** -0.5))
    return out


# Model FLOPs count each multiply-add of the model's matrix products as two
# operations: in_proj, x_proj, dt_proj and out_proj in every layer and the
# head over the published vocabulary.  The convolution, the norms, the
# scan's elementwise work, the embedding lookup and remat's replay count
# nothing.

def matmul_params(conf: Dict) -> int:
    """Weights a token multiplies through, embedding lookup excluded."""
    d, di = conf["hidden_size"], conf["intermediate_size"]
    n, r = conf["state_size"], conf["time_step_rank"]
    layer = d * 2 * di + di * (r + 2 * n) + r * di + di * d
    return conf["num_hidden_layers"] * layer + d * conf["vocab_size"]


def train_step_flops(conf: Dict, batch: int, seq: int) -> int:
    """Forward and backward (3x the forward) of one step."""
    return 6 * matmul_params(conf) * batch * seq


def serve_request_flops(conf: Dict, prompt: int, generated: int) -> int:
    """A prefill over the prompt and a pass for each generated token after
    the first (no attention: a pass costs the same at any position)."""
    return 2 * matmul_params(conf) * (prompt + generated - 1)


def scan_bytes(conf: Dict, batch: int, seq: int) -> int:
    """The least bytes the selective scan moves in one training step under
    remat, whatever implements it: each layer runs two forwards (the
    step's and the replay) and one backward.  A forward reads u, Delta's
    input and z (batch, seq, d_inner) and B, C (batch, seq, N) and writes
    y; a backward reads u, Delta's input, z, dy, B and C and writes du,
    dDelta, dz, dB and dC; each reads A (d_inner, N), D and Delta's bias
    (d_inner,) in float32, and the backward writes their gradients."""
    e = weights.DTYPES[conf["torch_dtype"]].itemsize
    tokens, di = batch * seq, conf["intermediate_size"]
    act = tokens * di * e                      # u, Delta's input, z, y, ...
    bc = tokens * conf["state_size"] * e       # B or C, or its gradient
    small = 4 * (di * conf["state_size"] + 2 * di)   # A, D, Delta's bias
    forward = 4 * act + 2 * bc + small
    backward = 7 * act + 4 * bc + 2 * small
    return conf["num_hidden_layers"] * (2 * forward + backward)


SCAN_OPS = "selective_scan_"


def scan_ms(obs: Dict) -> Optional[float]:
    """Device ms a training step of the operations named
    ``selective_scan_*`` among the profile's longest (``trace.TOP``), or
    None where the run was not profiled or ran none (the twin, or a
    program without the op)."""
    from perfbench.kinds.train import PROFILE_STEPS
    t = obs.get("trace")
    if not t:
        return None
    s = [sec for name, sec in t["device_ops"] if SCAN_OPS in name]
    return 1e3 * sum(s) / PROFILE_STEPS if s else None
