"""A model family for the program's ``mamba1`` block, as the harness's
own test adds one: new files only (this file, copied to
``perfbench/families/mamba1-tiny.py``, and its reference, copied to
``perfbench/reference/mamba1_tiny.py``).  A fixture of that test at the
smoke size, not falcon-mamba-7b's family."""
from __future__ import annotations

from typing import Dict, List

import torch

from perfbench import weights
from perfbench.reference import mamba1_tiny as reference  # noqa: F401

BLOCKS = ("mamba1",)
FIELDS = {
    "num_hidden_layers": "n_layers", "hidden_size": "d_model",
    "intermediate_size": "d_inner", "state_size": "ssm_state",
    "conv_kernel": "d_conv", "expand": "expand", "time_step_rank": "dtr",
    "vocab_size": "vocab", "norm": "norm",
    "tie_word_embeddings": "tie_embeddings", "torch_dtype": "dtype",
}
attention_flops = None


def check(conf: Dict, cfg) -> None:
    if cfg.norm != "rmsnorm":
        raise ValueError(f"{conf['name']}: the reference computes RMSNorm")


def s4d_real(g, shape, dtype, device) -> torch.Tensor:
    """A_log = log(1 .. N) along the state axis, as the program starts
    it (no draw)."""
    n = shape[-1]
    a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    return torch.log(a).expand(shape).clone().to(dtype)


def leaves(conf: Dict, qk_gain: float = 1.0) -> List[weights.Leaf]:
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
           Leaf(m + "conv_w", (L, k, di), dt, "normal", 0.1),
           Leaf(m + "dt_bias", (L, di), dt, "zeros"),
           Leaf(m + "dt_proj", (L, r, di), dt, "normal", r ** -0.5),
           Leaf(m + "in_proj", (L, d, 2 * di), dt, "normal", d ** -0.5),
           Leaf(m + "out_proj", (L, di, d), dt, "normal", di ** -0.5),
           Leaf(m + "x_proj", (L, di, r + 2 * n), dt, "normal", di ** -0.5)]
    if not conf["tie_word_embeddings"]:
        out.append(Leaf("unembed", (d, vp), dt, "normal", d ** -0.5))
    return out


def matmul_params(conf: Dict) -> int:
    """The projections' weights a token multiplies through, and the
    head's (the scan's elementwise work is not counted here)."""
    d, di = conf["hidden_size"], conf["intermediate_size"]
    n, r = conf["state_size"], conf["time_step_rank"]
    layer = d * 2 * di + di * (r + 2 * n) + r * di + di * d
    return conf["num_hidden_layers"] * layer + d * conf["vocab_size"]


def train_step_flops(conf: Dict, batch: int, seq: int) -> int:
    return 6 * matmul_params(conf) * batch * seq


def serve_request_flops(conf: Dict, prompt: int, generated: int) -> int:
    return 2 * matmul_params(conf) * (prompt + generated - 1)
