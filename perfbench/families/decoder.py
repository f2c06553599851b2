"""The decoder family: attention decoders whose layers hold causal
self-attention and a SwiGLU MLP or a mixture of SwiGLU experts, without
soft capping (the program's ``dense`` and ``moe`` blocks).

A configuration file that names no ``family`` is in this one.  What the
harness knows of the architecture is here: the program blocks it judges,
the configuration keys checked against the program, the parameter
leaves, the model FLOPs and the plain reference
(``perfbench/reference/model.py``).
"""
from __future__ import annotations

from typing import Dict, List

from perfbench import flops, weights
from perfbench.reference import model as reference  # noqa: F401

BLOCKS = ("dense", "moe")

# configuration-file key -> the program's ModelConfig field
FIELDS = {
    "num_hidden_layers": "n_layers", "hidden_size": "d_model",
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
    "head_dim": "hd", "intermediate_size": "d_ff", "vocab_size": "vocab",
    "norm": "norm", "partial_rotary_factor": "rope_fraction",
    "rope_theta": "rope_theta", "tie_word_embeddings": "tie_embeddings",
    "num_experts": "n_experts", "num_experts_per_tok": "top_k",
    "capacity_factor": "capacity_factor",
    "router_aux_loss_coef": "router_aux_coef", "torch_dtype": "dtype",
}

attention_flops = flops.attention_flops


def check(conf: Dict, cfg) -> None:
    """Refuses what the reference does not compute."""
    if cfg.act != "swiglu" or cfg.logit_softcap:
        raise ValueError(f"{conf['name']}: the decoder family judges SwiGLU "
                         "decoders without soft capping")


def leaves(conf: Dict, qk_gain: float = 1.0) -> List[weights.Leaf]:
    """The parameter leaves.  ``qk_gain`` multiplies the scale of the
    query and key projections, and so the spread of the attention logits
    by its square."""
    Leaf = weights.Leaf
    dt = weights.DTYPES[conf["torch_dtype"]]
    L, d = conf["num_hidden_layers"], conf["hidden_size"]
    nh, nkv, hd = (conf["num_attention_heads"], conf["num_key_value_heads"],
                   conf["head_dim"])
    f = conf["intermediate_size"]
    vp = weights.vocab_stored(conf)
    out = [Leaf("embed", (vp, d), dt, "normal", d ** -0.5)]

    def norm(path, lead):
        if conf["norm"] == "layernorm":
            out.extend([Leaf(path + "/bias", lead + (d,), dt, "zeros"),
                        Leaf(path + "/scale", lead + (d,), dt, "ones")])
        else:
            out.append(Leaf(path, lead + (d,), dt, "ones"))

    norm("ln_f", ())
    lay = "stack/layers/"
    out += [Leaf(lay + "attn/wq", (L, d, nh * hd), dt, "normal",
                 qk_gain * d ** -0.5),
            Leaf(lay + "attn/wk", (L, d, nkv * hd), dt, "normal",
                 qk_gain * d ** -0.5),
            Leaf(lay + "attn/wv", (L, d, nkv * hd), dt, "normal", d ** -0.5),
            Leaf(lay + "attn/wo", (L, nh * hd, d), dt, "normal",
                 (nh * hd) ** -0.5)]
    norm(lay + "ln1", (L,))
    norm(lay + "ln2", (L,))
    e = conf.get("num_experts", 0)
    if e:
        out += [Leaf(lay + "moe/router", (L, d, e), weights.DTYPES["float32"],
                     "normal", d ** -0.5),
                Leaf(lay + "moe/w_gate", (L, e, d, f), dt, "normal",
                     d ** -0.5),
                Leaf(lay + "moe/w_up", (L, e, d, f), dt, "normal", d ** -0.5),
                Leaf(lay + "moe/w_down", (L, e, f, d), dt, "normal",
                     f ** -0.5)]
    else:
        out += [Leaf(lay + "mlp/w_gate", (L, d, f), dt, "normal", d ** -0.5),
                Leaf(lay + "mlp/w_up", (L, d, f), dt, "normal", d ** -0.5),
                Leaf(lay + "mlp/w_down", (L, f, d), dt, "normal", f ** -0.5)]
    if not conf["tie_word_embeddings"]:
        out.append(Leaf("unembed", (d, vp), dt, "normal", d ** -0.5))
    return out


# Model FLOPs count each multiply-add of the model's matrix products as
# two operations: the projections and MLPs (for a mixture of experts the
# router and the ``top_k`` experts a token uses, not the capacity's
# padding), the output head over the published vocabulary, and causal
# attention (QK^T and PV over the keys at or before each query).  The
# embedding lookup, recomputation and padding count nothing.

def matmul_params(conf: Dict) -> int:
    """Weights a token multiplies through, embedding lookup excluded."""
    d, hd = conf["hidden_size"], conf["head_dim"]
    nh, nkv = conf["num_attention_heads"], conf["num_key_value_heads"]
    f, e = conf["intermediate_size"], conf.get("num_experts", 0)
    attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
    mlp = 3 * d * f
    ffn = d * e + conf["num_experts_per_tok"] * mlp if e else mlp
    return conf["num_hidden_layers"] * (attn + ffn) \
        + d * conf["vocab_size"]


def train_step_flops(conf: Dict, batch: int, seq: int) -> int:
    """Forward and backward (3x the forward) of one step."""
    fwd = 2 * matmul_params(conf) * batch * seq \
        + batch * attention_flops(conf, seq)
    return 3 * fwd


def serve_request_flops(conf: Dict, prompt: int, generated: int) -> int:
    """The forward passes one request needs: a prefill over its own
    prompt, then one pass for each generated token after the first, each
    attending over the request's own context."""
    n = 2 * matmul_params(conf)
    total = n * prompt + attention_flops(conf, prompt)
    for j in range(1, generated):
        total += n + attention_flops(conf, 1, prompt + j - 1)
    return total
