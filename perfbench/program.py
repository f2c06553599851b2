"""The one door to the program under test, ``repro_torch``.

The harness takes from the program its configuration registry, its
train step and optimizer, and its serving engine; nothing else.  Each
configuration file names the program's architecture and the fields it
changes there, and every size the file states is checked against the
program's configuration before a run, so the two cannot drift apart.
"""
from __future__ import annotations

import pathlib
import sys
from typing import Dict

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"

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


def _import():
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import repro_torch  # noqa: F401  (fails where the program is absent)


def config(conf: Dict):
    """The program's ModelConfig of ``conf``, checked field by field."""
    _import()
    from repro_torch.configs import get_config
    port = conf["port"]
    cfg = get_config(port["arch"]).replace(**port.get("overrides", {}))
    for key, field in FIELDS.items():
        if key in conf and getattr(cfg, field) != conf[key]:
            raise ValueError(f"{conf['name']}: {key} {conf[key]!r} but the "
                             f"program runs {field}={getattr(cfg, field)!r}")
    if cfg.block not in ("dense", "moe") or cfg.act != "swiglu" \
            or cfg.logit_softcap:
        raise ValueError(f"{conf['name']}: the benchmark runs dense and MoE "
                         "SwiGLU decoders without soft capping")
    return cfg


def train_step(cfg):
    """(step_fn, optimizer, TrainState) of the program's default training
    path for ``cfg``."""
    _import()
    from repro_torch.launch import steps
    opt = steps.default_optimizer(cfg)
    return steps.make_train_step, opt, steps.TrainState


def serve_engine():
    _import()
    from repro_torch.serve.engine import Request, ServeEngine
    return ServeEngine, Request
