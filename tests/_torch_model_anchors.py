"""The reference side of ``src/repro_torch/models/anchors_smoke.json``: every
architecture at its smoke config, run by the JAX package on the CPU with
params drawn by numpy (``repro_torch.core.convert.numpy_params``), through
forward, loss, prefill and greedy decode, summarized by
``repro_torch.models.anchors.summarize``.

Writes the anchors from a fresh reference run:

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_torch_model_anchors.py
"""
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO / "src") not in sys.path:
    sys.path.insert(0, str(REPO / "src"))

from repro import models as J  # noqa: E402
from repro.configs import ARCHS, get_config  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.core.convert import numpy_params  # noqa: E402
from repro_torch.models import anchors  # noqa: E402


def reference_outputs(arch: str) -> dict:
    """The reference's summarized outputs for ``arch`` (smoke config)."""
    cfg = get_config(arch, smoke=True)
    tree = numpy_params(t_configs.get_config(arch, smoke=True),
                        anchors.PARAM_SEED)
    params = jax.tree.map(jnp.asarray, tree)
    batch = {k: jnp.asarray(v) for k, v in anchors.smoke_batch(cfg).items()}
    logits, aux = J.forward(cfg, params, batch)
    loss, _ = J.loss_fn(cfg, params, batch)
    cache = J.init_cache(cfg, anchors.BATCH, anchors.MAX_LEN)
    step, cache = J.prefill(cfg, params, batch, cache)
    steps, tokens = [anchors.summarize(cfg, step)], []
    for _ in range(anchors.DECODE_STEPS):
        nxt = jnp.argmax(step, axis=-1).astype(jnp.int32)
        tokens.append(np.asarray(nxt).tolist())
        step, cache = J.decode_step(cfg, params, nxt[:, None], cache)
        steps.append(anchors.summarize(cfg, step))
    tokens.append(np.asarray(jnp.argmax(step, axis=-1)).tolist())
    return {"checksum": anchors.params_checksum(tree), "loss": float(loss),
            "aux": float(aux), "forward": anchors.summarize(cfg, logits),
            "steps": steps, "tokens": tokens}


def _short(v):
    """Floats at 9 significant digits (the anchors hold float32 values)."""
    if isinstance(v, dict):
        return {k: _short(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_short(x) for x in v]
    if isinstance(v, float):
        return float(f"{v:.9g}")
    return v


def write_anchors() -> None:
    """One line an architecture; the checksum keeps all its digits."""
    archs = {}
    for arch in sorted(ARCHS):
        out = reference_outputs(arch)
        archs[arch] = dict(_short(out), checksum=out["checksum"])
    head = {"source": "repro.models on the CPU (JAX), params from "
                      "repro_torch.core.convert.numpy_params "
                      "(tests/_torch_model_anchors.py)",
            "param_seed": anchors.PARAM_SEED,
            "batch_seed": anchors.BATCH_SEED}
    lines = [f" {json.dumps(k)}: {json.dumps(v)}," for k, v in head.items()]
    lines.append(' "archs": {')
    lines += [f"  {json.dumps(arch)}: {json.dumps(v, sort_keys=True)},"
              for arch, v in archs.items()]
    lines[-1] = lines[-1].rstrip(",")
    with open(anchors.PATH, "w") as f:
        f.write("{\n" + "\n".join(lines) + "\n }\n}\n")


if __name__ == "__main__":
    write_anchors()
