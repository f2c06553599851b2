"""The reference side of ``src/repro_torch/models/anchors_train_smoke.json``:
every architecture at its smoke config, trained by the JAX package on the
CPU with its own step factories under a plain ``jax.jit`` (no mesh), from
params drawn by numpy (``repro_torch.core.convert.numpy_params``) on the
data pipeline's batches, summarized by ``repro_torch.models.train_anchors``.

Writes the anchors from a fresh reference run:

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_torch_train_anchors.py
"""
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO / "src") not in sys.path:
    sys.path.insert(0, str(REPO / "src"))

from repro import models as J  # noqa: E402
from repro.configs import ARCHS, get_config  # noqa: E402
from repro.launch.steps import (TrainState, default_optimizer,  # noqa: E402
                                make_grad_accum_train_step, make_train_step)
from repro.optim import sgd  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.core.convert import numpy_params  # noqa: E402
from repro_torch.models import train_anchors as TA  # noqa: E402
from repro_torch.tree import named_leaves  # noqa: E402


def _named(tree):
    return {n: np.asarray(jnp.asarray(x, jnp.float32))
            for n, x in named_leaves(jax.tree.map(np.asarray, tree))}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The smoke models' ops are tiny: one intra-op thread a test process
    keeps six test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_train_outputs(arch: str) -> dict:
    """The reference's summarized training outputs for ``arch``."""
    cfg = get_config(arch, smoke=True)
    tree = numpy_params(t_configs.get_config(arch, smoke=True),
                        TA.PARAM_SEED)
    params = jax.tree.map(jnp.asarray, tree)
    data = [{k: jnp.asarray(v) for k, v in b.items()}
            for b in TA.batches(cfg)]
    before = _named(tree)

    (_, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: J.loss_fn(cfg, p, b), has_aux=True))(params, data[0])
    g0 = _named(grads)
    out = {"loss": float(metrics["loss"]), "aux": float(metrics["aux_loss"]),
           "grads": TA.grad_summary(g0)}

    opt = default_optimizer(cfg)
    step_fn = jax.jit(make_train_step(cfg, opt))
    state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    losses = []
    for i, batch in enumerate(data):
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        if i == 1:
            summary = TA.params_summary(_named(state.params), before, g0)
    out["train"] = {"losses": losses, "params": summary}

    accum = jax.jit(make_grad_accum_train_step(cfg, sgd(TA.SGD_LR),
                                               TA.N_MICRO))
    state, m = accum(TrainState(params, {}, jnp.zeros((), jnp.int32)),
                     data[0])
    out["accum"] = {"loss": float(m["loss"]),
                    "params": TA.params_summary(_named(state.params),
                                                before, g0)}
    return out


def assert_pinned_equals_fresh(arch: str) -> None:
    """The committed anchors of ``arch`` equal a fresh reference run (the
    file keeps 10 significant digits)."""
    fresh = reference_train_outputs(arch)
    bad, share = TA.compare(fresh, TA.load()["archs"][arch])
    assert not bad and share < 1e-3, (bad, share)


def _short(v):
    """Floats at 10 significant digits (float32 values, float64 sums)."""
    if isinstance(v, dict):
        return {k: _short(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_short(x) for x in v]
    if isinstance(v, float):
        return float(f"{v:.10g}")
    return v


def write_anchors() -> None:
    """One line an architecture."""
    head = {"source": "repro.launch.steps under jax.jit on the CPU (JAX), "
                      "params from repro_torch.core.convert.numpy_params "
                      "(tests/_torch_train_anchors.py)",
            "param_seed": TA.PARAM_SEED, "data_seed": TA.DATA_SEED,
            "batch": TA.BATCH, "seq": TA.SEQ}
    lines = [f" {json.dumps(k)}: {json.dumps(v)}," for k, v in head.items()]
    lines.append(' "archs": {')
    lines += [f"  {json.dumps(arch)}: "
              f"{json.dumps(_short(reference_train_outputs(arch)),
                            sort_keys=True)},"
              for arch in sorted(ARCHS)]
    lines[-1] = lines[-1].rstrip(",")
    with open(TA.PATH, "w") as f:
        f.write("{\n" + "\n".join(lines) + "\n }\n}\n")


if __name__ == "__main__":
    write_anchors()
