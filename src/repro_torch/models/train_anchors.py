"""The reference's smoke-size training outputs, pinned in
``anchors_train_smoke.json`` beside this file, and the port's run that is
held to them.

For every architecture at its ``SMOKE_CONFIG`` (float32), params drawn by
numpy from ``anchors.PARAM_SEED`` in the reference's layout
(``core.convert.numpy_params``) and batches from the data pipeline
(``make_dataset(cfg, SEQ, BATCH, seed=DATA_SEED).batch_at(step)``):

* ``grads``: the loss, the aux loss and each param leaf's gradient on
  batch 0, a leaf summarized as its L2 norm, its largest magnitude and
  ``N_SAMPLE`` entries at fixed flat indices;
* ``train``: ``default_optimizer`` steps on batches 0, 1, 2: each step's
  loss, and the params after two steps summarized against the initial
  ones (:func:`params_summary`);
* ``accum``: one ``make_grad_accum_train_step`` step in ``N_MICRO``
  microbatches with ``sgd(SGD_LR)`` on batch 0: its loss and params.

Every summary is float64 on the host.  The file is written from the JAX
package on the CPU (its step factories under a plain ``jax.jit``) by
``tests/_torch_train_anchors.py``; this module holds the numpy summaries
both sides share and the port's side of the run.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.convert import params_from_numpy
from ..data import make_dataset
from ..launch.steps import (TrainState, default_optimizer,
                            make_grad_accum_train_step, make_train_step)
from ..optim import sgd
from ..tree import leaves, named_leaves, unflatten
from . import anchors
from .model import loss_fn

PATH = Path(__file__).with_name("anchors_train_smoke.json")
PARAM_SEED = anchors.PARAM_SEED
DATA_SEED = 1
BATCH, SEQ = 2, 16
TRAIN_STEPS = 3
N_MICRO = 2
SGD_LR = 1e-2
N_SAMPLE = 8


def batches(cfg, n: int = TRAIN_STEPS) -> List[Dict[str, np.ndarray]]:
    """The pipeline's first ``n`` batches for ``cfg`` (numpy)."""
    ds = make_dataset(cfg, seq_len=SEQ, global_batch=BATCH, seed=DATA_SEED)
    return [ds.batch_at(step) for step in range(n)]


def _flat(named: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v, dtype=np.float64).reshape(-1)
            for k, v in named.items()}


def sample_ids(size: int) -> np.ndarray:
    return np.unique(np.linspace(0, size - 1, N_SAMPLE).astype(np.int64))


def grad_summary(grads: Dict[str, np.ndarray]) -> Dict[str, Dict]:
    """Per leaf: L2 norm, largest |g| and the entries at ``sample_ids``."""
    out = {}
    for name, g in _flat(grads).items():
        out[name] = {"norm": float(np.linalg.norm(g)),
                     "max": float(np.abs(g).max()),
                     "sample": g[sample_ids(g.size)].tolist()}
    return out


def params_summary(after: Dict[str, np.ndarray],
                   before: Dict[str, np.ndarray],
                   grads: Dict[str, np.ndarray]) -> Dict[str, List[float]]:
    """Per leaf: the L2 norm of the params, the L2 norm of their change
    and the change's inner product with the initial gradient.  A few
    entries whose gradient is within rounding of zero may take an AdamW
    step of either sign on either side; these three numbers barely move
    for them, where a sample of entries could differ by two steps."""
    a, b, g = _flat(after), _flat(before), _flat(grads)
    return {name: [float(np.linalg.norm(a[name])),
                   float(np.linalg.norm(a[name] - b[name])),
                   float(np.dot(a[name] - b[name], g[name]))]
            for name in a}


def _named(tree) -> Dict[str, np.ndarray]:
    """A tree of tensors or numpy arrays as float32 arrays by leaf name."""
    return {n: (x.detach().float().cpu().numpy()
                if isinstance(x, torch.Tensor) else np.asarray(x, np.float32))
            for n, x in named_leaves(tree)}


def port_outputs(cfg, tree: Dict, device) -> Dict:
    """The port's gradients, default-optimizer steps and grad-accumulation
    step from the numpy params ``tree``, summarized as the anchors are."""
    def as_batch(b):
        return {k: torch.as_tensor(v, device=device) for k, v in b.items()}

    data = [as_batch(b) for b in batches(cfg)]
    before = _named(tree)
    params = params_from_numpy(cfg, tree, device)
    flat = [p.requires_grad_(True) for p in leaves(params)]
    total, metrics = loss_fn(cfg, params, data[0])
    grads = torch.autograd.grad(total, flat)
    g0 = _named(unflatten(params, list(grads)))
    out = {"loss": metrics["loss"].item(), "aux": metrics["aux_loss"].item(),
           "grads": grad_summary(g0)}
    del grads, total

    opt = default_optimizer(cfg)
    step_fn = make_train_step(cfg, opt)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=device))
    losses = []
    for i, batch in enumerate(data):
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        if i == 1:
            summary = params_summary(_named(state.params), before, g0)
    out["train"] = {"losses": losses, "params": summary}

    params = params_from_numpy(cfg, tree, device)
    state = TrainState(params, {}, torch.zeros((), dtype=torch.int32,
                                               device=device))
    state, m = make_grad_accum_train_step(cfg, sgd(SGD_LR), N_MICRO)(
        state, data[0])
    out["accum"] = {"loss": float(m["loss"]),
                    "params": params_summary(_named(state.params), before,
                                             g0)}
    return out


def load() -> Dict:
    with open(PATH) as f:
        return json.load(f)


# the anchors' tolerances (float32 runs, on the CPU or the card)
LOSS_TOL = 1e-5       # relative and absolute
GRAD_TOL = 1e-4       # norms relative; entries of the leaf's largest |g|
PARAMS_TOL = 1e-4     # relative, each number of a params summary


def compare(got: Dict, want: Dict) -> Tuple[List[str], float]:
    """Where the port's ``got`` differs from the anchors' ``want`` at the
    tolerances above (elementwise ``|got - want| <= atol + rtol |want|``),
    and the largest ``|got - want|`` as a share of its allowance."""
    bad, shares = [], [0.0]

    def close(path, g, w, rtol, atol):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        if g.shape != w.shape:
            bad.append(f"{path}: shape {g.shape} != {w.shape}")
            return
        share = float((np.abs(g - w) / (atol + rtol * np.abs(w))).max())
        shares.append(share)
        if share > 1.0:
            bad.append(f"{path}: max |got - want| {np.abs(g - w).max():.3g}"
                       f" beyond atol {atol:.3g} + rtol {rtol:.3g}")

    for key, g, w in (("loss", got["loss"], want["loss"]),
                      ("aux", got["aux"], want["aux"]),
                      ("train/losses", got["train"]["losses"],
                       want["train"]["losses"]),
                      ("accum/loss", got["accum"]["loss"],
                       want["accum"]["loss"])):
        close(key, g, w, LOSS_TOL, LOSS_TOL)
    for part in ("grads", "train", "accum"):
        names = got[part] if part == "grads" else got[part]["params"]
        wanted = want[part] if part == "grads" else want[part]["params"]
        if set(names) != set(wanted):
            return bad + [f"{part}: leaves {sorted(names)} != "
                          f"{sorted(wanted)}"], max(shares)
    for name, w in want["grads"].items():
        g = got["grads"][name]
        close(f"grads/{name}/norm", g["norm"], w["norm"], GRAD_TOL, 1e-30)
        close(f"grads/{name}/max", g["max"], w["max"], GRAD_TOL, 1e-30)
        close(f"grads/{name}/sample", g["sample"], w["sample"], 0.0,
              GRAD_TOL * w["max"] + 1e-30)
    for part in ("train", "accum"):
        for name, w in want[part]["params"].items():
            close(f"{part}/params/{name}", got[part]["params"][name], w,
                  PARAMS_TOL, 1e-12)
    return bad, max(shares)
