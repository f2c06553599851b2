"""The reference's smoke-size model outputs, pinned in ``anchors_smoke.json``
beside this file, and the port's run that is held to them.

For every architecture at its ``SMOKE_CONFIG`` (float32): params drawn by
numpy from ``PARAM_SEED`` in the reference's layout
(``core.convert.numpy_params``), a batch drawn from ``BATCH_SEED``, then the
forward logits, aux and loss, the prefill's last-token logits and
``DECODE_STEPS`` greedy decode steps.  Logits are kept at ``N_IDS`` fixed
vocabulary ids beside each row's logsumexp over the whole vocabulary; the
greedy tokens cover the argmax.  The file is written from the JAX package
on the CPU by ``tests/_torch_model_anchors.py``; this module holds only the
numpy summary both sides share and the port's side of the run.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

PATH = Path(__file__).with_name("anchors_smoke.json")
PARAM_SEED = 0
BATCH_SEED = 1
BATCH, SEQ = 2, 16
MAX_LEN = SEQ + 8
DECODE_STEPS = 3
N_IDS = 16


def smoke_batch(cfg, b: int = BATCH, s: int = SEQ, seed: int = BATCH_SEED
                ) -> Dict[str, np.ndarray]:
    """tests/test_models.py's batch as numpy arrays."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision_stub":
        batch["vision_embeds"] = (rng.normal(
            size=(b, cfg.n_vision_tokens, cfg.d_model)) * 0.02
        ).astype(np.float32)
    if cfg.block == "encdec":
        batch["audio_frames"] = (rng.normal(
            size=(b, cfg.n_audio_frames, cfg.d_model)) * 0.02
        ).astype(np.float32)
    return batch


def params_checksum(tree) -> List[float]:
    """[sum, sum of |x|, count] over every leaf in sorted key order, in
    float64: a change in numpy's stream shows here, before any model
    output is compared."""
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        else:
            leaves.append(np.asarray(node, dtype=np.float64))

    walk(tree)
    return [float(sum(a.sum() for a in leaves)),
            float(sum(np.abs(a).sum() for a in leaves)),
            float(sum(a.size for a in leaves))]


def _logsumexp(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=-1, keepdims=True)
    return (m + np.log(np.exp(x - m).sum(axis=-1, keepdims=True)))[..., 0]


def summarize(cfg, logits) -> Dict[str, list]:
    """Logits (..., V_padded) as the values at N_IDS fixed ids and each
    row's logsumexp over the real vocabulary (float64 on the host)."""
    x = np.asarray(logits, dtype=np.float64)
    ids = np.linspace(0, cfg.vocab - 1, N_IDS).astype(np.int64)
    return {"at_ids": x[..., ids].tolist(),
            "lse": _logsumexp(x[..., :cfg.vocab]).tolist()}


def port_outputs(cfg, params: Dict, device) -> Dict:
    """The port's forward, loss, prefill and greedy decode on the smoke
    batch, summarized as the anchors are."""
    from .model import decode_step, forward, init_cache, loss_fn, prefill

    batch = {k: torch.as_tensor(v, device=device)
             for k, v in smoke_batch(cfg).items()}
    with torch.inference_mode():
        logits, aux = forward(cfg, params, batch)
        loss, _ = loss_fn(cfg, params, batch)
        cache = init_cache(cfg, BATCH, MAX_LEN, device)
        step, cache = prefill(cfg, params, batch, cache)
        steps, tokens = [summarize(cfg, step.cpu())], []
        for _ in range(DECODE_STEPS):
            nxt = torch.argmax(step, dim=-1)
            tokens.append(nxt.cpu().tolist())
            step, cache = decode_step(cfg, params, nxt[:, None], cache)
            steps.append(summarize(cfg, step.cpu()))
        tokens.append(torch.argmax(step, dim=-1).cpu().tolist())
    return {"loss": float(loss), "aux": float(aux),
            "forward": summarize(cfg, logits.cpu()), "steps": steps,
            "tokens": tokens}


def load() -> Dict:
    with open(PATH) as f:
        return json.load(f)


def mismatches(got, want, rtol: float, atol: float, path: str = ""
               ) -> List[str]:
    """Where ``got`` differs from ``want``: floats beyond atol + rtol·|want|
    (elementwise, like ``np.allclose``), anything else unequal."""
    if isinstance(want, dict):
        if set(got) != set(want):
            return [f"{path}: keys {sorted(got)} != {sorted(want)}"]
        return [m for k in sorted(want)
                for m in mismatches(got[k], want[k], rtol, atol,
                                    f"{path}/{k}")]
    if isinstance(want, list) and np.asarray(want).dtype == object:
        if len(got) != len(want):
            return [f"{path}: {len(got)} entries != {len(want)}"]
        return [m for i, (g, w) in enumerate(zip(got, want))
                for m in mismatches(g, w, rtol, atol, f"{path}[{i}]")]
    if np.asarray(want).dtype.kind == "f":
        g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
        if g.shape != w.shape:
            return [f"{path}: shape {g.shape} != {w.shape}"]
        err = np.abs(g - w) - (atol + rtol * np.abs(w))
        return [] if (err <= 0).all() else [
            f"{path}: max |got - want| {np.abs(g - w).max():.3g} beyond "
            f"atol {atol} + rtol {rtol}"]
    return [] if got == want else [f"{path}: {got} != {want}"]
