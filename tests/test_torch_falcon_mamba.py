"""falcon-mamba-7b at its smoke size on the CPU: the port (Falcon-Mamba's
mixer norms on) against the benchmark's plain reference of the family,
``perfbench/reference/mamba1.py``, on weights drawn by the family's leaves
(Mamba's Delta bias, S4D-real A_log) from a seed: logits, loss and every
parameter's gradient.  The same tolerances refuse the port without the
mixer norms.  Also: with the tracer on, the mixer's spans nest under
``layer``."""
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from perfbench import weights  # noqa: E402
from perfbench.reference import mamba1 as reference  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import forward, loss_fn  # noqa: E402
from repro_torch.runtime import trace  # noqa: E402

# the smoke configuration as the family's configuration file states it
CONF = {
    "name": "falcon-mamba-7b-smoke", "family": "mamba1",
    "num_hidden_layers": 2, "hidden_size": 64, "intermediate_size": 128,
    "expand": 2, "state_size": 8, "conv_kernel": 4, "time_step_rank": 8,
    "vocab_size": 256, "norm": "rmsnorm", "rms_norm_eps": 1e-6,
    "mixer_rms_eps": 1e-6, "tie_word_embeddings": False,
    "torch_dtype": "float32", "vocab_pad_multiple": 256,
}
SEEDS = (0, 1, 2)
# Both sides compute in float32 and differ in summation order only (the
# chunked log-step scan against the sequential one, fused against split
# normalisations): over 2 layers and 40 positions the worst reading of
# seeds 0-5 is 1.8e-6 of its tensor's largest value (logits, gradients;
# the loss relative); 1e-4 leaves room for other seeds and BLAS.  Leaving
# the mixer norms out moves the worst reading to 0.93-1.18.
TOL = 1e-4


def _setup(seed, eps=1e-6):
    cfg = get_config("falcon-mamba-7b", smoke=True).replace(
        mixer_rms_eps=eps)
    flat = weights.draw_all(CONF, seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, CONF["vocab_size"], (2, 41), generator=g)
    return cfg, flat, tokens[:, :-1], tokens[:, 1:]


def _program(cfg, flat, tokens, labels):
    flat = {k: v.clone().requires_grad_() for k, v in flat.items()}
    batch = {"tokens": tokens, "labels": labels}
    loss, _ = loss_fn(cfg, weights.nest(flat), batch)
    grads = torch.autograd.grad(loss, list(flat.values()))
    with torch.no_grad():
        logits, _ = forward(cfg, weights.nest(flat), batch)
    return logits, loss.detach(), dict(zip(flat, grads))


def _reference(flat, tokens, labels):
    spec = reference.Spec.from_config(CONF)
    flat = {k: v.clone().requires_grad_() for k, v in flat.items()}
    loss, _ = reference.loss(spec, flat, tokens, labels)
    grads = torch.autograd.grad(loss, list(flat.values()))
    with torch.no_grad():
        logits = reference.logits_at(spec, flat, tokens[0], 0)
    return logits, loss.detach(), dict(zip(flat, grads))


def _gaps(prog, ref):
    """Each reading's largest gap over its tensor's largest value."""
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    gaps = {"logits": rel(prog[0][0], ref[0]),
            "loss": float(abs(prog[1] - ref[1]) / abs(ref[1]))}
    gaps.update({"grad " + n: rel(prog[2][n], g) for n, g in ref[2].items()})
    return gaps


@pytest.mark.parametrize("seed", SEEDS)
def test_port_equals_the_reference(seed):
    cfg, flat, tokens, labels = _setup(seed)
    gaps = _gaps(_program(cfg, flat, tokens, labels),
                 _reference(flat, tokens, labels))
    assert len(gaps) == 2 + 13
    assert max(gaps.values()) <= TOL, gaps


@pytest.mark.parametrize("seed", SEEDS)
def test_the_port_without_the_mixer_norms_is_refused(seed):
    cfg, flat, tokens, labels = _setup(seed, eps=None)
    gaps = _gaps(_program(cfg, flat, tokens, labels),
                 _reference(flat, tokens, labels))
    assert max(gaps.values()) > 1000 * TOL, gaps


def test_the_mixers_spans_nest_under_layer():
    cfg, flat, tokens, labels = _setup(0)
    trace.enable()
    try:
        with torch.no_grad():
            forward(cfg, weights.nest(flat), {"tokens": tokens})
        got = trace.drain()
    finally:
        trace.disable()
        trace.drain()
    by_id = {s["id"]: s for s in got["spans"]}
    ssm = [s for s in got["spans"] if s["name"].startswith("ssm.")]
    names = ["ssm.in_proj", "ssm.conv", "ssm.xproj", "ssm.scan",
             "ssm.out_proj"]
    assert [s["name"] for s in ssm] == names * cfg.n_layers
    assert all(by_id[s["parent"]]["name"] == "layer" for s in ssm)
    assert [s["attrs"] for s in ssm if s["name"] == "ssm.scan"] == \
        [{"impl": "chunked", "L": 40, "d_inner": 128, "N": 8}] * 2
