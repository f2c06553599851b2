"""The port's model stack against the JAX package's, every architecture at
its smoke config, float32 on the CPU: the reference's ``init_params`` tree
converted by ``convert.params_from_numpy``, the same numpy batch through
both, forward logits and aux at rtol = atol = 1e-4, the loss at 1e-5
relative, prefill's last logits and 3 greedy decode steps at 1e-4 with the
greedy tokens equal.  Then tests/test_models.py's own checks on the port,
with params from the port's ``init_params``."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as J  # noqa: E402
from repro.configs import ARCHS, get_config as j_get_config  # noqa: E402

from repro_torch import models as T  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402
from repro_torch.models import anchors  # noqa: E402
from repro_torch.models.moe import _moe_block_jit, moe_init  # noqa: E402
from repro_torch.models.layers import Init  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
B, S, MAX_LEN, STEPS = 2, 16, 24, 3


def make_batch(cfg, B=2, S=16, seed=0):
    """tests/test_models.py's batch, as numpy arrays."""
    return anchors.smoke_batch(cfg, B, S, seed)


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def reference(arch):
    """The reference's params tree (as numpy) and its outputs on the smoke
    batch: forward logits, aux, loss, prefill and greedy decode logits."""
    cfg = j_get_config(arch, smoke=True)
    params = J.init_params(cfg, jax.random.PRNGKey(0))
    batch = _j(make_batch(cfg))
    logits, aux = J.forward(cfg, params, batch)
    loss, _ = J.loss_fn(cfg, params, batch)
    cache = J.init_cache(cfg, B, MAX_LEN)
    step, cache = J.prefill(cfg, params, batch, cache)
    steps, tokens = [np.asarray(step)], []
    for _ in range(STEPS):
        nxt = jnp.argmax(step, axis=-1).astype(jnp.int32)
        tokens.append(np.asarray(nxt))
        step, cache = J.decode_step(cfg, params, nxt[:, None], cache)
        steps.append(np.asarray(step))
    return {"params": jax.tree.map(np.asarray, params),
            "logits": np.asarray(logits), "aux": float(aux),
            "loss": float(loss), "steps": steps, "tokens": tokens}


def port(arch):
    # the JAX package has no Falcon-Mamba mixer norms
    cfg = t_get_config(arch, smoke=True).replace(mixer_rms_eps=None)
    return cfg, params_from_numpy(cfg, reference(arch)["params"], "cpu")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_and_loss_equal_reference(arch):
    want = reference(arch)
    cfg, params = port(arch)
    batch = _t(make_batch(cfg))
    logits, aux = T.forward(cfg, params, batch)
    assert logits.dtype == torch.float32
    assert logits.shape == (B, S, cfg.vocab_padded)
    np.testing.assert_allclose(logits.numpy(), want["logits"], **TOL)
    np.testing.assert_allclose(float(aux), want["aux"], **TOL)
    loss, parts = T.loss_fn(cfg, params, batch)
    np.testing.assert_allclose(float(loss), want["loss"], rtol=1e-5)
    assert float(parts["tokens"]) == B * S


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_greedy_decode_equal_reference(arch):
    want = reference(arch)
    cfg, params = port(arch)
    cache = T.init_cache(cfg, B, MAX_LEN, "cpu")
    step, cache = T.prefill(cfg, params, _t(make_batch(cfg)), cache)
    np.testing.assert_allclose(step.numpy(), want["steps"][0], **TOL)
    for t in range(STEPS):
        nxt = torch.argmax(step, dim=-1)
        np.testing.assert_array_equal(nxt.numpy(), want["tokens"][t])
        step, cache = T.decode_step(cfg, params, nxt[:, None], cache)
        np.testing.assert_allclose(step.numpy(), want["steps"][t + 1], **TOL)


def _port_params(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    return T.init_params(cfg, g, "cpu")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_arch_prefill_matches_forward(arch):
    """tests/test_models.py::test_arch_prefill_matches_forward on the
    port: prefill's last logits == forward's, then 3 finite decode steps
    that advance the cache."""
    cfg = t_get_config(arch, smoke=True)
    params = _port_params(cfg, 0)
    batch = _t(make_batch(cfg, B, S))
    cache = T.init_cache(cfg, B, S + 8, "cpu")
    logits_p, cache = T.prefill(cfg, params, batch, cache)
    full, aux = T.forward(cfg, params, batch)
    assert torch.isfinite(full).all() and torch.isfinite(aux)
    np.testing.assert_allclose(logits_p.numpy(), full[:, -1].numpy(),
                               rtol=2e-4, atol=2e-4)
    toks = torch.ones((B, 1), dtype=torch.int64)
    for _ in range(3):
        logits_d, cache = T.decode_step(cfg, params, toks, cache)
        assert torch.isfinite(logits_d).all()
        toks = torch.argmax(logits_d, -1, keepdim=True)


@pytest.mark.parametrize("arch", ["gemma-2b", "falcon-mamba-7b",
                                  "zamba2-2.7b", "olmoe-1b-7b"])
def test_incremental_decode_matches_teacher_forcing(arch):
    """tests/test_models.py's check on the port: prefill(x[:n]) +
    decode(x[n:]) step by step == forward(x) logits."""
    cfg = t_get_config(arch, smoke=True)
    params = _port_params(cfg, 1)
    Bt, St, n = 1, 12, 6
    batch = _t(make_batch(cfg, Bt, St, seed=3))
    full, _ = T.forward(cfg, params, batch)
    pre = {k: (v[:, :n] if k in ("tokens", "labels") else v)
           for k, v in batch.items()}
    cache = T.init_cache(cfg, Bt, St + 2, "cpu")
    logits, cache = T.prefill(cfg, params, pre, cache)
    np.testing.assert_allclose(logits.numpy(), full[:, n - 1].numpy(),
                               rtol=5e-3, atol=5e-3)
    for t in range(n, St):
        logits, cache = T.decode_step(cfg, params,
                                      batch["tokens"][:, t:t + 1], cache)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   rtol=5e-3, atol=5e-3)


def test_moe_conservation_and_aux():
    """tests/test_models.py::test_moe_conservation_and_aux on the port."""
    cfg = T.ModelConfig(name="m", block="moe", d_model=32, d_ff=16,
                        n_experts=8, top_k=2, capacity_factor=4.0)
    params = moe_init(Init(torch.Generator().manual_seed(0), "cpu"), cfg)
    x = (torch.ones((1, 1, 32)) * 0.3).expand(2, 8, 32)
    out, aux = _moe_block_jit(params, x, cfg)
    flat = out.reshape(-1, 32).numpy()
    np.testing.assert_allclose(flat, np.broadcast_to(flat[0], flat.shape),
                               rtol=1e-5, atol=1e-5)
    assert np.isfinite(float(aux))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_params_have_the_reference_layout(arch):
    """The port's init_params at the full config: the reference's names,
    stacked shapes and dtypes (jax.eval_shape against the meta device)."""
    j_cfg, t_cfg = j_get_config(arch), t_get_config(arch)
    want = jax.eval_shape(lambda: J.init_params(j_cfg,
                                                jax.random.PRNGKey(0)))
    got = T.init_params(t_cfg, None, "meta")
    paths = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
             for p, x in jax.tree_util.tree_leaves_with_path(want)}
    mine = {jax.tree_util.keystr(p): (tuple(x.shape),
                                      str(x.dtype).replace("torch.", ""))
            for p, x in jax.tree_util.tree_leaves_with_path(got)}
    assert mine == paths


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_params_have_the_reference_scales(arch):
    """Smoke params drawn by the port: constant leaves (norms, biases, D,
    A_log) equal the reference's (A_log = log(1..N) to the last ulp);
    drawn leaves have its spread."""
    want = reference(arch)["params"]
    got = _port_params(t_get_config(arch, smoke=True), 7)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    for path, leaf in jax.tree_util.tree_leaves_with_path(got):
        w = flat_w[path]
        g = leaf.numpy()
        if np.all(w == w.reshape(-1)[0]) or "A_log" in str(path):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
        elif w.size >= 256:
            np.testing.assert_allclose(g.std(), w.std(), rtol=0.25)
