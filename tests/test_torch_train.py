"""The port's gradients and train steps against the JAX package's, every
architecture at its smoke config on the CPU, params drawn by numpy
(``core.convert.numpy_params``) and the same numpy batch through both.

* The loss equals the reference's ``jax.value_and_grad`` of its
  ``loss_fn`` (under ``jax.jit``) at 1e-5 relative, and every gradient leaf
  its counterpart at 1e-4 of the leaf's largest |g| (float32; the reference
  reaches no Pallas kernel: its layers run the jnp twins).  A control with
  one label changed must fail that comparison.
* Two ``default_optimizer`` steps and one ``n_micro=2`` SGD step equal the
  reference's ``make_train_step`` / ``make_grad_accum_train_step`` under
  ``jax.jit``, leaf by leaf: every entry at rtol 1e-5, atol 1e-6, except
  that AdamW's update is about +-lr for an entry whose gradient is within
  rounding of zero on one side and not the other, so at most 1e-3 of a
  leaf's entries may differ, by no more than 2 lr a step; AdamW's m and v
  at 2e-4 of the leaf's largest value (m ~ g, v ~ g**2).
* ``cfg.remat`` on and off give bit-equal gradients in the port.
* gemma-2b smoke in bfloat16 against the reference in bfloat16: loss at
  2e-3 relative, each gradient leaf at 5e-2 of its largest |g| (bfloat16
  rounds every matmul output and activation, 2**-8 relative each; measured
  3.1e-4 and 3.1e-2).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as J  # noqa: E402
from repro.configs import ARCHS, get_config as j_get_config  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402

from _torch_train_anchors import one_torch_thread  # noqa: E402,F401

from repro_torch import models as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.convert import (numpy_params,  # noqa: E402
                                      params_from_numpy)
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import anchors  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.tree import leaves, named_leaves  # noqa: E402

LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
BF16_LOSS_RTOL, BF16_GRAD_TOL = 2e-3, 5e-2


def _batch(cfg, seed=2):
    return anchors.smoke_batch(cfg, 2, 16, seed)


def _named_np(tree):
    return {n: np.asarray(jnp.asarray(x, jnp.float32)) for n, x in
            named_leaves(jax.tree.map(np.asarray, tree))}


@functools.lru_cache(maxsize=None)
def reference_grads(arch, dtype="float32"):
    """The reference's loss, aux and gradient leaves (float32 numpy, by
    leaf name) on the numpy params and batch."""
    cfg = j_get_config(arch, smoke=True).replace(dtype=dtype)
    tree = numpy_params(get_config(arch, smoke=True), 0)
    params = jax.tree.map(lambda a: jnp.asarray(a, cfg.jdtype), tree)
    params = _cast_float32_leaves(cfg, params)
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    (_, m), g = jax.jit(jax.value_and_grad(
        lambda p, b: J.loss_fn(cfg, p, b), has_aux=True))(params, batch)
    return float(m["loss"]), float(m["aux_loss"]), _named_np(g)


def _cast_float32_leaves(cfg, params):
    """The leaves the reference keeps in float32 whatever the dtype (the
    SSM's A_log and D, the router), as its init_params makes them."""
    spec = jax.eval_shape(lambda: J.init_params(cfg, jax.random.PRNGKey(0)))
    return jax.tree.map(lambda x, s: x.astype(s.dtype), params, spec)


def port_grads(arch, dtype="float32", batch=None, remat=None):
    # the JAX package has no Falcon-Mamba mixer norms
    cfg = get_config(arch, smoke=True).replace(dtype=dtype, mixer_rms_eps=None)
    if remat is not None:
        cfg = cfg.replace(remat=remat)
    params = params_from_numpy(cfg, numpy_params(cfg, 0), "cpu")
    batch = _batch(cfg) if batch is None else batch
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    total, m = T.loss_fn(cfg, params,
                         {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(total, flat)
    names = [n for n, _ in named_leaves(params)]
    return (m["loss"].item(), m["aux_loss"].item(),
            {n: g for n, g in zip(names, grads)})


def grad_mismatches(got, want, tol):
    """Leaves whose |port - reference| exceeds tol * the leaf's max |g|."""
    assert sorted(got) == sorted(want)
    bad = []
    for name, w in want.items():
        g = got[name].float().numpy()
        assert g.shape == w.shape, name
        err = np.abs(g - w).max()
        if err > tol * np.abs(w).max() + 1e-30:
            bad.append(f"{name}: {err:.3g} > {tol} x {np.abs(w).max():.3g}")
    return bad


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_grads_equal_the_reference(arch):
    want_loss, want_aux, want = reference_grads(arch)
    loss, aux, got = port_grads(arch)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(aux, want_aux, rtol=LOSS_RTOL, atol=1e-7)
    assert grad_mismatches(got, want, GRAD_TOL) == []
    # the control: one label changed must fail the same comparison
    cfg = get_config(arch, smoke=True)
    batch = _batch(cfg)
    batch["labels"][0, 0] = (batch["labels"][0, 0] + 1) % cfg.vocab
    _, _, wrong = port_grads(arch, batch=batch)
    assert grad_mismatches(wrong, want, GRAD_TOL) != []


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-1b",
                                  "zamba2-2.7b", "olmoe-1b-7b"])
def test_remat_changes_no_gradient(arch):
    on = port_grads(arch, remat=True)
    off = port_grads(arch, remat=False)
    assert on[:2] == off[:2]
    for name in on[2]:
        assert torch.equal(on[2][name], off[2][name]), name


def test_bfloat16_loss_and_grads_equal_the_reference():
    want_loss, _, want = reference_grads("gemma-2b", "bfloat16")
    loss, _, got = port_grads("gemma-2b", "bfloat16")
    assert all(g.dtype == torch.bfloat16 for g in got.values())
    np.testing.assert_allclose(loss, want_loss, rtol=BF16_LOSS_RTOL)
    assert grad_mismatches(got, want, BF16_GRAD_TOL) == []


def _close_but_for_adamw_flips(got, want, lr, steps):
    err = np.abs(got - want)
    off = err > 1e-6 + 1e-5 * np.abs(want)
    assert off.mean() <= 1e-3, f"{off.sum()} of {off.size} entries differ"
    assert (err[off] <= 2 * lr * steps + 1e-6).all(), err.max()


@pytest.mark.parametrize("arch", ["gemma-2b", "olmoe-1b-7b",
                                  "falcon-mamba-7b"])
def test_train_steps_equal_the_reference_step_factories(arch):
    jcfg, cfg = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    cfg = cfg.replace(mixer_rms_eps=None)  # none in the JAX package
    tree = numpy_params(cfg, 0)
    data = [_batch(cfg, seed) for seed in (3, 4)]

    jopt = JS.default_optimizer(jcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = JS.TrainState(jparams, jopt.init(jparams),
                           jnp.zeros((), jnp.int32))
    jstep = jax.jit(JS.make_train_step(jcfg, jopt))
    opt = TS.default_optimizer(cfg)
    params = params_from_numpy(cfg, tree, "cpu")
    state = TS.TrainState(params, opt.init(params),
                          torch.zeros((), dtype=torch.int32))
    step = TS.make_train_step(cfg, opt)
    for b in data:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: torch.as_tensor(v) for k, v in b.items()})
        assert sorted(m) == sorted(jm)
        for k in ("loss", "aux_loss"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=LOSS_RTOL, atol=1e-7)
        assert int(m["step"]) == int(jm["step"])
    assert int(state.step) == 2 and state.step.dtype == torch.int32
    assert all(p.grad is None for p in leaves(state.params))
    want = _named_np(jstate)
    for name, x in named_leaves(state):
        got = x.detach().float().numpy()
        if name.startswith("params/"):
            _close_but_for_adamw_flips(got, want[name], 3e-4, 2)
        else:   # m ~ g and v ~ g^2: at 2 GRAD_TOL of the leaf's largest
            np.testing.assert_allclose(
                got, want[name], rtol=0,
                atol=2 * GRAD_TOL * np.abs(want[name]).max(), err_msg=name)

    jaccum = jax.jit(JS.make_grad_accum_train_step(jcfg, j_sgd(1e-2), 2))
    accum = TS.make_grad_accum_train_step(cfg, sgd(1e-2), 2)
    jstate, jm = jaccum(JS.TrainState(jparams, {}, jnp.zeros((), jnp.int32)),
                        {k: jnp.asarray(v) for k, v in data[0].items()})
    state, m = accum(TS.TrainState(params_from_numpy(cfg, tree, "cpu"), {},
                                   torch.zeros((), dtype=torch.int32)),
                     {k: torch.as_tensor(v) for k, v in data[0].items()})
    assert sorted(m) == sorted(jm) == ["loss", "step"]
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    want = _named_np(jstate)
    for name, x in named_leaves(state):
        np.testing.assert_allclose(x.detach().float().numpy(), want[name],
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_state_specs_are_meta_and_match_a_real_state():
    cfg = get_config("zamba2-2.7b", smoke=True)
    opt = TS.default_optimizer(cfg)
    spec = TS.state_specs(cfg, opt)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    real = TS.TrainState(params, opt.init(params),
                         torch.zeros((), dtype=torch.int32))
    got, want = named_leaves(spec), named_leaves(real)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, s), (_, x) in zip(got, want):
        assert s.device.type == "meta"
        assert (s.shape, s.dtype) == (x.shape, x.dtype)


def test_prefill_and_serve_steps_are_the_model_api():
    cfg = get_config("gemma-2b", smoke=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.as_tensor(_batch(cfg)["tokens"])
    with torch.inference_mode():
        cache = T.init_cache(cfg, 2, 20, "cpu")
        last, cache = TS.make_prefill_step(cfg)(params, {"tokens": toks},
                                                cache)
        want, _ = T.forward(cfg, params, {"tokens": toks})
        torch.testing.assert_close(last, want[:, -1], rtol=1e-4, atol=1e-4)
        nxt = torch.argmax(last, -1)[:, None]
        logits, cache = TS.make_serve_step(cfg)(params, nxt, cache)
    assert logits.shape == (2, cfg.vocab_padded) and int(cache.pos[0]) == 17
