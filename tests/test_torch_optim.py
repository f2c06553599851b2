"""The port's optimizers against the JAX package's (``repro.optim``): the
same params and the same gradients, drawn by numpy, through 5 updates of
``sgd``, ``adamw`` (constant and cosine learning rate) and ``adafactor``
(factored and unfactored leaves), with the global-norm clip active and
inactive, on float32 and bfloat16 params.  After every step the params and
every state leaf equal the reference's: float32 values at rtol 1e-5, atol
1e-6 (XLA may fuse a multiply-add that the port rounds twice); bfloat16
params after step k (1-based) at k bfloat16 ulps (k * 2**-7 relative): a
float32 value a rounding apart can round to the neighbouring bfloat16,
once a step at most.  Then
``schedule_cosine`` against the reference's, and
tests/test_serving_and_data.py's optimizer checks on the port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as J  # noqa: E402

from repro_torch import optim as T  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_ULP = 2.0 ** -7
SHAPES = {"w": (160, 130), "b": (7,), "deep": {"v": (3, 130, 129),
                                               "s": (4, 5)}}
STEPS = 5


def _draw(rng, shapes, scale):
    if isinstance(shapes, dict):
        return {k: _draw(rng, shapes[k], scale) for k in sorted(shapes)}
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _torch(tree, dtype):
    if isinstance(tree, dict):
        return {k: _torch(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(tree).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# each builds the same optimizer from either package (``m``)
OPTIMIZERS = {
    "sgd": lambda m: m.sgd(0.05),
    "adamw": lambda m: m.adamw(0.01),
    "adamw_cosine": lambda m: m.adamw(m.schedule_cosine(0.02, warmup=2,
                                                        total=6)),
    "adafactor": lambda m: m.adafactor(0.05),
    "adafactor_all_unfactored": lambda m: m.adafactor(
        0.05, min_dim_factored=1000),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_active", [True, False])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_updates_equal_the_reference(name, clip_active, dtype):
    make = OPTIMIZERS[name]
    rng = np.random.default_rng(0)
    p0 = _draw(rng, SHAPES, 1.0)
    # global norm ~ 1e2 (clip at 1.0 active) or ~ 1e-1 (inactive)
    scale = 0.3 if clip_active else 3e-4
    grads = [_draw(rng, SHAPES, scale) for _ in range(STEPS)]
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    jopt, topt = make(J), make(T)
    jp = _jax(p0, jdt)
    js = jopt.init(jp)
    tp = _torch(p0, tdt)
    ts = topt.init(tp)
    norm = float(np.sqrt(sum(np.sum(np.square(g, dtype=np.float64))
                             for g in jax.tree.leaves(grads[0]))))
    assert (norm > 1.0) == clip_active
    for step in range(STEPS):
        jp, js = jopt.update(_jax(grads[step], jdt), js, jp,
                             jnp.asarray(step, jnp.int32))
        tp2, ts2 = topt.update(_torch(grads[step], tdt), ts, tp,
                               torch.tensor(step, dtype=torch.int32))
        assert tp2 is tp and ts2 is ts, "the update is in place"
        tol = (F32_TOL if dtype == "float32"
               else dict(rtol=(step + 1) * BF16_ULP, atol=1e-6))
        for a, b in zip(leaves(tp), jax.tree.leaves(jp)):
            assert a.dtype == tdt
            np.testing.assert_allclose(_np(a), _np(b), **tol)
        jl = jax.tree.leaves(js)
        tl = leaves(ts)
        assert len(tl) == len(jl)
        for a, b in zip(tl, jl):
            assert a.dtype == torch.float32 and a.shape == b.shape
            np.testing.assert_allclose(_np(a), _np(b), **F32_TOL)


def test_adafactor_factors_exactly_the_reference_leaves():
    params = {k: np.zeros(s, np.float32) for k, s in
              {"a": (128, 128), "b": (127, 128), "c": (2, 130, 200),
               "d": (300,)}.items()}
    jstate = J.adafactor().init(_jax(params, jnp.float32))
    tstate = T.adafactor().init(_torch(params, torch.float32))
    assert jax.tree.map(lambda x: x.shape, jstate) == \
        {k: {s: tuple(x.shape) for s, x in v.items()}
         for k, v in tstate.items()}
    assert set(tstate["c"]) == {"vr", "vc"} and set(tstate["b"]) == {"v"}


def test_schedule_cosine_equals_the_reference():
    jlr = J.schedule_cosine(2e-3, warmup=10, total=100, min_frac=0.1)
    tlr = T.schedule_cosine(2e-3, warmup=10, total=100, min_frac=0.1)
    steps = np.arange(0, 130)
    want = np.asarray(jax.vmap(jlr)(jnp.asarray(steps, jnp.int32)))
    got = np.array([tlr(torch.tensor(int(s), dtype=torch.int32)).item()
                    for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ---- tests/test_serving_and_data.py's optimizer checks on the port -------

def _quad_loss_params():
    return {"w": torch.tensor([1.0, -2.0, 3.0]),
            "deep": {"v": torch.full((4, 4), 0.5)}}


@pytest.mark.parametrize("make_opt", [lambda: T.sgd(0.1),
                                      lambda: T.adamw(0.05),
                                      lambda: T.adafactor(0.05)],
                         ids=["sgd", "adamw", "adafactor"])
def test_optimizers_minimize_quadratic(make_opt):
    opt = make_opt()
    params = _quad_loss_params()
    state = opt.init(params)

    def loss(p):
        return sum(torch.sum(torch.square(x)) for x in leaves(p))

    l0 = float(loss(params))
    for step in range(60):
        flat = leaves(params)
        for x in flat:
            x.requires_grad_(True)
        g = torch.autograd.grad(loss(params), flat)
        grads = {"deep": {"v": g[0]}, "w": g[1]}
        params, state = opt.update(grads, state, params,
                                   torch.tensor(step))
    assert float(loss(params)) < 0.2 * l0


def test_adafactor_state_is_factored():
    opt = T.adafactor(0.05, min_dim_factored=4)
    params = {"big": torch.zeros((8, 16)), "small": torch.zeros((3,))}
    state = opt.init(params)
    assert set(state["big"].keys()) == {"vr", "vc"}
    assert state["big"]["vr"].shape == (8,)
    assert state["big"]["vc"].shape == (16,)
    assert state["small"]["v"].shape == (3,)


def test_schedule_cosine_shape():
    lr = T.schedule_cosine(1.0, warmup=10, total=100)
    assert float(lr(torch.tensor(0))) < 0.2
    assert float(lr(torch.tensor(10))) == pytest.approx(1.0, rel=0.05)
    assert float(lr(torch.tensor(100))) <= 0.2


def test_states_live_on_the_params_device():
    params = {"w": torch.zeros((3, 4), device="meta")}
    for opt in (T.adamw(), T.adafactor(min_dim_factored=2)):
        assert all(x.device.type == "meta" for x in leaves(opt.init(params)))
    assert T.sgd().init(params) == {}
