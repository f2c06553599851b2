"""The model path's fused selective scan (``kernels/selective_scan_train``)
and its route through ``models/ssm.mamba1_block``.

On the CPU: the op's plain version against a float64 recurrence written
here, a gradient check of it in float64, its refusals, and the op through
the block against the chunked twin (Falcon-Mamba's mixer norms off and
on).  With the ``cuda`` mark, on the card: the kernels against the plain
version, forward and every gradient, the block's route, the launch
counters and a deterministic backward.  No jax here, so the file runs on
the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_selective_scan.py
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import selective_scan_train as sst  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.layers import Init  # noqa: E402
from repro_torch.runtime import trace  # noqa: E402

NAMES = ("u", "delta", "A", "B", "C", "D", "z", "delta_bias")


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(b, length, d, n, seed=0, dtype=torch.float32, device="cpu",
            bc_dtype=None):
    """The op's operands from numpy draws: A as -exp of a log spread over
    [0, log N] (decays from fast to slow, as S4D-real's), Delta's bias
    near Mamba's initial range, z and B, C as strided views of wider
    tensors (as the model hands them over)."""
    rng = np.random.default_rng(seed)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a, np.float32)).to(device, dt)

    u = t(rng.normal(size=(b, length, d)))
    delta = t(rng.normal(size=(b, length, d)) * 0.5)
    wide_z = t(rng.normal(size=(b, length, 2 * d)))
    wide_bc = t(rng.normal(size=(b, length, 3 + 2 * n)), bc_dtype or dtype)
    a_log = rng.uniform(0.0, math.log(n), size=(d, n))
    A = t(-np.exp(a_log), torch.float64 if dtype == torch.float64
          else torch.float32)
    f = A.dtype
    D = t(rng.normal(size=(d,)), f)
    bias = t(np.log(np.expm1(rng.uniform(1e-3, 0.1, size=(d,)))), f)
    return (u, delta, A, wide_bc[..., 3:3 + n], wide_bc[..., 3 + n:], D,
            wide_z[..., d:], bias)


def _recurrence64(u, delta, A, B, C, D, z, bias):
    """The scan as its equations state it, in float64 numpy."""
    u, delta, A, B, C, D, z, bias = (np.asarray(t.detach().double())
                                     for t in (u, delta, A, B, C, D, z, bias))
    x = delta + bias
    dt = np.where(x > 20, x, np.log1p(np.exp(np.minimum(x, 20))))
    h = np.zeros((u.shape[0], u.shape[2], A.shape[1]))
    y = np.zeros(u.shape)
    for t in range(u.shape[1]):
        h = np.exp(dt[:, t, :, None] * A) * h \
            + (dt[:, t] * u[:, t])[..., None] * B[:, t, None, :]
        y[:, t] = (h * C[:, t, None, :]).sum(-1) + D * u[:, t]
    return y * z / (1 + np.exp(-z))


@pytest.mark.parametrize("length", [1, 16, 37])
def test_plain_matches_a_float64_recurrence(length):
    """Float32 state over at most 37 steps: 1e-5 of the output's largest
    value covers float32 rounding (the decay as exp2 of a product that
    rounds A * log2(e) once)."""
    ops = _inputs(2, length, 24, 16, seed=length)
    got = sst.selective_scan(*ops).double().numpy()
    want = _recurrence64(*ops)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_plain_op_passes_gradcheck_in_float64():
    ops = [t.detach().clone().requires_grad_()
           for t in _inputs(2, 5, 3, 4, seed=3, dtype=torch.float64)]
    assert torch.autograd.gradcheck(sst.selective_scan, ops, eps=1e-6,
                                    atol=1e-7, rtol=1e-5)


def _bf16(n=16):
    return _inputs(2, 8, 16, n, dtype=torch.bfloat16)


@pytest.mark.parametrize("make,match", [
    (lambda: _bf16(12), r"N=12"),
    (lambda: (_bf16()[0].float(),) + _bf16()[1:], r"bfloat16 on the card"),
    (lambda: _bf16()[:3] + (_bf16()[3].half(), _bf16()[4].half())
     + _bf16()[5:], r"B and C"),
    (lambda: _bf16()[:2] + (_bf16()[2].double(),) + _bf16()[3:],
     r"float32"),
], ids=["state", "u_dtype", "bc_dtype", "a_dtype"])
def test_card_checks_refuse_what_the_kernel_does_not_take(make, match):
    with pytest.raises(ValueError, match=match):
        sst._check_card(*make())


def test_op_refuses_shapes_devices_and_fake_tensors():
    ops = _inputs(2, 8, 16, 16)
    with pytest.raises(ValueError, match="batch, L, N"):
        sst.selective_scan(*ops[:3], ops[3][:, :4], *ops[4:])
    with pytest.raises(ValueError, match=r"\(D, N\)"):
        sst.selective_scan(ops[0], ops[1], ops[2][:8], *ops[3:])
    with pytest.raises(ValueError, match="CUDA or CPU"):
        sst.selective_scan(*(t.to("meta") for t in ops))
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = [mode.from_tensor(t.bfloat16() if i in (0, 1, 3, 4, 6) else t)
                for i, t in enumerate(ops)]
    with pytest.raises(ValueError, match="fake tensors"):
        sst._check_card(*fake)


def _block(eps, dtype="float32", seed=0, device="cpu"):
    cfg = get_config("falcon-mamba-7b", smoke=True).replace(
        mixer_rms_eps=eps, dtype=dtype)
    g = torch.Generator(device=device).manual_seed(seed)
    params = ssm.mamba1_init(Init(g, torch.device(device)), cfg)
    # Mamba's Delta bias (log-uniform Delta in [1e-3, 0.1]) and a non-zero
    # conv bias, so the state carries across chunks and every leaf moves
    rng = np.random.default_rng(seed)
    params["dt_bias"] = torch.as_tensor(np.log(np.expm1(
        rng.uniform(1e-3, 0.1, size=cfg.d_inner))), dtype=cfg.torch_dtype,
        device=device)
    params["conv_b"] = torch.as_tensor(rng.normal(size=cfg.d_inner) * 0.1,
                                       dtype=cfg.torch_dtype, device=device)
    x = torch.as_tensor(rng.normal(size=(2, 37, cfg.d_model)),
                        dtype=cfg.torch_dtype, device=device)
    return cfg, params, x


def _run_block(cfg, params, x, op, monkeypatch):
    """The block through the op (``op`` True) or the chunked twin, its
    output and every gradient."""
    monkeypatch.setattr(ssm, "_takes_kernel", lambda *a: op)
    ps = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    xs = x.detach().clone().requires_grad_()
    out, _ = ssm.mamba1_block(ps, xs, cfg)
    dout = torch.linspace(-1, 1, out.numel(), device=out.device).reshape(
        out.shape).to(out.dtype)
    grads = torch.autograd.grad(out, [xs] + list(ps.values()), dout)
    return out, dict(zip(["x"] + list(ps), grads))


@pytest.mark.parametrize("eps", [None, 1e-6], ids=["norms_off", "norms_on"])
def test_op_through_the_block_equals_the_twin(eps, monkeypatch):
    """Float32 on the CPU: the op (its plain version) and the chunked twin
    compute the same sums in other orders; 1e-5 of each tensor's largest
    value covers that over 37 steps (ragged against both chunks)."""
    cfg, params, x = _block(eps)
    out_op, g_op = _run_block(cfg, params, x, True, monkeypatch)
    out_tw, g_tw = _run_block(cfg, params, x, False, monkeypatch)
    assert (out_op - out_tw).abs().max() <= 1e-5 * out_tw.abs().max()
    for name in g_tw:
        want = g_tw[name]
        assert (g_op[name] - want).abs().max() <= 1e-5 * want.abs().max(), \
            name


def test_norms_change_the_block():
    cfg, params, x = _block(1e-6)
    with torch.no_grad():
        on, _ = ssm.mamba1_block(params, x, cfg)
        off, _ = ssm.mamba1_block(params, x, cfg.replace(mixer_rms_eps=None))
    assert (on - off).abs().max() > 0.1 * off.abs().max()


def test_the_cpu_keeps_the_twin_and_the_op_is_counted(monkeypatch):
    cfg, params, x = _block(1e-6)
    trace.enable()
    with torch.no_grad():
        ssm.mamba1_block(params, x, cfg)
        monkeypatch.setattr(ssm, "_takes_kernel", lambda *a: True)
        ssm.mamba1_block(params, x, cfg)
    got = trace.drain()
    scans = [s["attrs"] for s in got["spans"] if s["name"] == "ssm.scan"]
    assert [s["impl"] for s in scans] == ["chunked", "op"]
    assert scans[0] == {"impl": "chunked", "L": 37, "d_inner": cfg.d_inner,
                        "N": cfg.ssm_state}
    assert got["counters"] == {"ssm.kernel_calls": 1}


def test_the_stateful_step_keeps_the_twin():
    cfg, params, x = _block(None)
    cache = ssm.init_ssm_cache(2, cfg, "cpu")
    assert not ssm._takes_kernel(x.bfloat16(), cfg, cache)


def test_fake_cuda_tensors_keep_the_twin():
    cfg = get_config("falcon-mamba-7b", smoke=True).replace(
        dtype="bfloat16")
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = torch.empty((2, 8, cfg.d_model), dtype=torch.bfloat16,
                        device="cuda")
        assert x.is_cuda and not ssm._takes_kernel(x, cfg, None)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def _close(got, want, rel, ulps=0.0):
    """|got - want| <= ulps * |want| + rel * max |want|, elementwise."""
    got, want = got.double(), want.double()
    bound = ulps * want.abs() + rel * want.abs().max()
    return bool(((got - want).abs() <= bound).all()), \
        float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 300, 64, 16), (2, 4096, 1024, 16),
                                   (1, 70, 96, 8)])
@pytest.mark.parametrize("bc", ["bfloat16", "float32"])
def test_kernel_matches_plain(shape, bc, card):
    """Forward and every gradient against the plain version on the same
    card operands.  bfloat16 results (y, du, ddelta, dz; dB and dC when B
    and C are bfloat16) may round to a neighbouring value from float32
    sums taken in another order: 2**-7 of the value plus 1e-3 of the
    tensor's largest.  float32 sums over the batch and positions (dA, dD,
    ddelta_bias; dB, dC over the channels when float32): 1e-4 of the
    largest."""
    b, length, d, n = shape
    bcdt = getattr(torch, bc)
    ops = _inputs(b, length, d, n, seed=1, dtype=torch.bfloat16,
                  device=card, bc_dtype=bcdt)
    dy = _inputs(b, length, d, n, seed=2, dtype=torch.bfloat16,
                 device=card)[0]
    before = sst.selective_scan.launches, \
        sst.selective_scan.backward_launches
    leaves = [t.detach().clone().requires_grad_() for t in ops]
    y = sst.selective_scan(*leaves)
    grads = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert (sst.selective_scan.launches,
            sst.selective_scan.backward_launches) == \
        (before[0] + 1, before[1] + 1)
    plain = [t.detach().clone().requires_grad_() for t in ops]
    y_p = sst.scan_plain(*plain)
    grads_p = torch.autograd.grad(y_p, plain, dy)
    ok, err = _close(y, y_p, 1e-3, 2 ** -7)
    assert ok, ("y", err)
    for name, g, w in zip(NAMES, grads, grads_p):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        bf = g.dtype == torch.bfloat16
        ok, err = _close(g, w, 1e-3 if bf else 1e-4, 2 ** -7 if bf else 0.0)
        assert ok, (name, err)


@pytest.mark.cuda
def test_kernel_backward_is_deterministic(card):
    ops = _inputs(2, 1000, 512, 16, seed=4, dtype=torch.bfloat16,
                  device=card)
    dy = _inputs(2, 1000, 512, 16, seed=5, dtype=torch.bfloat16,
                 device=card)[0]
    y, hsave = sst.launch_forward(*ops, save=True)
    first = sst.launch_backward(*ops, hsave, dy)
    second = sst.launch_backward(*ops, hsave, dy)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("eps", [None, 1e-6], ids=["norms_off", "norms_on"])
def test_block_runs_the_kernel_on_the_card(eps, card, monkeypatch):
    """bfloat16 on the card: the op and the chunked twin round Delta, the
    gate and the products at other places (the twin rounds softplus'
    output to bfloat16), so they agree to 3e-2 of each tensor's
    largest value, as bfloat16 products of the same weights do."""
    cfg, params, x = _block(eps, "bfloat16", seed=1, device=card)
    assert ssm._takes_kernel(x, cfg, None)
    trace.enable()
    out_op, g_op = _run_block(cfg, params, x, True, monkeypatch)
    got = trace.drain()
    assert got["counters"]["ssm.kernel_calls"] == 1
    assert [s["attrs"]["impl"] for s in got["spans"]
            if s["name"] == "ssm.scan"] == ["op"]
    out_tw, g_tw = _run_block(cfg, params, x, False, monkeypatch)
    assert _close(out_op, out_tw, 3e-2)[0]
    for name in g_tw:
        ok, err = _close(g_op[name], g_tw[name], 3e-2)
        assert ok, (name, err)


@pytest.mark.cuda
def test_op_raises_instead_of_falling_back(card):
    ops = _inputs(2, 8, 16, 12, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="N=12"):
        sst.selective_scan(*ops)
