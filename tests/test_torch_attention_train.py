"""The model path's causal attention op (``repro_torch.kernels.
attention_train``) on the CPU, where it runs its plain PyTorch forward and
backward: against autograd through the flash twin
(``models.attention._flash_attention_jnp``) and the JAX reference's
``multihead_attention``, and the dispatch that routes the model to it.

The kernels themselves run only on the card: ``tests/test_torch_cuda.py``
holds them against these plain versions there.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.models import attention as j_attn  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import attention_train as at  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import decode_step, forward, init_cache, init_params, \
    prefill  # noqa: E402
from repro_torch.runtime import trace  # noqa: E402

# (B, Sq, Skv, H, KV, d, q_offset): causal at offset 0 and past it (Skv >
# Sq), GQA 4/2 and MQA, Sq off the kernel's 64-key tile, d 64, 80 and 128
CASES = [(2, 80, 80, 4, 4, 64, 0), (1, 48, 112, 4, 4, 80, 64),
         (2, 70, 70, 4, 2, 80, 0), (1, 100, 100, 4, 1, 128, 0),
         (1, 130, 130, 2, 2, 64, 0), (1, 40, 100, 4, 2, 128, 60)]


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def _inputs(b, sq, skv, h, kv, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in
            ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d), (b, sq, h, d))]


def _twin(q, k, v, off):
    pos = off + torch.arange(q.shape[1])
    return t_attn._flash_attention_jnp(q, k, v, True, pos, None, 32)


def _grads(fn, arrays, dtype):
    """fn's output and the gradients of <output, dO> in q, k, v."""
    q, k, v, do = (torch.tensor(a, dtype=dtype) for a in arrays)
    for t in (q, k, v):
        t.requires_grad_(True)
    out = fn(q, k, v)
    out.backward(do)
    return [t.detach().float() for t in (out, q.grad, k.grad, v.grad)]


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_op_forward_and_backward_match_the_twin(case, dtype):
    """o, dq, dk and dv of the op against autograd through the flash twin.

    float32: the same sums in another order (online softmax by 64-key
    tiles against the twin's 32, base 2 against e), 2e-5 of the largest
    value.  bfloat16: both round at other points (the twin rounds q *
    scale and each tile's P.V, dP and dV products to bf16; the op rounds P
    and the outputs), so each is held to the float32 twin on the same
    bf16-valued inputs: the op's error is at most 2e-2 of the largest
    value (about 2.5 bf16 ulps) and no more than the bf16 twin's own plus
    one bf16 ulp (2 ** -8)."""
    b, sq, skv, h, kv, d, off = case
    arrays = _inputs(b, sq, skv, h, kv, d)
    op = lambda q, k, v: at.attention_train(q, k, v, q_offset=off)  # noqa
    twin = lambda q, k, v: _twin(q, k, v, off)  # noqa
    if dtype == "float32":
        for got, want in zip(_grads(op, arrays, torch.float32),
                             _grads(twin, arrays, torch.float32)):
            assert _rel(got, want) < 2e-5
        return
    bf = [np.asarray(torch.tensor(a).bfloat16().float()) for a in arrays]
    exact = _grads(twin, bf, torch.float32)
    got = _grads(op, bf, torch.bfloat16)
    low = _grads(twin, bf, torch.bfloat16)
    for name, g, lo, want in zip("o dq dk dv".split(), got, low, exact):
        err, twin_err = _rel(g, want), _rel(lo, want)
        assert err < 2e-2, (name, err)
        assert err <= twin_err + 2 ** -8, (name, err, twin_err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_op_forward_matches_the_reference(case, dtype):
    """The op's forward against the JAX reference's multihead_attention
    (flash twin, causal, query i at q_offset + i) on the same values:
    2e-5 of the largest value in float32; in bfloat16, 2e-2 (both round
    P and the output to bf16 at other points)."""
    b, sq, skv, h, kv, d, off = case
    q, k, v, _ = _inputs(b, sq, skv, h, kv, d)
    tdt = getattr(torch, dtype)
    got = at.attention_train(*(torch.tensor(a, dtype=tdt) for a in (q, k, v)),
                             q_offset=off).float()
    want = j_attn.multihead_attention(
        *(jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in (q, k, v)),
        causal=True, q_positions=off + jnp.arange(sq), impl="flash_jnp",
        block_kv=32)
    want = torch.tensor(np.asarray(want.astype(jnp.float32)))
    assert _rel(got, want) < (2e-5 if dtype == "float32" else 2e-2)


def test_op_refuses_what_it_does_not_take():
    q, k, v, _ = (torch.tensor(a) for a in _inputs(1, 8, 8, 4, 2, 64))
    with pytest.raises(ValueError, match="keys"):
        at.attention_train(q, k, v, q_offset=1)
    with pytest.raises(ValueError, match="dividing"):
        at.attention_train(q, k[:, :, :1].expand(1, 8, 3, 64),
                           v[:, :, :1].expand(1, 8, 3, 64))
    with pytest.raises(ValueError, match="dtypes"):
        at.attention_train(q, k.bfloat16(), v)


def _like(device_cuda, dtype, d):
    return SimpleNamespace(is_cuda=device_cuda, dtype=dtype,
                           shape=(1, 2048, 4, d))


@pytest.mark.parametrize("cuda,dtype,d,causal,offset,mask,takes", [
    (True, torch.bfloat16, 80, True, 0, None, True),
    (True, torch.bfloat16, 128, True, 512, None, True),
    (False, torch.bfloat16, 80, True, 0, None, False),    # CPU tensors
    (True, torch.float32, 80, True, 0, None, False),      # float32 models
    (True, torch.bfloat16, 256, True, 0, None, False),    # no instantiation
    (True, torch.bfloat16, 80, False, 0, None, False),    # non-causal, cross
    (True, torch.bfloat16, 80, True, None, None, False),  # offset not known
    (True, torch.bfloat16, 80, True, 0, "rows", False),   # a per-row mask
])
def test_auto_takes_the_kernel_only_where_the_input_allows(
        cuda, dtype, d, causal, offset, mask, takes):
    assert t_attn._takes_kernel(_like(cuda, dtype, d), causal, offset,
                                mask) is takes


def test_auto_keeps_the_twin_on_fake_cuda_tensors():
    """A dry run's fake CUDA tensors have no memory to launch on: 'auto'
    keeps the twin for them past 1024 queries, and the op refuses them
    rather than launching."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        q, k, v = (torch.empty(1, 1100, 2, 80, dtype=torch.bfloat16,
                               device="cuda") for _ in range(3))
        assert q.is_cuda and not t_attn._takes_kernel(q, True, 0, None)
        with pytest.raises(ValueError, match="fake"):
            at.attention_train(q, k, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_auto_keeps_the_twin_on_the_cpu(dtype, causal):
    """Past 1024 queries on CPU tensors 'auto' runs the flash twin, equal
    to it bit for bit, and counts no kernel call."""
    q, k, v, _ = (torch.tensor(a, dtype=dtype)
                  for a in _inputs(1, 1100, 1100, 2, 1, 64, seed=3))
    args = dict(causal=causal, block_kv=512)
    trace.enable()
    auto = t_attn.multihead_attention(q, k, v, impl="auto", q_offset=0,
                                      **args)
    got = trace.drain()
    flash = t_attn.multihead_attention(q, k, v, impl="flash_jnp",
                                       q_positions=torch.arange(1100), **args)
    assert torch.equal(auto, flash)
    assert [s["attrs"]["impl"] for s in got["spans"]] == ["flash_jnp"]
    assert "attn.kernel_calls" not in got["counters"]


def test_cuda_impl_runs_the_op_and_counts_it():
    """impl='cuda' on CPU tensors runs the op's plain versions (forward
    and backward through its autograd Function), names itself on the
    span and counts one kernel call a forward."""
    arrays = _inputs(2, 70, 70, 4, 2, 80, seed=5)
    q, k, v, do = (torch.tensor(a, requires_grad=i < 3)
                   for i, a in enumerate(arrays))
    trace.enable()
    out = t_attn.multihead_attention(q, k, v, causal=True, impl="cuda",
                                     q_offset=0)
    got = trace.drain()
    assert [s["attrs"]["impl"] for s in got["spans"]] == ["cuda"]
    assert got["counters"] == {"attn.kernel_calls": 1}
    assert out.grad_fn is not None and "AttentionTrain" in \
        type(out.grad_fn).__name__
    assert torch.equal(out, at.attention_train(q, k, v, q_offset=0))
    out.backward(do)
    assert all(t.grad is not None for t in (q, k, v))


@pytest.mark.parametrize("kw", [
    dict(causal=False, q_offset=0),
    dict(causal=True, q_positions=torch.arange(8)),
    dict(causal=True, q_offset=0,
         kv_len_mask=(torch.arange(8) < 6).expand(1, 8))])
def test_cuda_impl_refuses_what_the_kernel_cannot_mask(kw):
    q, k, v, _ = (torch.tensor(a) for a in _inputs(1, 8, 8, 2, 2, 64))
    with pytest.raises(ValueError, match="causal"):
        t_attn.multihead_attention(q, k, v, impl="cuda", **kw)


@pytest.mark.parametrize("impl", ["dense", "flash_jnp"])
def test_q_offset_places_queries_as_their_positions_do(impl):
    """A host q_offset masks as q_positions = q_offset + arange(sq) does,
    bit for bit; the two together are refused (one source of the mask)."""
    q, k, v, _ = (torch.tensor(a) for a in _inputs(1, 40, 100, 4, 2, 64))
    args = dict(causal=True, impl=impl, block_kv=32)
    got = t_attn.multihead_attention(q, k, v, q_offset=60, **args)
    want = t_attn.multihead_attention(q, k, v, q_positions=60 + torch.arange(
        40), **args)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="not both"):
        t_attn.multihead_attention(q, k, v, q_offset=60,
                                   q_positions=60 + torch.arange(40), **args)


def test_cuda_impl_through_the_model_equals_the_twin():
    """stablelm-3b smoke (float32) with attn_impl 'cuda' against
    'flash_jnp': the training forward (offset 0), the prefill into a cache
    longer than the prompt (offset 0, the cache's unfilled tail masked by
    causality alone) and two decode steps (offset cache.pos), one kernel
    call a layer in each of the four passes."""
    base = get_config("stablelm-3b", smoke=True)
    params = init_params(base, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(1, base.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    outs = {}
    for impl in ("flash_jnp", "cuda"):
        cfg = base.replace(attn_impl=impl)
        trace.enable()
        logits, _ = forward(cfg, params, {"tokens": toks})
        cache = init_cache(cfg, 2, 20, "cpu")
        last, cache = prefill(cfg, params, {"tokens": toks}, cache)
        steps = [last]
        for _ in range(2):
            nxt = steps[-1].argmax(-1)[:, None]
            step, cache = decode_step(cfg, params, nxt, cache)
            steps.append(step)
        counters = trace.drain()["counters"]
        outs[impl] = (logits, torch.stack(steps), counters)
    for got, want in zip(outs["cuda"][:2], outs["flash_jnp"][:2]):
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    # forward, prefill and 2 decode steps, each once a layer
    assert outs["cuda"][2].get("attn.kernel_calls") == 4 * base.n_layers
    assert "attn.kernel_calls" not in outs["flash_jnp"][2]
