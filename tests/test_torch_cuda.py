"""The Hopper kernels on the card against their plain PyTorch versions, and
the port's paths that run on the card (the DSE, the benches, the smoke
models against their pinned reference outputs, the serving launcher, and
training: the smoke train steps, checkpoints of card tensors and the
training launcher).

These tests need an NVIDIA card (a CUDA kernel has no CPU mode) and skip
without one, apart from the control of the tight bfloat16 attention
tolerance, which runs on the CPU.  They import no jax, so they run on the
machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import attention_train as at  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import tiled_matmul as tm  # noqa: E402

# tests/test_kernels.py::test_tiled_matmul_sweep's shapes
SHAPES = [(128, 128, 128, 64, 64, 64), (256, 192, 64, 64, 64, 32),
          (64, 64, 256, 32, 32, 128), (128, 256, 128, 128, 128, 128)]
DTYPES = {"float32": (torch.float32, 2e-5, 1.6e-4),
          "bfloat16": (torch.bfloat16, 2e-2, 0.16),
          "int8": (torch.int8, 0.0, 0.0)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _operands(m, n, k, dtype, device):
    rng = np.random.default_rng(0)
    if dtype == "int8":
        xs = rng.integers(-1, 2, (m, k)), rng.integers(-1, 2, (k, n))
    else:
        xs = rng.normal(size=(m, k)), rng.normal(size=(k, n))
    tdt = DTYPES[dtype][0]
    return tuple(torch.as_tensor(a.astype(np.float32)).to(device).to(tdt)
                 for a in xs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("order", ["out", "a", "b"])
@pytest.mark.parametrize("m,n,k,bm,bn,bk", SHAPES)
def test_kernel_matches_plain(m, n, k, bm, bn, bk, order, dtype, card):
    x, y = _operands(m, n, k, dtype, card)
    before = tm.tiled_matmul.launches
    got = ops.matmul(x, y, bm=bm, bn=bn, bk=bk, order=order)
    assert tm.tiled_matmul.launches == before + 1
    want = tm.tiled_matmul_plain(x, y, bm=bm, bn=bn, bk=bk, order=order)
    _, rtol, atol = DTYPES[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


# float32 blocks the bridge lowers (bm = 1, bn = 2, bk = 2, odd widths), a
# 128x256 tile (accumulator in shared memory) and bk not a multiple of 4
F32_SHAPES = [(192, 512, 48, 96, 4, 16), (192, 512, 48, 64, 2, 16),
              (256, 512, 48, 128, 256, 12), (192, 512, 48, 1, 512, 2),
              (192, 256, 384, 96, 128, 192), (192, 512, 48, 64, 32, 6),
              (96, 80, 45, 3, 5, 9)]


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["out", "a", "b"])
@pytest.mark.parametrize("m,n,k,bm,bn,bk", F32_SHAPES)
def test_float32_blocks_the_bridge_lowers(m, n, k, bm, bn, bk, order, card):
    x, y = _operands(m, n, k, "float32", card)
    before = tm.tiled_matmul.launches
    got = tm.tiled_matmul(x, y, bm=bm, bn=bn, bk=bk, order=order)
    assert tm.tiled_matmul.launches == before + 1
    want = tm.tiled_matmul_plain(x, y, bm=bm, bn=bn, bk=bk, order=order)
    _, rtol, atol = DTYPES["float32"]
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["out", "a", "b"])
def test_float32_operands_off_16_byte_alignment(order, card):
    """Contiguous views one and two floats into their storage take the
    4-byte copies."""
    x0, y0 = _operands(64, 64, 64, "float32", card)
    x = torch.empty(x0.numel() + 1, device=card)[1:].view(64, 64)
    y = torch.empty(y0.numel() + 2, device=card)[2:].view(64, 64)
    x.copy_(x0)
    y.copy_(y0)
    assert x.data_ptr() % 16 and y.data_ptr() % 16
    got = tm.tiled_matmul(x, y, bm=32, bn=64, bk=32, order=order)
    want = tm.tiled_matmul_plain(x0, y0, bm=32, bn=64, bk=32, order=order)
    _, rtol, atol = DTYPES["float32"]
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


# the bfloat16/int8 blocks the bridge lowers, at reduced widths (M, N, K;
# (64,2,16) "a" runs four steps an iteration), and a one-fragment block
# whose "b" sweep does
LOWBIT_SHAPES = [(128, 8, 48, 64, 2, 16), (256, 512, 36, 128, 256, 12),
                 (192, 512, 96, 96, 256, 48), (128, 128, 768, 64, 64, 384),
                 (4, 1024, 6, 1, 512, 2), (9, 10, 27, 3, 5, 9),
                 (64, 16, 6, 16, 8, 2)]
LOWBIT = ("bfloat16", "int8")


def _full_range(m, n, k, dtype, device, seed=0):
    """int8 uniform over [-128, 127]; bfloat16 normal."""
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        return tuple(torch.as_tensor(rng.integers(-128, 128, shape).astype(
            np.int8)).to(device) for shape in ((m, k), (k, n)))
    return tuple(torch.as_tensor(rng.normal(size=shape).astype(np.float32)
                                 ).to(device).to(torch.bfloat16)
                 for shape in ((m, k), (k, n)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", LOWBIT)
@pytest.mark.parametrize("order", ["out", "a", "b"])
@pytest.mark.parametrize("m,n,k,bm,bn,bk", LOWBIT_SHAPES)
def test_lowbit_blocks_the_bridge_lowers(m, n, k, bm, bn, bk, order, dtype,
                                         card):
    x, y = _full_range(m, n, k, dtype, card)
    before = tm.tiled_matmul.launches
    got = tm.tiled_matmul(x, y, bm=bm, bn=bn, bk=bk, order=order)
    assert tm.tiled_matmul.launches == before + 1
    want = tm.tiled_matmul_plain(x, y, bm=bm, bn=bn, bk=bk, order=order)
    _, rtol, atol = DTYPES[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", LOWBIT)
@pytest.mark.parametrize("order", ["out", "a", "b"])
def test_lowbit_operands_off_16_byte_alignment(order, dtype, card):
    """Contiguous views one and three elements into their storage take
    narrower copies, or none."""
    x0, y0 = _full_range(64, 64, 64, dtype, card, seed=1)
    x = torch.empty(x0.numel() + 1, dtype=x0.dtype, device=card)[1:]
    y = torch.empty(y0.numel() + 3, dtype=y0.dtype, device=card)[3:]
    x, y = x.view(64, 64), y.view(64, 64)
    x.copy_(x0)
    y.copy_(y0)
    assert x.data_ptr() % 16 and y.data_ptr() % 16
    got = tm.tiled_matmul(x, y, bm=32, bn=64, bk=32, order=order)
    want = tm.tiled_matmul_plain(x0, y0, bm=32, bn=64, bk=32, order=order)
    _, rtol, atol = DTYPES[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["out", "a", "b"])
def test_int8_partials_of_exactly_2_to_24(order, card):
    """x = y = -128 at K = 1024: every product is 2^14 and every dot 2^24,
    which float32 holds exactly; one K-block saturates it to 127, four
    K-blocks saturate 2^22 each ("a"/"b" then add 127s in int8, wrapping)."""
    x = torch.full((32, 1024), -128, dtype=torch.int8, device=card)
    y = torch.full((1024, 32), -128, dtype=torch.int8, device=card)
    for bk in (1024, 256):
        got = tm.tiled_matmul(x, y, bm=16, bn=32, bk=bk, order=order)
        want = tm.tiled_matmul_plain(x, y, bm=16, bn=32, bk=bk, order=order)
        assert torch.equal(got, want)
        if order == "out" or bk == 1024:
            assert bool((got == 127).all())


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["out", "a", "b"])
def test_int8_full_range_at_k_3072(order, card):
    x, y = _full_range(64, 64, 3072, "int8", card, seed=2)
    got = tm.tiled_matmul(x, y, bm=32, bn=64, bk=256, order=order)
    want = tm.tiled_matmul_plain(x, y, bm=32, bn=64, bk=256, order=order)
    assert torch.equal(got, want)


def _past_2_to_24(seed=0):
    """tests/test_torch_kernels.py's int8 probe (M = N = 8, K = 3072):
    runs of +127 then -127 against y = +-127 or 126 take the running sums
    past 2^24, then a -1/0/1 tail against y = 1 lands them in [-128, 127]
    (or one run longer, saturated)."""
    rng = np.random.default_rng(seed)
    k, head = 3072, 2410
    x = np.zeros((8, k), np.int64)
    for i in range(8):
        up = int(rng.integers(1041, 1206))
        down = up + (i % 3) - 1 if i % 4 == 3 else up
        x[i, :up] = 127
        x[i, up:up + down] = -127
        x[i, head:] = rng.integers(-1, 2, k - head)
    y = np.ones((k, 8), np.int64)
    y[:head] = rng.choice([127, -127, 126], size=8)[None, :]
    return x, y


def _int8_exact(x, y, bk, order):
    """int64 sums and the saturating cast, of all of K ("out") or of each
    K-block's partial, added in int8 with wrap-around ("a"/"b")."""
    if order == "out":
        return np.clip(x @ y, -128, 127).astype(np.int8)
    out = np.zeros((x.shape[0], y.shape[1]), np.int64)
    for k0 in range(0, x.shape[1], bk):
        partial = np.clip(x[:, k0:k0 + bk] @ y[k0:k0 + bk], -128, 127)
        out = (out + partial + 128) % 256 - 128
    return out.astype(np.int8)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["out", "a", "b"])
@pytest.mark.parametrize("bk", [3072, 1536])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_int8_running_sums_past_2_to_24_on_the_card(seed, bk, order, card):
    xa, ya = _past_2_to_24(seed)
    exact = torch.as_tensor(_int8_exact(xa, ya, bk, order))
    x, y = (torch.as_tensor(a.astype(np.int8)).to(card) for a in (xa, ya))
    got = tm.tiled_matmul(x, y, bm=8, bn=8, bk=bk, order=order)
    want = tm.tiled_matmul_plain(x, y, bm=8, bn=8, bk=bk, order=order)
    assert torch.equal(got.cpu(), exact)
    assert torch.equal(want.cpu(), exact)


@pytest.mark.cuda
def test_int8_overflow_on_the_card(card):
    x = torch.ones((8, 256), dtype=torch.int8, device=card)
    y = torch.ones((256, 8), dtype=torch.int8, device=card)
    for order, want in (("out", 127), ("a", -2), ("b", -2)):
        got = tm.tiled_matmul(x, y, bm=8, bn=8, bk=128, order=order)
        assert bool((got == want).all())


@pytest.mark.cuda
def test_wrapper_raises_instead_of_falling_back(card):
    x = torch.ones((64, 64), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        tm.tiled_matmul(x.t(), x)
    with pytest.raises(ValueError, match="shared memory"):
        tm.tiled_matmul(torch.ones((512, 512), device=card),
                        torch.ones((512, 512), device=card),
                        bm=512, bn=512, bk=512)


# tests/test_kernels.py::test_flash_attention_sweep's shapes, plus an odd
# block and size-1 blocks, which the bridge's lowering produces
ATTN_SHAPES = [(2, 128, 128, 64, 64, 64), (4, 64, 256, 32, 32, 64),
               (1, 256, 256, 128, 128, 128), (2, 96, 96, 32, 3, 96),
               (2, 64, 64, 16, 1, 1), (12, 512, 512, 64, 256, 16),
               # one case for each branch of attention_plan: bkv = 1 (one
               # key lane, the rest split d) and 2; bq = 1; a q-block split
               # over 8 CTAs; runs of thin blocks, double buffered; d = 16
               # (key lanes share the P.V columns) and d = 128 (32 lanes a
               # row); the odd block 3 as bkv (keys past the block); Sq !=
               # Skv, causal, both ways; a block walked in two chunks; two
               # column passes (d = 256, d = 12) and single values (d = 7);
               # K and V read straight from device memory (two rows a CTA
               # at 128-key blocks); the full-width thin config
               (2, 64, 64, 64, 16, 1), (2, 64, 64, 32, 32, 2),
               (2, 64, 64, 64, 1, 32), (2, 256, 256, 64, 128, 32),
               (2, 128, 128, 64, 64, 4), (2, 64, 64, 16, 16, 32),
               (2, 128, 128, 128, 32, 64), (2, 48, 48, 64, 48, 3),
               (2, 64, 128, 32, 16, 32), (2, 128, 64, 32, 32, 16),
               (1, 32, 2048, 16, 16, 1024), (1, 32, 32, 256, 16, 16),
               (2, 32, 48, 12, 8, 16), (1, 16, 16, 7, 4, 4),
               (2, 64, 256, 64, 2, 128), (12, 512, 512, 64, 256, 2),
               # one case for each branch of the bfloat16 tensor-core plan
               # (mma_plan): four key warps at bq = 16; d = 256 in column
               # passes beside two key warps; d = 12 zero-padded; blocks of
               # 24 and 48 keys (not multiples of 16); Sq != Skv, causal,
               # both ways (the 1024-key block above runs in chunks)
               (2, 128, 128, 64, 16, 64), (1, 64, 64, 256, 32, 32),
               (2, 64, 64, 12, 16, 32), (2, 96, 96, 64, 32, 24),
               (2, 96, 96, 32, 16, 48), (1, 48, 96, 64, 16, 48),
               (1, 96, 48, 64, 48, 16)]
ATTN_DTYPES = {"float32": (torch.float32, 2e-5, 1.6e-4),
               "bfloat16": (torch.bfloat16, 3e-2, 0.24)}
# bfloat16 is also held at a tight (rtol, atol), as in chip_smoke.py: a sound
# body stays within one bf16 ulp of the plain version, while a skipped
# diagonal KV block passes (3e-2, 0.24) at BERT-base
# (test_tight_bfloat16_tolerance_rejects_a_skipped_diagonal_block)
ATTN_TIGHT = {"float32": (2e-5, 1.6e-4), "bfloat16": (1e-2, 1e-2)}
# chip_smoke.ATTN_FIXED's configs at bq >= 16 and bkv >= 16
ATTN_WIDE = [(16, 128), (256, 256), (128, 128), (256, 64), (256, 16),
             (512, 128)]


def _assert_attention_close(got, want, dtype):
    """Kernel == plain at the dtype's tolerance and at ATTN_TIGHT."""
    for rtol, atol in (ATTN_DTYPES[dtype][1:], ATTN_TIGHT[dtype]):
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)
# tests/test_kernels.py::test_mamba_scan_sweep's shapes, plus a d-block
# wider than one kernel block's threads and N = 5 (not a power of two)
SCAN_SHAPES = [(1, 32, 16, 8, 8, 8), (2, 64, 32, 16, 16, 16),
               (2, 128, 64, 8, 32, 32), (1, 64, 192, 16, 4, 192),
               (1, 16, 24, 5, 16, 3),
               # one case for each branch of scan_plan: 1, 2, 4, 8 and 16
               # states a thread; N = 1, 5 (4 states, ragged) and 128;
               # splits over 2, 5 (N = 33) and 8 CTAs with two passes; B = 3 at
               # chunk = d_block = 1; chunks staged in registers, by cp.async
               # a half at a time, and not ahead; a long chain at a narrow D
               (1, 16, 4, 16, 16, 2), (1, 16, 2, 16, 16, 1),
               (1, 16, 4, 16, 16, 4),
               (1, 32, 8, 16, 16, 8), (1, 8, 64, 64, 4, 64),
               (1, 8, 64, 128, 4, 64), (1, 8, 16, 1, 4, 16),
               (1, 20, 40, 5, 20, 40), (1, 8, 70, 33, 2, 70),
               (1, 16, 1024, 16, 4, 1024), (3, 12, 24, 16, 1, 1),
               (1, 256, 512, 16, 128, 512), (2, 64, 8, 16, 64, 1),
               (1, 8, 2, 125, 1, 1), (1, 2048, 32, 16, 64, 16)]


def _normal(shape, dtype, device, rng):
    return torch.as_tensor(rng.normal(size=shape).astype(np.float32)
                           ).to(device).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(ATTN_DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,sq,skv,d,bq,bkv", ATTN_SHAPES)
def test_flash_attention_matches_plain(h, sq, skv, d, bq, bkv, causal,
                                       dtype, card):
    rng = np.random.default_rng(1)
    tdt = ATTN_DTYPES[dtype][0]
    q = _normal((h, sq, d), tdt, card, rng)
    k, v = (_normal((h, skv, d), tdt, card, rng) for _ in range(2))
    before = fa.flash_attention.launches
    got = ops.attention(q, k, v, causal=causal, bq=bq, bkv=bkv)
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == tdt
    want = fa.flash_attention_plain(q, k, v, causal=causal, bq=bq, bkv=bkv)
    _assert_attention_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(ATTN_DTYPES))
def test_flash_attention_operands_off_16_byte_alignment(dtype, card):
    """Operands that start one element past 16 bytes: the plan takes single
    values, and the kernel still equals its plain version."""
    rng = np.random.default_rng(8)
    tdt = ATTN_DTYPES[dtype][0]
    q, k, v = (_normal((2, 64, 64), tdt, card, rng) for _ in range(3))
    shifted = []
    for t in (q, k, v):
        buf = torch.empty(t.numel() + 1, dtype=tdt, device=card)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        shifted.append(view)
    assert not fa.starts_aligned(*shifted)
    assert fa.attention_plan(16, 16, 64, shifted[0].element_size(),
                             False).vec == 1
    got = fa.flash_attention(*shifted, causal=True, bq=16, bkv=16)
    want = fa.flash_attention_plain(q, k, v, causal=True, bq=16, bkv=16)
    _assert_attention_close(got, want, dtype)


@pytest.mark.cuda
def test_flash_attention_launch_refuses_a_bad_plan(card):
    rng = np.random.default_rng(9)
    q, k, v = (_normal((2, 128, 64), torch.float32, card, rng)
               for _ in range(3))
    kw = dict(causal=True, bq=64, bkv=32, scale=64 ** -0.5)
    plan = fa.attention_plan(64, 32, 64, 4)
    formula = int(fa.smem_bytes(64, 32, 64, 4))
    for bad in (plan._replace(threads=plan.threads + 32),
                plan._replace(rows=8),
                plan._replace(keys=32),
                plan._replace(lanes=12),
                plan._replace(key_lanes=plan.key_lanes * 2),
                plan._replace(split=3),
                plan._replace(chunks=plan.chunks + 1),
                plan._replace(stage=2),
                plan._replace(smem=plan.smem + 16),
                plan._replace(run=formula, smem=formula + 16)):
        before = fa.flash_attention.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            fa.launch(q, k, v, plan=bad, **kw)
        assert fa.flash_attention.launches == before
    got = fa.launch(q, k, v, plan=plan, **kw)
    torch.testing.assert_close(got, fa.flash_attention_plain(
        q, k, v, causal=True, bq=64, bkv=32), rtol=2e-5, atol=1.6e-4)


@pytest.mark.cuda
def test_bert_base_bfloat16_takes_the_tensor_core_body(card):
    """BERT-base (12, 512, 64), causal, bfloat16 at the tuned (16, 128):
    the plan names the tensor-core body with four key warps, one call is
    one launch, of that body, and it equals the plain version."""
    rng = np.random.default_rng(10)
    q, k, v = (_normal((12, 512, 64), torch.bfloat16, card, rng)
               for _ in range(3))
    plan = fa.attention_plan(16, 128, 64, 2, fa.starts_aligned(q, k, v))
    assert (plan.body, plan.key_warps, plan.threads) == (
        fa.BODY_TENSOR, 4, 128)
    before = fa.flash_attention.launches
    bodies = list(fa.flash_attention.body_launches)
    got = fa.flash_attention(q, k, v, causal=True, bq=16, bkv=128)
    assert fa.flash_attention.launches == before + 1
    assert fa.flash_attention.body_launches == [
        bodies[0], bodies[1] + 1]
    want = fa.flash_attention_plain(q, k, v, causal=True, bq=16, bkv=128)
    _assert_attention_close(got, want, "bfloat16")


def _skip_diagonal_block(q, k, v, want, bq, bkv):
    """The plain output with the rows of the last q-block that reach the
    last KV block recomputed without it: what a body that skipped its
    diagonal block there would give."""
    s, d = q.shape[1], q.shape[2]
    k0 = s - bkv
    first = max(s - bq, k0)
    logits = q[:, first:].float() @ k[:, :k0].float().transpose(1, 2)
    bad = want.clone()
    bad[:, first:] = (torch.softmax(logits * d ** -0.5, dim=-1)
                      @ v[:, :k0].float()).to(want.dtype)
    return bad


@pytest.mark.parametrize("bq,bkv", ATTN_WIDE)
def test_tight_bfloat16_tolerance_rejects_a_skipped_diagonal_block(bq, bkv):
    """The control of ATTN_TIGHT, on the CPU: at BERT-base bfloat16 the
    output of a body that skips the last q-block's diagonal KV block
    fails the tight tolerance."""
    rng = np.random.default_rng(10)
    q, k, v = (_normal((12, 512, 64), torch.bfloat16, "cpu", rng)
               for _ in range(3))
    want = fa.flash_attention_plain(q, k, v, causal=True, bq=bq, bkv=bkv)
    bad = _skip_diagonal_block(q, k, v, want, bq, bkv)
    rtol, atol = ATTN_TIGHT["bfloat16"]
    assert not torch.allclose(bad.float(), want.float(), rtol=rtol,
                              atol=atol)


@pytest.mark.cuda
def test_tensor_core_launch_refuses_a_bad_plan(card):
    rng = np.random.default_rng(11)
    q, k, v = (_normal((2, 128, 64), torch.bfloat16, card, rng)
               for _ in range(3))
    kw = dict(causal=True, bq=16, bkv=128, scale=64 ** -0.5)
    plan = fa.attention_plan(16, 128, 64, 2)
    assert plan.body == fa.BODY_TENSOR
    for bad in (plan._replace(key_warps=plan.key_warps + 1),
                plan._replace(key_warps=1),
                plan._replace(keys=24),
                plan._replace(keys=plan.keys * 4),
                plan._replace(chunks=plan.chunks + 1),
                plan._replace(threads=plan.threads + 32),
                plan._replace(warp_rows=8),
                plan._replace(vec=4),
                plan._replace(split=3),
                plan._replace(col_passes=2),
                plan._replace(stage=fa.STAGE_DIRECT),
                plan._replace(run=2),
                plan._replace(smem=plan.smem + 16),
                plan._replace(body=2)):
        before = fa.flash_attention.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            fa.launch(q, k, v, plan=bad, **kw)
        assert fa.flash_attention.launches == before
    with pytest.raises(RuntimeError, match="launch failed"):
        fa.launch(q.float(), k.float(), v.float(), plan=plan, **kw)
    got = fa.launch(q, k, v, plan=plan, **kw)
    _assert_attention_close(got, fa.flash_attention_plain(
        q, k, v, causal=True, bq=16, bkv=128), "bfloat16")


@pytest.mark.cuda
def test_flash_attention_bshd_gqa(card):
    rng = np.random.default_rng(2)
    q = _normal((2, 128, 8, 32), torch.float32, card, rng)
    k = _normal((2, 128, 2, 32), torch.float32, card, rng)
    v = _normal((2, 128, 2, 32), torch.float32, card, rng)
    got = ops.attention_bshd(q, k, v, causal=True, bq=64, bkv=64)
    want = ops.attention_bshd(q, k, v, causal=True, use_kernel=False)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-4)


# The model path's attention kernels (B, Sq, Skv, H, KV, d, q_offset): the
# cells' shapes (stablelm-3b and olmoe-1b-7b training at 4 x 4096, the
# stablelm prefill of 3824 queries into a 3840-key cache), chatglm3's GQA
# 32/2 at 2048, and a chunk of 1536 queries at offset 512
ATTN_TRAIN = [(4, 4096, 4096, 32, 32, 80, 0), (4, 4096, 4096, 16, 16, 128, 0),
              (16, 3824, 3840, 32, 32, 80, 0), (1, 2048, 2048, 32, 2, 128, 0),
              (2, 1536, 2048, 32, 32, 80, 512)]
# Kernel against plain, row by row: the largest difference in a row (one
# query's or one key's d values) over that row's own largest value.  Both
# take bf16 products with float32 sums, in another order, and the kernel's
# exponentials are ex2.approx (2 ulps of float32); each output rounds to
# bf16 once, so two sound results differ by at most one bf16 ulp of an
# element, 2 ** -7 of it at worst.  A skipped or doubled KV or query tile
# moves each row it reaches by a share of that row, far past 1e-2.  Rows
# below a thousandth of the tensor's largest value are held to that
# thousandth (query 0's dq, where dS cancels to rounding).
ATTN_TRAIN_TOL = 1e-2
# lse, against its largest value: a float32 log-sum-exp in base 2 whose
# error scales P by 2 ** err
ATTN_LSE_TOL = 1e-5
# The kernel against the flash twin, row by row: the twin rounds q * scale
# to bf16 and P against a running max over 1024-key blocks, so the two
# differ by more than an ulp (1.0e-2 at the auto-route test's shape and
# seed, on an H100); this checks the route, the plain op the arithmetic.
TWIN_TOL = 2e-2


def _attention_train_inputs(b, sq, skv, h, kv, d, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=device
                        ).to(torch.bfloat16)
            for shape in ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d),
                          (b, sq, h, d))]


def _rel_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


def _row_err(got, want):
    got, want = got.float(), want.float()
    top = want.abs().amax(dim=-1)
    return ((got - want).abs().amax(dim=-1)
            / top.clamp(min=1e-3 * top.max())).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,kv,d,off", ATTN_TRAIN)
def test_attention_train_matches_plain(b, sq, skv, h, kv, d, off, card):
    """o, lse, dq, dk and dv of the kernels at the full shape; the plain
    versions on the first and the last batch row (rows are independent,
    and the plain backward holds (1, H, Sq, Skv) float32 logits).  Each
    kernel launch counts."""
    q, k, v, do = _attention_train_inputs(b, sq, skv, h, kv, d, card)
    scale = d ** -0.5
    op = at.attention_train
    fwd, bwd = op.launches, op.backward_launches
    o, lse = at.launch_forward(q, k, v, off, scale)
    dq, dk, dv = at.launch_backward(q, k, v, o, lse, do, off, scale)
    torch.cuda.synchronize()
    assert (op.launches, op.backward_launches) == (fwd + 1, bwd + 1)
    for r in sorted({0, b - 1}):
        r = slice(r, r + 1)
        o0, lse0 = at.forward_plain(q[r], k[r], v[r], off, scale)
        assert _row_err(o[r], o0) < ATTN_TRAIN_TOL, r
        assert _rel_err(lse[r], lse0) < ATTN_LSE_TOL, r
        want = at.backward_plain(q[r], k[r], v[r], o[r], lse[r], do[r], off,
                                 scale)
        for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            assert _row_err(got[r], w) < ATTN_TRAIN_TOL, (name, r)
    if off + sq < skv:   # keys past every query's diagonal get no gradient
        assert not dk[:, off + sq:].any() and not dv[:, off + sq:].any()


@pytest.mark.cuda
def test_attention_train_backward_is_deterministic(card):
    """No atomics: two backward runs are bit-identical (GQA, so each
    dK/dV CTA sums the group's heads)."""
    q, k, v, do = _attention_train_inputs(2, 1100, 1100, 8, 2, 80, card, 3)
    o, lse = at.launch_forward(q, k, v, 0, 80 ** -0.5)
    first = at.launch_backward(q, k, v, o, lse, do, 0, 80 ** -0.5)
    again = at.launch_backward(q, k, v, o, lse, do, 0, 80 ** -0.5)
    assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.cuda
def test_attention_train_through_autograd_on_the_card(card):
    """The op as the model calls it: q, k, v as strided views of one
    projection (no copy), gradients through the autograd Function equal
    the launches' own."""
    b, s, h, kv, d = 2, 1100, 8, 2, 64
    qkv = torch.randn(b, s, h + 2 * kv, d, device=card).bfloat16()
    qkv.requires_grad_(True)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv], qkv[:, :, h + kv:]
    do = torch.randn(b, s, h, d, device=card).bfloat16()
    out = at.attention_train(q, k, v)
    out.backward(do)
    o, lse = at.launch_forward(q.detach(), k.detach(), v.detach(), 0,
                               d ** -0.5)
    dq, dk, dv = at.launch_backward(q.detach(), k.detach(), v.detach(), o,
                                    lse, do, 0, d ** -0.5)
    assert torch.equal(out, o)
    assert torch.equal(qkv.grad, torch.cat([dq, dk, dv], dim=2))


@pytest.mark.cuda
def test_attention_train_raises_instead_of_falling_back(card):
    """An uninstantiated width, float32 and a misaligned layout raise on
    the card; nothing falls back to the plain version."""
    q, k, v, _ = _attention_train_inputs(1, 128, 128, 2, 2, 256, card)
    with pytest.raises(ValueError, match="d=256"):
        at.attention_train(q, k, v)
    q, k, v, _ = _attention_train_inputs(1, 128, 128, 2, 2, 80, card)
    with pytest.raises(ValueError, match="bfloat16"):
        at.attention_train(q.float(), k.float(), v.float())
    wide = torch.zeros(1, 128, 2, 84, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="strides"):
        at.attention_train(wide[..., :80], k, v)


@pytest.mark.cuda
def test_auto_routes_long_causal_attention_to_the_kernel(card):
    """Past 1024 queries 'auto' takes the kernel for bf16 causal input on
    the card (one launch, close to the flash twin), and the twin for
    float32 and non-causal input (no launch)."""
    from repro_torch.models import attention as t_attn
    q, k, v, _ = _attention_train_inputs(1, 1100, 1100, 4, 2, 80, card, 4)
    args = dict(q_offset=0)
    before = at.attention_train.launches
    got = t_attn.multihead_attention(q, k, v, causal=True, **args)
    assert at.attention_train.launches == before + 1
    twin = t_attn.multihead_attention(q, k, v, causal=True,
                                      impl="flash_jnp", **args)
    assert _row_err(got, twin) < TWIN_TOL
    t_attn.multihead_attention(q.float(), k.float(), v.float(), causal=True,
                               **args)
    t_attn.multihead_attention(q, k, v, causal=False, **args)
    assert at.attention_train.launches == before + 1


@pytest.mark.cuda
def test_auto_keeps_the_twin_on_fake_card_tensors(card):
    """A dry run's fake tensors on the card (no memory behind them) take
    the flash twin past 1024 queries: nothing launches."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import attention as t_attn
    before = at.attention_train.launches
    with FakeTensorMode():
        q, k, v = (torch.empty(1, 1100, 4, 80, dtype=torch.bfloat16,
                               device=card) for _ in range(3))
        out = t_attn.multihead_attention(q, k, v, causal=True, q_offset=0)
        assert tuple(out.shape) == (1, 1100, 4, 80)
    assert at.attention_train.launches == before


def _scan_inputs(bsz, length, dim, n, device, rng):
    f = np.float32
    return tuple(torch.as_tensor(a).to(device) for a in (
        rng.normal(size=(bsz, length, dim)).astype(f) * 0.5,
        rng.uniform(0.001, 0.1, (bsz, length, dim)).astype(f),
        rng.normal(size=(bsz, length, n)).astype(f),
        rng.normal(size=(bsz, length, n)).astype(f),
        -rng.uniform(0.5, 2.0, (dim, n)).astype(f),
        np.ones((dim,), f)))


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,length,dim,n,chunk,dblk", SCAN_SHAPES)
def test_mamba_scan_matches_plain(bsz, length, dim, n, chunk, dblk, card):
    args = _scan_inputs(bsz, length, dim, n, card, np.random.default_rng(3))
    before = ms.mamba_scan.launches
    got = ops.mamba_scan(*args, chunk=chunk, d_block=dblk)
    assert ms.mamba_scan.launches == before + 1
    want = ms.mamba_scan_plain(*args, chunk=chunk, d_block=dblk)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_mamba_scan_operands_off_16_byte_alignment(card):
    """Operands that start 4 bytes past 16: the plan takes 4-byte copies,
    and the kernel still equals its plain version."""
    args = _scan_inputs(1, 32, 64, 16, card, np.random.default_rng(6))
    shifted = []
    for t in args[:4]:
        buf = torch.empty(t.numel() + 1, device=card)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        shifted.append(view)
    assert not ms.starts_aligned(*shifted)
    got = ms.mamba_scan(*shifted, *args[4:], chunk=16, d_block=32)
    want = ms.mamba_scan_plain(*args, chunk=16, d_block=32)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_mamba_scan_launch_refuses_a_bad_plan(card):
    args = _scan_inputs(1, 32, 64, 16, card, np.random.default_rng(7))
    plan = ms.scan_plan(16, 64, 16)
    formula = int(ms.smem_bytes(16, 64, 16, 4))
    for bad in (plan._replace(threads=plan.threads + 32),
                plan._replace(states=8),
                plan._replace(split=3),
                plan._replace(passes=plan.passes + 1),
                plan._replace(stage=3),
                plan._replace(smem=plan.smem + 4),
                plan._replace(smem=formula + 4)):
        before = ms.mamba_scan.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            ms.launch(*args, chunk=16, d_block=64, plan=bad)
        assert ms.mamba_scan.launches == before
    got = ms.launch(*args, chunk=16, d_block=64, plan=plan)
    torch.testing.assert_close(got, ms.mamba_scan_plain(
        *args, chunk=16, d_block=64), rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_new_wrappers_raise_instead_of_falling_back(card):
    q = torch.ones((2, 64, 32), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           q, q, bq=32, bkv=32)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q.half(), q.half(), q.half(), bq=32, bkv=32)
    big = torch.ones((1, 512, 128), device=card)
    with pytest.raises(ValueError, match="shared memory"):
        fa.flash_attention(big, big, big, bq=512, bkv=512)
    args = _scan_inputs(1, 64, 32, 8, card, np.random.default_rng(4))
    with pytest.raises(ValueError, match="float32"):
        ms.mamba_scan(args[0].double(), *args[1:], chunk=16, d_block=16)
    with pytest.raises(ValueError, match="shared memory"):
        ms.mamba_scan(*_scan_inputs(1, 4096, 64, 8, card,
                                    np.random.default_rng(5)),
                      chunk=4096, d_block=64)


@pytest.mark.cuda
def test_float32_flexion_and_fixed_config_search_on_the_card(card,
                                                              monkeypatch):
    """The torch flexion backend counts exactly, so the card gives the
    CPU's float32 fractions bit for bit; the fixed-config search on the
    card designs the same accelerator as on the CPU."""
    from repro_torch.core import (FlexSpec, GAConfig, flexion_campaign,
                                  get_model, make_variant,
                                  search_fixed_configs)
    monkeypatch.setenv("REPRO_FLEXION_BACKEND", "torch")
    rows = [(make_variant(cls), layer, 0) for cls in ("1000", "1111")
            for layer in (None, *get_model("ncf"))]
    on_card = flexion_campaign(rows, mc_samples=3000, device=card)
    assert on_card == flexion_campaign(rows, mc_samples=3000, device="cpu")
    reqs = [(get_model(m), FlexSpec(name=f"probe-{m}"))
            for m in ("ncf", "alexnet")]
    cfg = GAConfig(population=8, generations=3)
    for (g_card, r_card), (g_cpu, r_cpu) in zip(
            search_fixed_configs(reqs, cfg, device=card),
            search_fixed_configs(reqs, cfg, device="cpu")):
        assert np.array_equal(g_card, g_cpu)
        assert r_card.runtime == r_cpu.runtime


def _flat_models(results):
    return [(p.runtime, p.energy, p.edp, p.util, p.dram_elems, p.feasible,
             tuple(p.history), p.mapping) for r in results
            for p in r.per_layer]


def _pool_requests():
    from repro_torch.core import (PARTFLEX, get_model, inflex_baseline,
                                  make_variant)
    specs = [inflex_baseline(), make_variant("1000"),
             make_variant("1111", PARTFLEX), make_variant("11111")]
    return [(get_model(m), s) for m in ("mnasnet", "alexnet")
            for s in specs]


@pytest.mark.cuda
def test_pipelined_and_placed_campaign_on_the_card(card, monkeypatch):
    """Pipelining and a pool change scheduling only: on the card every
    variant equals the plain campaign, which equals the CPU's."""
    from repro_torch.core import GAConfig, search_campaign
    monkeypatch.delenv("REPRO_DEVICES", raising=False)
    reqs = _pool_requests()
    cfg = GAConfig(population=6, generations=3, seed=1)
    plain = _flat_models(search_campaign(reqs, cfg, device=card))
    assert plain == _flat_models(search_campaign(reqs, cfg, device="cpu"))
    for extra in (dict(pipeline=True), dict(devices=(0, 0)),
                  dict(pipeline=True, devices=(0, 0)),
                  dict(pipeline=True, devices="all")):
        got = search_campaign(reqs, GAConfig(population=6, generations=3,
                                             seed=1, **extra), device=card)
        assert _flat_models(got) == plain, extra


@pytest.mark.cuda
def test_chunk_dispatch_never_waits_for_the_card(card, monkeypatch):
    """A chunk's GA (every generation: cost model, selection, breeding)
    makes the host wait for the card nowhere: sync debug mode turns any
    synchronizing call inside it into an error.  Only the collection reads
    back."""
    from repro_torch.core import GAConfig, get_model, make_variant
    from repro_torch.core import engine
    cfg = GAConfig(population=8, generations=4)
    spec = make_variant("11111")
    rows = [engine.EngineRow(l, spec, 1000 * i)
            for i, l in enumerate(get_model("mnasnet"))][:engine.ROW_BUCKET]
    inputs = engine._prepare_chunk(rows, cfg, spec.hw)
    engine.warmup_engine(cfg, spec.hw, device=card)
    ga_program = engine._ga_program

    def checked(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return ga_program(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(engine, "_ga_program", checked)
    outputs = engine._dispatch_chunk(inputs, cfg, spec.hw, card)
    got = engine._collect_chunk(len(rows), inputs.gens, outputs)
    want = engine.run_batched_ga(rows, cfg, device="cpu")
    assert [r.best_obj for r in got] == [r.best_obj for r in want]


@pytest.mark.cuda
def test_dse_service_on_the_card_answers_like_solo_campaigns(card):
    """Concurrent clients, each asking for its own design point, a shared
    one and its own again under another seed: every answer equals a solo
    campaign on the card, and the shared rows dispatch once.  The specs
    pin R; a wave that mixes R-open and R-pinned clients is held to solo
    campaigns in tests/test_torch_service.py."""
    import threading

    from repro_torch.core import GAConfig, search_campaign
    from repro_torch.serve import DSEService
    reqs = _pool_requests()[:3]
    cfgs = [GAConfig(population=8, generations=3, seed=s) for s in (0, 11)]
    sessions = [[(i, 0), (0, 0), (i, 1)] for i in range(len(reqs))]
    want = {(i, j): _flat_models([search_campaign([reqs[i]], cfgs[j],
                                                  device=card)[0]])
            for i in range(len(reqs)) for j in range(len(cfgs))}
    got, errs = [], []
    with DSEService(device=card) as svc:

        def client(session):
            try:
                for i, j in session:
                    res = svc.query(*reqs[i], cfgs[j], timeout=300)
                    got.append(((i, j), _flat_models([res])))
            except BaseException as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=client, args=(s,))
                   for s in sessions]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        stats = svc.stats()
    assert not errs, errs
    assert len(got) == sum(len(s) for s in sessions)
    for key, flat in got:
        assert flat == want[key], key
    assert stats["rows_dispatched"] < stats["rows_planned"]


@pytest.mark.cuda
def test_bridge_validation_runs_every_kernel_on_the_card(card, tmp_path,
                                                         monkeypatch):
    """bridge_validation's kernel section on the card: every config its
    sampled genomes lower to runs on its kernel, in parity with the
    oracle, and all three kernels launch."""
    from repro_torch.bench import bridge_validation
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("REPRO_NO_KERNELS", raising=False)
    kernels = (tm.tiled_matmul, fa.flash_attention, ms.mamba_scan)
    before = [k.launches for k in kernels]
    got = bridge_validation.run(device=card, print_fn=lambda *a, **k: None)
    assert got["kernel_executed"] and got["kernel_parity_ok"]
    assert got["kernel_legality_consistent"]
    assert got["kernel_configs_checked"] > 0
    assert all(k.launches > b for k, b in zip(kernels, before))


@pytest.mark.cuda
def test_fig9_on_the_card_holds_its_pinned_anchors(card):
    """fig9 on the card: the batched and campaign paths equal each other
    bit for bit and the reference's fast-mode values pinned in
    anchors_fast.json (the flexion column does not enter them)."""
    from repro_torch.bench import fig9_order
    from repro_torch.bench.common import fast_anchors
    runs = {path: {k: v for k, v in fig9_order.run(
        mode="fast", path=path, device=card,
        print_fn=lambda *a, **k: None).items() if not k.startswith("_")}
        for path in ("batched", "campaign")}
    assert runs["batched"] == runs["campaign"] == fast_anchors()["fig9"]


@pytest.mark.cuda
def test_bench_writer_batched_pass_on_the_card(card, tmp_path, monkeypatch):
    from repro_torch.bench import run as writer
    monkeypatch.chdir(tmp_path)
    rc = writer.main(["table3", "fig9", "--mode", "fast", "--engines",
                      "batched", "--json", "bench.json"])
    assert rc == 0
    doc = json.loads((tmp_path / "bench.json").read_text())
    assert list(doc["engines"]["batched"]) == ["table3", "fig9"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_smoke_model_on_the_card_holds_its_pinned_anchors(arch, card):
    """Every architecture at its smoke config on the card, float32, TF32
    off: forward, loss, prefill and 3 greedy decode steps equal the
    reference's outputs pinned in anchors_smoke.json (params drawn by numpy
    in the reference's layout, their checksum first)."""
    from repro_torch.configs import get_config
    from repro_torch.core.convert import numpy_params, params_from_numpy
    from repro_torch.models import anchors
    # the reference's anchors: the JAX package has no mixer norms
    cfg = get_config(arch, smoke=True).replace(mixer_rms_eps=None)
    tree = numpy_params(cfg, anchors.PARAM_SEED)
    want = dict(anchors.load()["archs"][arch])
    np.testing.assert_allclose(anchors.params_checksum(tree),
                               want.pop("checksum"), rtol=1e-12, atol=0)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = anchors.port_outputs(cfg, params_from_numpy(cfg, tree, card),
                                   card)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert anchors.mismatches(got, want, rtol=2e-4, atol=2e-4) == []


@pytest.mark.cuda
def test_serving_on_the_card(card):
    """The launcher on the card by default: a smoke MoE served in waves,
    every request answered at its length."""
    from repro_torch.launch.serve import run_serving
    lines = []
    results = run_serving("olmoe-1b-7b", smoke=True, n_requests=6,
                          max_new=5, max_batch=4, print_fn=lines.append)
    assert [len(r.tokens) for r in results] == [5] * 6
    assert lines[0].endswith("on cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_smoke_train_step_on_the_card_equals_the_port_on_the_cpu(arch,
                                                                 card):
    """Every architecture's gradients, two default-optimizer steps and an
    SGD step in two microbatches (``train_anchors.port_outputs``) on the
    card, float32, TF32 off, equal the port's on the CPU and the pinned
    reference outputs, at ``train_anchors.compare``'s tolerances."""
    from repro_torch.configs import get_config
    from repro_torch.core.convert import numpy_params
    from repro_torch.models import train_anchors as TA
    # the reference's anchors: the JAX package has no mixer norms
    cfg = get_config(arch, smoke=True).replace(mixer_rms_eps=None)
    tree = numpy_params(cfg, TA.PARAM_SEED)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = TA.port_outputs(cfg, tree, card)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    cpu = TA.port_outputs(cfg, tree, "cpu")
    assert TA.compare(got, cpu)[0] == []
    assert TA.compare(got, TA.load()["archs"][arch])[0] == []


@pytest.mark.cuda
def test_checkpoint_from_card_tensors_restores_bit_for_bit(card, tmp_path):
    """A TrainState of card tensors (bfloat16, float32 and int32 leaves)
    written asynchronously, then updated in place, restores onto the card
    and onto the CPU as it was at the save."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.steps import TrainState
    from repro_torch.tree import leaves, map_leaves
    gen = torch.Generator(device=card).manual_seed(0)
    state = TrainState(
        params={"w": torch.randn((64, 48), generator=gen, device=card)
                .bfloat16(), "b": torch.randn(48, generator=gen,
                                              device=card)},
        opt={"m": {"w": torch.randn((64, 48), generator=gen, device=card),
                   "b": torch.zeros(48, device=card)}},
        step=torch.tensor(3, dtype=torch.int32, device=card))
    want = [x.clone() for x in leaves(state)]
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    mgr.save(3, state)
    for x in leaves(state.params):
        x.add_(1.0)
    spec = map_leaves(lambda x: torch.empty_like(x, device="meta"), state)
    for device in (card, torch.device("cpu")):
        restored, step = mgr.restore(spec, device)
        assert step == 3
        for x, y in zip(leaves(restored), want):
            assert x.device.type == device.type and x.dtype == y.dtype
            assert torch.equal(x.cpu(), y.cpu())


@pytest.mark.cuda
def test_training_on_the_card_by_default(card, tmp_path):
    """The launcher trains on the card unless told otherwise: a smoke MoE,
    4 steps in two microbatches, checkpoints at steps 2 and 4 of which the
    manager keeps the last (keep=2 leaves room for the one being
    written, as the reference's does)."""
    from repro_torch.launch.train import run_training
    lines = []
    res = run_training("olmoe-1b-7b", smoke=True, steps=4, batch=4, seq=16,
                       n_micro=2, ckpt_dir=str(tmp_path), ckpt_every=2,
                       optimizer="adamw", lr=3e-3, print_fn=lines.append)
    assert res.final_step == 4 and res.restarts == 0
    assert lines[-1].endswith("on cuda")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_4"]
