"""The port's flash attention and selective scan against the JAX package's:
``flash_attention_plain`` / ``mamba_scan_plain`` and ``ops.attention`` /
``ops.mamba_scan`` on CPU tensors vs ``repro.kernels.ops`` (the Pallas
kernels in interpret mode, as tests/test_kernels.py runs them), the oracles,
the width threading, and the shared-memory formulas.  The CUDA kernels
themselves are tested in tests/test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402

from repro_torch.core.precision import bytes_of  # noqa: E402
from repro_torch.kernels import flash_attention as t_fa  # noqa: E402
from repro_torch.kernels import mamba_scan as t_ms  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402

# (jax dtype, torch dtype, rtol, atol): tests/test_kernels.py's tolerances
ATTN_DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5, 1.6e-4),
               "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2, 0.24)}
# tests/test_kernels.py::test_flash_attention_sweep's shapes, plus an odd
# block and size-1 blocks, which the bridge's lowering produces
ATTN_SHAPES = [(2, 128, 128, 64, 64, 64), (4, 64, 256, 32, 32, 64),
               (1, 256, 256, 128, 128, 128), (2, 48, 48, 16, 3, 48),
               (1, 32, 32, 16, 1, 1)]
SCAN_SHAPES = [(1, 32, 16, 8, 8, 8), (2, 64, 32, 16, 16, 16),
               (2, 128, 64, 8, 32, 32)]


def _attn_inputs(h, sq, skv, d, dtype, seed=0):
    jdt, tdt = ATTN_DTYPES[dtype][:2]
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(h, sq, d)), rng.normal(size=(h, skv, d)),
              rng.normal(size=(h, skv, d)))
    j_in = tuple(jnp.asarray(a.astype(np.float32), jdt) for a in arrays)
    # the same (already rounded) values on the torch side
    t_in = tuple(torch.as_tensor(np.array(a.astype(jnp.float32))).to(tdt)
                 for a in j_in)
    return j_in, t_in


@pytest.mark.parametrize("dtype", sorted(ATTN_DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,sq,skv,d,bq,bkv", ATTN_SHAPES)
def test_attention_plain_matches_pallas_kernel(h, sq, skv, d, bq, bkv,
                                               causal, dtype):
    j_in, t_in = _attn_inputs(h, sq, skv, d, dtype)
    want = np.asarray(j_ops.attention(*j_in, causal=causal, bq=bq, bkv=bkv),
                      np.float32)
    rtol, atol = ATTN_DTYPES[dtype][2:]
    plain = t_fa.flash_attention_plain(*t_in, causal=causal, bq=bq, bkv=bkv)
    via_ops = t_ops.attention(*t_in, causal=causal, bq=bq, bkv=bkv)
    assert plain.dtype == via_ops.dtype == ATTN_DTYPES[dtype][1]
    assert torch.equal(plain, via_ops)        # CPU: the wrapper is plain
    np.testing.assert_allclose(plain.float().numpy(), want, rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", sorted(ATTN_DTYPES))
def test_attention_oracle_matches_reference_oracle(dtype):
    j_in, t_in = _attn_inputs(3, 40, 56, 24, dtype, seed=1)
    for causal in (True, False):
        want = np.asarray(j_ref.attention_ref(*j_in, causal=causal),
                          np.float32)
        got = t_ref.attention_ref(*t_in, causal=causal).float().numpy()
        rtol, atol = ATTN_DTYPES[dtype][2:]
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_attention_bshd_gqa_matches_reference():
    rng = np.random.default_rng(2)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((2, 128, 8, 32), (2, 128, 2, 32), (2, 128, 2, 32))]
    want = np.asarray(j_ops.attention_bshd(
        *(jnp.asarray(a) for a in arrays), causal=True, bq=64, bkv=64))
    t_in = [torch.as_tensor(a) for a in arrays]
    got = t_ops.attention_bshd(*t_in, causal=True, bq=64, bkv=64)
    oracle = t_ops.attention_bshd(*t_in, causal=True, use_kernel=False)
    assert got.shape == (2, 128, 8, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=2e-5,
                               atol=2e-4)


def _scan_inputs(bsz, length, dim, n, seed=3):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(bsz, length, dim)).astype(f) * 0.5,
            rng.uniform(0.001, 0.1, (bsz, length, dim)).astype(f),
            rng.normal(size=(bsz, length, n)).astype(f),
            rng.normal(size=(bsz, length, n)).astype(f),
            -rng.uniform(0.5, 2.0, (dim, n)).astype(f),
            np.ones((dim,), f))


@pytest.mark.parametrize("bsz,length,dim,n,chunk,dblk", SCAN_SHAPES)
def test_mamba_plain_matches_pallas_kernel(bsz, length, dim, n, chunk,
                                           dblk):
    arrays = _scan_inputs(bsz, length, dim, n)
    want = np.asarray(j_ops.mamba_scan(*(jnp.asarray(a) for a in arrays),
                                       chunk=chunk, d_block=dblk))
    t_in = [torch.as_tensor(a) for a in arrays]
    plain = t_ms.mamba_scan_plain(*t_in, chunk=chunk, d_block=dblk)
    via_ops = t_ops.mamba_scan(*t_in, chunk=chunk, d_block=dblk)
    oracle = t_ref.mamba_scan_ref(*t_in)
    assert torch.equal(plain, via_ops)        # CPU: the wrapper is plain
    for got in (plain, oracle):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_ops_bits_threading():
    """bits chooses the executed dtype and floors at each kernel's
    narrowest supported width: attention at bf16, the scan at f32."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.as_tensor(rng.normal(size=(2, 64, 32)).astype(
        np.float32)) for _ in range(3))
    assert t_ops.attention(q, k, v, bq=32, bkv=32,
                           bits=8).dtype == torch.bfloat16
    assert t_ops.attention(q, k, v, bq=32, bkv=32,
                           bits=32).dtype == torch.float32
    assert t_ops.attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), bq=32,
                           bkv=32).dtype == torch.bfloat16
    t_in = [torch.as_tensor(a) for a in _scan_inputs(1, 32, 16, 8)]
    out = t_ops.mamba_scan(*t_in, chunk=8, d_block=8, bits=8)
    assert out.dtype == torch.float32
    j_q = jnp.asarray(q.numpy())
    assert np.asarray(j_ops.attention(j_q, j_q, j_q, bq=32, bkv=32,
                                      bits=8)).dtype == jnp.bfloat16


def test_smem_budget_tracks_r_axis_width():
    """The R gene's width reaches each kernel's shared memory: operand
    bytes scale with bytes_of(bits), the float32 state does not."""
    att = [t_fa.smem_bytes(64, 64, 64, bytes_of(b)) for b in (16, 32)]
    assert att == sorted(att) and att[0] < att[1]
    assert t_fa.smem_bytes(64, 64, 32, 4) > t_fa.smem_bytes(64, 64, 32, 2)
    assert t_ms.smem_bytes(64, 64, 16, 4) > t_ms.smem_bytes(64, 64, 16, 2)
    # float32 accumulator/state terms are width-independent
    f32 = 4 * (64 * 64 + 2 * 64 + t_fa.WARPS * 64)
    assert t_fa.smem_bytes(64, 64, 64, 4) - f32 == \
        2 * (t_fa.smem_bytes(64, 64, 64, 2) - f32) - 2 * 64 * 4
    # BERT-base attention and the falcon scan at practical blocks fit
    assert t_fa.smem_bytes(64, 64, 64, 4) <= t_fa.SMEM_LIMIT_BYTES
    assert t_ms.smem_bytes(16, 8192, 16, 4) <= t_ms.SMEM_LIMIT_BYTES
    # the scan's block runs at most 1024 threads: a wider d-block is looped
    assert t_ms.channel_group(8192, 16) == 64
    assert t_ms.state_lanes(16) == 16 and t_ms.state_lanes(5) == 8
    assert t_ms.state_lanes(64) == 32


def test_wrappers_validate_before_running():
    x = torch.ones((2, 64, 32))
    with pytest.raises(ValueError, match="divide"):
        t_fa.flash_attention(x, x, x, bq=48, bkv=32)
    with pytest.raises(ValueError, match="dtypes"):
        t_fa.flash_attention(x, x.bfloat16(), x)
    with pytest.raises(ValueError, match=r"\(H,Sq,d\)"):
        t_fa.flash_attention(x, torch.ones((2, 64, 16)), x)
    t_in = [torch.as_tensor(a) for a in _scan_inputs(1, 32, 16, 8)]
    with pytest.raises(ValueError, match="divide"):
        t_ms.mamba_scan(*t_in, chunk=5, d_block=8)
    with pytest.raises(ValueError, match="a_log_neg"):
        t_ms.mamba_scan(*t_in[:4], t_in[4][:, :4], t_in[5])
    # blocks clamp to the dims, as in the reference; CPU runs no launch
    before = (t_fa.flash_attention.launches, t_ms.mamba_scan.launches)
    got = t_fa.flash_attention(x, x, x, bq=512, bkv=512)
    assert torch.allclose(got, torch.ones_like(got))
    t_ms.mamba_scan(*t_in, chunk=4096, d_block=4096)
    assert (t_fa.flash_attention.launches,
            t_ms.mamba_scan.launches) == before
