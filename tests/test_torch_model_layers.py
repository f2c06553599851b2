"""The port's model layers against the JAX package's on the same numpy
inputs (float32, CPU): norms, activations, rope in every mode, softcap, the
sinusoidal table, dense and flash attention (GQA, cache masks, a padded KV
block, the auto dispatch), the MoE router, ranks and scatter block (ties,
capacity drops), the chunked scans (L not a multiple of the chunk), the
causal conv and the Mamba blocks; then tests/test_ssm_properties.py's
properties on the port's scans, and ``params_from_numpy``'s checks."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402

from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.convert import (numpy_params,  # noqa: E402
                                      params_from_numpy)
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


# ---------------------------------------------------------------- layers --

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_equal_reference(kind):
    x = _rand((2, 5, 24), 0, 3.0) + 1.0
    scale, bias = _rand((24,), 1) + 1.0, _rand((24,), 2)
    jp = scale if kind == "rmsnorm" else {"scale": scale, "bias": bias}
    tp = torch.as_tensor(scale) if kind == "rmsnorm" else \
        {"scale": torch.as_tensor(scale), "bias": torch.as_tensor(bias)}
    _close(t_layers.apply_norm(kind, torch.as_tensor(x), tp),
           j_layers.apply_norm(kind, jnp.asarray(x), jp), rtol=1e-5,
           atol=1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "relu2"])
def test_activations_equal_reference(kind):
    g, u = _rand((3, 40), 0, 2.0), _rand((3, 40), 1)
    up_t = torch.as_tensor(u) if t_layers.is_gated(kind) else None
    up_j = jnp.asarray(u) if j_layers.is_gated(kind) else None
    _close(t_layers.activate(kind, torch.as_tensor(g), up_t),
           j_layers.activate(kind, jnp.asarray(g), up_j), rtol=1e-6,
           atol=1e-6)


@pytest.mark.parametrize("pos_ndim", [1, 2])
@pytest.mark.parametrize("mode,fraction", [("full", 1.0), ("partial", 0.25),
                                           ("2d", 1.0), ("none", 1.0)])
def test_rope_equals_reference(mode, fraction, pos_ndim):
    x = _rand((2, 7, 3, 16))
    pos = np.arange(5, 12) if pos_ndim == 1 else \
        np.stack([np.arange(7), np.arange(3, 10)])
    _close(t_layers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos),
                               mode, fraction, 500.0),
           j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), mode,
                               fraction, 500.0), rtol=1e-5, atol=1e-5)


def test_softcap_and_sinusoidal_equal_reference():
    x = _rand((4, 9), 0, 40.0)
    _close(t_layers.softcap(torch.as_tensor(x), 30.0),
           j_layers.softcap(jnp.asarray(x), 30.0), rtol=1e-6, atol=1e-5)
    _close(t_layers.softcap(torch.as_tensor(x), 0.0), x)
    for d in (2, 16, 64):
        _close(t_tf._sinusoidal(torch.arange(3, 40), d, torch.float32),
               j_tf._sinusoidal(jnp.arange(3, 40), d, jnp.float32),
               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- attention --

def _qkv(b, sq, skv, h, nkv, hd, seed=0):
    return (_rand((b, sq, h, hd), seed), _rand((b, skv, nkv, hd), seed + 1),
            _rand((b, skv, nkv, hd), seed + 2))


@pytest.mark.parametrize("impl", ["dense", "flash_jnp", "pallas"])
@pytest.mark.parametrize("causal,masked", [(True, False), (False, False),
                                           (True, True)])
def test_attention_equals_reference(impl, causal, masked):
    """GQA (4 heads over 2 KV heads), 37 keys in blocks of 16 (a padded last
    block), with and without a cache-style length mask."""
    b, sq, skv = 2, 37, 37
    q, k, v = _qkv(b, sq, skv, 4, 2, 8)
    q_pos = np.arange(sq)
    mask = (np.arange(skv)[None, :] < np.array([[30], [37]])) if masked \
        else None
    got = t_attn.multihead_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        causal=causal, q_positions=torch.as_tensor(q_pos),
        kv_len_mask=None if mask is None else torch.as_tensor(mask),
        impl=impl, block_kv=16)
    want = j_attn.multihead_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_positions=jnp.asarray(q_pos),
        kv_len_mask=None if mask is None else jnp.asarray(mask),
        impl=impl, block_kv=16)
    _close(got, want, rtol=1e-5, atol=1e-5)


def test_auto_dispatch_takes_flash_past_1024_queries():
    """Sq = 1100 > 1024: 'auto' runs the flash twin (three KV blocks of
    512), equal to 'dense' and to the reference."""
    q, k, v = _qkv(1, 1100, 1100, 2, 1, 8, seed=4)
    args = dict(causal=True, q_positions=torch.arange(1100), block_kv=512)
    t = [torch.as_tensor(a) for a in (q, k, v)]
    auto = t_attn.multihead_attention(*t, impl="auto", **args)
    flash = t_attn.multihead_attention(*t, impl="flash_jnp", **args)
    dense = t_attn.multihead_attention(*t, impl="dense", **args)
    assert torch.equal(auto, flash)
    _close(auto, dense, rtol=2e-5, atol=2e-5)
    want = j_attn.multihead_attention(
        *[jnp.asarray(a) for a in (q, k, v)], causal=True,
        q_positions=jnp.arange(1100), impl="auto", block_kv=512)
    _close(auto, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("arch", ["chatglm3-6b", "stablelm-3b", "gemma-2b"])
def test_attention_block_with_cache_equals_reference(arch):
    """Prefill 5 tokens into a cache of 12, then one decode token: outputs
    and the filled cache equal the reference's."""
    j_cfg, t_cfg = j_get_config(arch, smoke=True), t_get_config(arch,
                                                                  smoke=True)
    tree = numpy_params(t_cfg, 3)["stack"]["layers"]["attn"]
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree)
    tp = {k: torch.as_tensor(v[0]) for k, v in tree.items()}
    x = _rand((2, 6, t_cfg.d_model), 5)
    jc, tc = j_attn.init_kv_cache(2, 12, j_cfg), \
        t_attn.init_kv_cache(2, 12, t_cfg, "cpu")
    for lo, hi in ((0, 5), (5, 6)):
        pos = np.arange(lo, hi)
        jy, jc = j_attn.attention_block(jp, jnp.asarray(x[:, lo:hi]), j_cfg,
                                        positions=jnp.asarray(pos), cache=jc)
        ty, tc = t_attn.attention_block(tp, torch.as_tensor(x[:, lo:hi]),
                                        t_cfg, positions=torch.as_tensor(pos),
                                        cache=tc)
        _close(ty, jy, rtol=1e-5, atol=1e-5)
        assert int(tc.pos) == int(jc.pos) == hi
    _close(tc.k, jc.k, rtol=1e-5, atol=1e-5)
    _close(tc.v, jc.v, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="overflow"):
        t_attn.attention_block(tp, torch.as_tensor(_rand((2, 7, 64))), t_cfg,
                               positions=torch.arange(6, 13), cache=tc)


# ------------------------------------------------------------------- MoE --

def _moe_cfgs(capacity_factor, top_k=2):
    kw = dict(name="m", block="moe", d_model=16, d_ff=8, n_experts=8,
              top_k=top_k, capacity_factor=capacity_factor, act="swiglu")
    return JConfig(**kw), TConfig(**kw)


def test_route_topk_equals_reference_and_breaks_ties_low():
    j_cfg, t_cfg = _moe_cfgs(1.25, top_k=3)
    router, xt = _rand((16, 8), 0, 0.5), _rand((40, 16), 1)
    xt[:6] = 0.0        # zero rows: every probability ties at 1/8
    jw, je, ja = j_moe.route_topk(jnp.asarray(router), jnp.asarray(xt), j_cfg)
    tw, te, ta = t_moe.route_topk(torch.as_tensor(router),
                                  torch.as_tensor(xt), t_cfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(te[:6].numpy(), np.tile([0, 1, 2], (6, 1)))
    _close(tw, jw, rtol=1e-6, atol=1e-6)
    _close(ta, ja, rtol=1e-6, atol=1e-7)


def test_assignment_ranks_equal_reference():
    experts = np.random.default_rng(2).integers(0, 8, (50, 3))
    got = t_moe.assignment_ranks(torch.as_tensor(experts), 8)
    want = j_moe.assignment_ranks(jnp.asarray(experts, jnp.int32), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("capacity_factor", [4.0, 1.0, 0.3])
def test_moe_block_equals_reference_with_and_without_drops(capacity_factor):
    """capacity 4.0 keeps every assignment; 1.0 and 0.3 drop some (cap 8
    and 2 slots an expert for 32 tokens x top-2 over 8 experts)."""
    j_cfg, t_cfg = _moe_cfgs(capacity_factor)
    tree = {"router": _rand((16, 8), 0, 0.7),
            "w_gate": _rand((8, 16, 8), 1, 0.25),
            "w_up": _rand((8, 16, 8), 2, 0.25),
            "w_down": _rand((8, 8, 16), 3, 0.35)}
    x = _rand((2, 16, 16), 4)
    jo, ja = j_moe._moe_block_jit(jax.tree.map(jnp.asarray, tree),
                                  jnp.asarray(x), j_cfg)
    to, ta = t_moe.moe_block({k: torch.as_tensor(v) for k, v in tree.items()},
                             torch.as_tensor(x), t_cfg)
    _close(to, jo, rtol=1e-5, atol=1e-5)
    _close(ta, ja, rtol=1e-6, atol=1e-7)
    ranks = t_moe.assignment_ranks(
        t_moe.route_topk(torch.as_tensor(tree["router"]),
                         torch.as_tensor(x.reshape(32, 16)), t_cfg)[1], 8)
    cap = max(1, int(capacity_factor * 2 * 32 / 8))
    assert bool((ranks >= cap).any()) == (capacity_factor < 4.0)


# ------------------------------------------------------------------- SSM --

@pytest.mark.parametrize("L,chunk", [(16, 8), (13, 4), (7, 16), (9, 1)])
def test_chunked_scans_equal_reference(L, chunk):
    """Mamba-1 shaped (per channel and state) and Mamba-2 shaped (a scalar
    decay a head, broadcast) selective scans, and the linear scan."""
    rng = np.random.default_rng(L * 31 + chunk)
    for a_shape, b_shape, h_shape in (((2, L, 3, 4), (2, L, 3, 4), (2, 3, 4)),
                                      ((2, L, 2, 1, 1), (2, L, 2, 3, 4),
                                       (2, 2, 3, 4))):
        a = rng.uniform(0.3, 1.0, a_shape).astype(np.float32)
        b = rng.normal(size=b_shape).astype(np.float32)
        c = rng.normal(size=(2, L, 4)).astype(np.float32)
        h0 = rng.normal(size=h_shape).astype(np.float32)
        ty, th = t_ssm.chunked_selective_scan(*map(torch.as_tensor,
                                                   (a, b, c, h0)), chunk)
        jy, jh = j_ssm.chunked_selective_scan(*map(jnp.asarray,
                                                   (a, b, c, h0)), chunk)
        _close(ty, jy, rtol=1e-5, atol=1e-5)
        _close(th, jh, rtol=1e-5, atol=1e-5)
        if a_shape == b_shape:
            th_all, th_last = t_ssm.chunked_linear_scan(
                *map(torch.as_tensor, (a, b, h0)), chunk)
            jh_all, jh_last = j_ssm.chunked_linear_scan(
                *map(jnp.asarray, (a, b, h0)), chunk)
            _close(th_all, jh_all, rtol=1e-5, atol=1e-5)
            _close(th_last, jh_last, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
@pytest.mark.parametrize("stateful", [False, True])
def test_mamba_block_equals_reference(arch, stateful):
    """One Mamba block on 11 tokens (chunk 8: a padded chunk), with and
    without a carried cache (then 3 more tokens from the returned one)."""
    j_cfg, t_cfg = j_get_config(arch, smoke=True), t_get_config(arch,
                                                                  smoke=True)
    # the JAX package has no Falcon-Mamba mixer norms
    t_cfg = t_cfg.replace(mixer_rms_eps=None)
    tree = numpy_params(t_cfg, 5)["stack"]["layers"]["mamba"]
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree)
    tp = {k: torch.as_tensor(v[0]) for k, v in tree.items()}
    jblk = j_ssm.mamba1_block if arch == "falcon-mamba-7b" \
        else j_ssm.mamba2_block
    tblk = t_ssm.mamba1_block if arch == "falcon-mamba-7b" \
        else t_ssm.mamba2_block
    x = _rand((2, 14, t_cfg.d_model), 6)
    jc = j_ssm.init_ssm_cache(2, j_cfg) if stateful else None
    tc = t_ssm.init_ssm_cache(2, t_cfg, "cpu") if stateful else None
    for lo, hi in ((0, 11), (11, 14)) if stateful else ((0, 14),):
        jy, jc = jblk(jp, jnp.asarray(x[:, lo:hi]), j_cfg, jc)
        ty, tc = tblk(tp, torch.as_tensor(x[:, lo:hi]), t_cfg, tc)
        _close(ty, jy, rtol=1e-5, atol=1e-5)
    if stateful:
        _close(tc.state, jc.state, rtol=1e-5, atol=1e-5)
        _close(tc.conv, jc.conv, rtol=1e-6, atol=1e-6)


def _direct_scan(a, b, h0):
    hs, h = [], h0
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, 1), h


@pytest.mark.parametrize("L,chunk,seed", [(1, 1, 0), (5, 17, 1), (33, 4, 2),
                                          (17, 5, 3), (24, 8, 4),
                                          (31, 16, 5)])
def test_chunked_scan_equals_direct_for_any_chunk(L, chunk, seed):
    """tests/test_ssm_properties.py's property on the port's scan."""
    rng = np.random.default_rng(seed)
    a = torch.as_tensor(rng.uniform(0.2, 0.99, (2, L, 3)), dtype=torch.float32)
    b = torch.as_tensor(rng.normal(size=(2, L, 3)), dtype=torch.float32)
    h0 = torch.as_tensor(rng.normal(size=(2, 3)), dtype=torch.float32)
    got, got_last = t_ssm.chunked_linear_scan(a, b, h0, chunk)
    want, want_last = _direct_scan(a, b, h0)
    _close(got, want, rtol=2e-5, atol=2e-5)
    _close(got_last, want_last, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("L,seed", [(2, 0), (9, 1), (20, 2), (40, 3)])
def test_segmented_scan_equals_full_scan(L, seed):
    """Scanning [0:n) then [n:L) with the carried state == one scan."""
    rng = np.random.default_rng(seed)
    n = max(1, L // 2)
    a = torch.as_tensor(rng.uniform(0.2, 0.99, (1, L, 4)), dtype=torch.float32)
    b = torch.as_tensor(rng.normal(size=(1, L, 4)), dtype=torch.float32)
    h0 = torch.zeros((1, 4))
    full, full_last = t_ssm.chunked_linear_scan(a, b, h0, chunk=8)
    h1_all, h1 = t_ssm.chunked_linear_scan(a[:, :n], b[:, :n], h0, chunk=8)
    h2_all, h2 = t_ssm.chunked_linear_scan(a[:, n:], b[:, n:], h1, chunk=8)
    _close(torch.cat([h1_all, h2_all], 1), full, rtol=2e-5, atol=2e-5)
    _close(h2, full_last, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("L,K", [(1, 1), (6, 4), (24, 3), (10, 2)])
def test_causal_conv_matches_torch_conv(L, K):
    """The windowed sum == a depthwise conv1d with K-1 zeros of left
    padding, and == the reference's."""
    x, w, bias = _rand((2, L, 3), 0), _rand((K, 3), 1), _rand((3,), 2)
    y, _ = t_ssm.causal_conv1d(torch.as_tensor(x), torch.as_tensor(w),
                               torch.as_tensor(bias))
    lhs = torch.nn.functional.pad(torch.as_tensor(x).transpose(1, 2),
                                  (K - 1, 0))
    want = torch.nn.functional.conv1d(
        lhs, torch.as_tensor(w).T[:, None, :], torch.as_tensor(bias),
        groups=3).transpose(1, 2)
    _close(y, want, rtol=2e-5, atol=2e-5)
    jy, _ = j_ssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(bias))
    _close(y, jy, rtol=1e-6, atol=1e-6)


def test_conv_streaming_equals_batch():
    x = torch.as_tensor(_rand((1, 10, 4)))
    w = torch.as_tensor(_rand((4, 4), 1))
    bias = torch.zeros(4)
    full, _ = t_ssm.causal_conv1d(x, w, bias)
    prev, outs = torch.zeros((1, 3, 4)), []
    for t in range(10):
        y, prev = t_ssm.causal_conv1d(x[:, t:t + 1], w, bias, prev)
        outs.append(y)
    _close(torch.cat(outs, 1), full, rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------ conversion --

def test_params_from_numpy_checks_names_and_shapes():
    cfg = t_get_config("gemma-2b", smoke=True)
    tree = numpy_params(cfg, 0)
    params = params_from_numpy(cfg, tree, "cpu")
    assert params["embed"].dtype == torch.float32
    bad = dict(tree, extra=np.zeros(1, np.float32))
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(cfg, bad, "cpu")
    bad = dict(tree, embed=tree["embed"][:-1])
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(cfg, bad, "cpu")


def test_bfloat16_leaves_convert_exactly():
    """A bfloat16 reference tree (the published configs' dtype) widens to
    float32 on the way and lands in bfloat16 unchanged."""
    cfg = t_get_config("gemma-2b", smoke=True).replace(dtype="bfloat16")
    tree = numpy_params(cfg, 1)
    j_tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                          tree)
    params = params_from_numpy(cfg, j_tree, "cpu")
    assert params["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(params["embed"].float().numpy(),
                                  j_tree["embed"].astype(np.float32))


def test_numpy_params_are_deterministic_and_cover_every_leaf():
    cfg = t_get_config("zamba2-2.7b", smoke=True)
    a, b = numpy_params(cfg, 9), numpy_params(cfg, 9)
    leaves_a, leaves_b = jax.tree.leaves(a), jax.tree.leaves(b)
    j_cfg = j_get_config("zamba2-2.7b", smoke=True)
    assert len(leaves_a) == len(jax.tree.leaves(jax.eval_shape(
        lambda: j_init_params(j_cfg, jax.random.PRNGKey(0)))))
    for x, y in zip(leaves_a, leaves_b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(jax.tree.leaves(numpy_params(cfg, 10))[0],
                              leaves_a[0])
