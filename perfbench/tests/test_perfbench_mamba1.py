"""The mamba1 family (``perfbench/families/mamba1.py``) at falcon-mamba-7b's
configuration and 4 x 4096 tokens a step, pinned to the integer: its
leaves (path, shape, type, start), parameters, model FLOPs, AdamW bytes
and the selective scan's least bytes; its starts (S4D-real A_log, Mamba's
Delta bias); its refusals; and the configuration as the program runs it."""
import json
import math

import pytest
import torch

from perfbench import bench, flops, program, weights
from perfbench.tests.conftest import PB_CONFIGS

CONF = json.loads(PB_CONFIGS["falcon-mamba-7b"].read_text())
FAMILY = bench.family(CONF)
L, D, DI, N, R, K, V = 32, 4096, 8192, 16, 256, 4, 65024
M = "stack/layers/mamba/"
LEAVES = [
    ["embed", [V, D], "bfloat16", "normal", D ** -0.5],
    ["ln_f", [D], "bfloat16", "ones", 1.0],
    ["stack/layers/ln1", [L, D], "bfloat16", "ones", 1.0],
    [M + "A_log", [L, DI, N], "float32", "s4d_real", 1.0],
    [M + "D", [L, DI], "float32", "ones", 1.0],
    [M + "conv_b", [L, DI], "bfloat16", "zeros", 1.0],
    [M + "conv_w", [L, K, DI], "bfloat16", "normal", K ** -0.5],
    [M + "dt_bias", [L, DI], "bfloat16", "dt_bias", 1.0],
    [M + "dt_proj", [L, R, DI], "bfloat16", "normal", R ** -0.5],
    [M + "in_proj", [L, D, 2 * DI], "bfloat16", "normal", D ** -0.5],
    [M + "out_proj", [L, DI, D], "bfloat16", "normal", DI ** -0.5],
    [M + "x_proj", [L, DI, R + 2 * N], "bfloat16", "normal", DI ** -0.5],
    ["unembed", [D, V], "bfloat16", "normal", D ** -0.5],
]


def table(conf):
    return [[leaf.path, list(leaf.shape), str(leaf.dtype).split(".")[-1],
             leaf.fill if isinstance(leaf.fill, str) else leaf.fill.__name__,
             leaf.scale] for leaf in weights.leaves(conf)]


def test_leaves_paths_shapes_types_and_starts():
    assert table(CONF) == LEAVES


def test_parameters():
    # 105,312,256 a layer (in_proj 67,108,864, out_proj 33,554,432, x_proj
    # 2,359,296, dt_proj 2,097,152, A_log 131,072, conv_w 32,768, conv_b,
    # dt_bias, D 8,192 each, ln1 4,096), the embedding and the head
    # 266,338,304 each, ln_f 4,096
    sizes = [math.prod(shape) for _, shape, *_ in LEAVES]
    assert sum(sizes[2:12]) // L == 105_312_256
    assert sum(sizes) == 3_902_672_896


def test_counts_to_the_integer():
    # 6 x 3,630,170,112 matmul parameters (105,119,744 a layer and the
    # head's 266,338,304) x 16,384 tokens
    assert FAMILY.matmul_params(CONF) == 3_630_170_112
    assert flops.train_step_flops(CONF, 4, 4096) == 356_860_242_690_048
    assert flops.serve_request_flops(CONF, 3824, 16) == \
        2 * 3_630_170_112 * 3839
    # AdamW: 3,898,216,448 bfloat16 parameters at 22 B, 4,456,448 float32
    # (A_log, D) at 28 B
    assert flops.adamw_bytes(
        (math.prod(leaf.shape), leaf.dtype.itemsize)
        for leaf in weights.leaves(CONF)) == 85_885_542_400
    # the scan at 16,384 tokens, a layer: a forward reads u, Delta's input,
    # z and writes y (4 x 268,435,456 B), reads B and C (2 x 524,288) and
    # A, D, Delta's bias (589,824): 1,075,380,224; a backward reads u,
    # Delta's input, z, dy and writes du, dDelta, dz (7 x 268,435,456),
    # reads B, C and writes dB, dC (4 x 524,288), reads A, D, Delta's bias
    # and writes their gradients (2 x 589,824): 1,882,324,992; 32 layers of
    # two forwards and one backward
    assert FAMILY.scan_bytes(CONF, 4, 4096) == \
        32 * (2 * 1_075_380_224 + 1_882_324_992) == 129_058_734_080


def test_starts():
    a_log = weights.draw(weights.leaves(CONF)[3], 3, 7, "cpu")
    assert torch.equal(a_log[5, 17], torch.log(torch.arange(1., N + 1)))
    leaf = weights.leaves(CONF)[7]
    bias = weights.draw(leaf, 7, 7, "cpu").float()
    dt = torch.nn.functional.softplus(bias)
    # bfloat16 storage moves Delta by under 1%
    assert 0.99e-3 <= float(dt.min()) and float(dt.max()) <= 1.01e-1
    assert torch.equal(weights.draw(leaf, 7, 7, "cpu"),
                       weights.draw(leaf, 7, 7, "cpu"))


def test_the_program_runs_the_configuration():
    cfg = program.config(CONF)
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dtr,
            cfg.vocab_padded, cfg.mixer_rms_eps) == \
        (L, D, DI, N, R, V, 1e-6)


def test_the_family_refuses_the_program_without_its_norms():
    cfg = program.config(CONF)
    with pytest.raises(ValueError, match="mixer norms"):
        FAMILY.check(CONF, cfg.replace(mixer_rms_eps=None))
    with pytest.raises(ValueError, match="mixer_rms_eps"):
        program.config(dict(CONF, mixer_rms_eps=1e-5))



def _metric(name):
    return bench._module(bench.HERE / "metrics" / f"{name}.py").read


def test_the_cell_reads_its_scan_from_the_profile():
    ops = [["void (anonymous namespace)::selective_scan_bwd_kernel<16>("
            "(anonymous namespace)::Args)", 0.4420],
           ["nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN", 0.3630],
           ["void (anonymous namespace)::selective_scan_fwd_kernel<16>("
            "(anonymous namespace)::Args)", 0.3024]]
    obs = {"device_kind": "NVIDIA H100 80GB HBM3",
           "trace": {"device_ops": ops}}
    ms = _metric("ssm_scan_ms.mamba")(obs)
    assert ms == pytest.approx(1e3 * (0.4420 + 0.3024) / 2)
    # 129,058,734,080 B at 3.35e12 B/s over that time
    assert _metric("ssm_scan_roofline.mamba")(obs) == pytest.approx(
        100 * 129_058_734_080 / 3.35e12 / (ms / 1e3))


@pytest.mark.parametrize("trace", [None, {"device_ops": []},
                                   {"device_ops": [["nvjet_tst", 0.36]]}])
def test_the_scan_metrics_are_silent_without_the_op(trace):
    obs = {"device_kind": "NVIDIA H100 80GB HBM3", "trace": trace}
    assert _metric("ssm_scan_ms.mamba")(obs) is None
    assert _metric("ssm_scan_roofline.mamba")(obs) is None
