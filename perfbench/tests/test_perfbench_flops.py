"""The benchmark's FLOP and byte arithmetic (the decoder family's counts
and what every family shares) against what
``torch.utils.flop_counter.FlopCounterMode`` counts in the program's own
forward and backward, on tiny configurations with remat off."""
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import bench, flops, weights
from perfbench.tests.conftest import PB_CONFIGS, tiny_conf

B, S = 2, 48


def counted(conf, backward: bool) -> int:
    from perfbench import program
    from repro_torch.models import loss_fn
    cfg = program.config(conf).replace(remat=False)
    params = weights.nest(weights.draw_all(conf, 3, "cpu"))
    toks = torch.randint(0, conf["vocab_size"], (B, S + 1),
                         generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    leaves = list(weights.flatten(params).values())
    for p in leaves:
        p.requires_grad_(backward)
    with FlopCounterMode(display=False) as fc:
        total, _ = loss_fn(cfg, params, batch)
        if backward:
            torch.autograd.grad(total, leaves)
    return fc.get_total_flops()


def program_forward(conf) -> int:
    """What the program computes in a forward at these sizes: the dense
    path attends over every key and masks (the full square), and the
    experts run every slot of their capacity."""
    d, f, L = conf["hidden_size"], conf["intermediate_size"], \
        conf["num_hidden_layers"]
    full_attention = 4 * L * conf["num_attention_heads"] \
        * conf["head_dim"] * S * S * B
    n = bench.family(conf).matmul_params(conf)
    if conf.get("num_experts"):
        e, k = conf["num_experts"], conf["num_experts_per_tok"]
        cap = int(conf["capacity_factor"] * k * B * S / e)
        topk = L * k * 3 * d * f
        n = n - topk
        return 2 * n * B * S + 2 * L * e * cap * 3 * d * f + full_attention
    return 2 * n * B * S + full_attention


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-moe"])
def test_forward_flops_match_the_counter(name):
    conf = tiny_conf(name, "float32")
    assert counted(conf, backward=False) == program_forward(conf)


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-moe"])
def test_backward_is_twice_the_forward(name):
    conf = tiny_conf(name, "float32")
    assert counted(conf, backward=True) == 3 * counted(conf, backward=False)


def test_causal_attention_counts_each_key_at_or_before_its_query():
    conf = tiny_conf("tiny-dense", "float32")
    per_key = 4 * conf["num_hidden_layers"] * conf["num_attention_heads"] \
        * conf["head_dim"]
    assert flops.attention_flops(conf, 1, 0) == per_key
    assert flops.attention_flops(conf, 3, 0) == 6 * per_key
    assert flops.attention_flops(conf, 1, 9) == 10 * per_key
    whole = flops.attention_flops(conf, 5, 0)
    assert whole == flops.attention_flops(conf, 2, 0) \
        + flops.attention_flops(conf, 3, 2)


def test_train_step_is_three_forwards():
    conf = tiny_conf("tiny-dense", "float32")
    fwd = 2 * bench.family(conf).matmul_params(conf) * B * S \
        + B * flops.attention_flops(conf, S)
    assert flops.train_step_flops(conf, B, S) == 3 * fwd


def test_serve_request_counts_prefill_and_each_later_token():
    conf = tiny_conf("tiny-dense", "float32")
    n = 2 * bench.family(conf).matmul_params(conf)
    assert flops.serve_request_flops(conf, 10, 1) == \
        10 * n + flops.attention_flops(conf, 10)
    assert flops.serve_request_flops(conf, 10, 3) == \
        13 * n - n + flops.attention_flops(conf, 12)


@pytest.mark.parametrize("name", sorted(PB_CONFIGS))
def test_adamw_bytes_are_22_a_bf16_param(name):
    conf = json.loads(PB_CONFIGS[name].read_text())
    table = weights.leaves(conf)
    sizes = [(torch.Size(leaf.shape).numel(), leaf.dtype.itemsize)
             for leaf in table]
    n16 = sum(n for n, b in sizes if b == 2)
    n32 = sum(n for n, b in sizes if b == 4)
    assert flops.adamw_bytes(sizes) == 22 * n16 + 28 * n32
    assert n16 > 1000 * n32


def test_peaks_table():
    assert flops.peak("NVIDIA H100 80GB HBM3", "bf16_flops") == 989e12
    assert flops.peak("NVIDIA H100 80GB HBM3", "hbm_bytes_per_s") == 3.35e12
    assert flops.peak("cpu", "bf16_flops") is None
