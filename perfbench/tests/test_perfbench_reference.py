"""The plain reference against the program at smoke sizes on the CPU, in
float32, where the two must agree to rounding: the loss and every
leaf's gradient (capacity drops included), three AdamW steps through
the harness's own check, and greedy serving through left-padded waves."""
import time

import pytest
import torch

from perfbench import bench, weights
from perfbench.reference import model as reference
from perfbench.tests.conftest import add_tiny_cells, copy_benchmark, tiny_conf


@pytest.fixture(scope="module")
def fp32_root(tmp_path_factory):
    root = copy_benchmark(tmp_path_factory.mktemp("fp32"))
    add_tiny_cells(root, "float32")
    return root


@pytest.mark.parametrize("name,extra", [
    ("tiny-dense", {}), ("tiny-moe", {}),
    ("tiny-moe", {"capacity_factor": 0.5})], ids=["dense", "moe", "drops"])
def test_loss_and_gradients_match_the_program(name, extra):
    from perfbench import program
    from repro_torch.models import loss_fn
    conf = tiny_conf(name, "float32", **extra)
    cfg = program.config(conf)
    flat = weights.draw_all(conf, 5, "cpu")
    toks = torch.randint(0, conf["vocab_size"], (2, 41),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for p in flat.values():
        p.requires_grad_(True)
    total, _ = loss_fn(cfg, weights.nest(flat), batch)
    got = torch.autograd.grad(total, list(flat.values()))
    ref_params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in flat.items()}
    spec = reference.Spec.from_config(conf)
    want_total, _ = reference.loss(spec, ref_params, batch["tokens"],
                                   batch["labels"])
    want = torch.autograd.grad(want_total, list(ref_params.values()))
    assert float(total) == pytest.approx(float(want_total), rel=1e-5)
    for path, g, w in zip(flat, got, want):
        scale = float(w.abs().max()) + 1e-12
        assert float((g - w).abs().max()) <= 1e-4 * scale, path
    if extra:
        # the capacity binds: some assignments were dropped
        from repro_torch.models import moe
        assert moe._capacity(cfg, 80) < 2 * 80 / 8


@pytest.mark.parametrize("cell", ["tiny-dense.train", "tiny-moe.train",
                                  "tiny-dense.serve"])
def test_harness_check_is_tight_in_float32(fp32_root, cell):
    r = bench.run_cell(fp32_root, cell, 2**33 + 1, 0.5, False, "cpu",
                       time.perf_counter())
    assert r["correct"]
    for name, c in r["checks"].items():
        assert c["value"] <= 2e-4, (name, c["value"])


def test_served_tokens_are_the_reference_argmax(fp32_root):
    from perfbench.kinds import serve
    cell = bench.Cell.load(fp32_root, "tiny-dense.serve")
    run = bench.Run(cell, 77, 0.3, False, "cpu", time.perf_counter())
    judged = serve.run(run)["observed"]["judged"]
    spec = reference.Spec.from_config(cell.conf)
    params = weights.draw_all(cell.conf, 77, "cpu", torch.float32,
                              cell.mix.get("qk_gain", 1.0))
    padded = 0
    for s in judged:
        logits = reference.logits_at(spec, params, torch.as_tensor(
            s["tokens"]), s["first"])
        assert logits.argmax(-1).tolist() == s["served"].tolist()
        padded += int((s["tokens"][:s["first"]] == serve.PAD_ID).sum())
    assert padded > 0     # the sample holds left-padded prompts
