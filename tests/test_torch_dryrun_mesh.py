"""The port's dry-run on meshes that shard the vocab and the model dims over
'model' alone: decode cells on a (1, 4) mesh against the reference's
``_lower(...).compile()`` on 4 host devices with Auto axes shaped (1, 4)
(``tests/_torch_dryrun_ref.py``), the decode step's compute split over the
'model' ranks, bridge_validation §1's pair, and the loss's memory on a
mesh whose vocab is sharded.

The (1, 4) cells settle whether the batch-1 decode step's work replicates
over the 'model' ranks (§1 read a 1x256 mesh slower than 16x16): the
port's arguments and outputs equal XLA's byte for byte, its FLOPs equal
those of the dots in XLA's per-device program, and they are exactly a
quarter of the same step's on one rank."""
import pytest
import torch

import _torch_dryrun_ref as helper
import repro_torch.launch.dryrun as d
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeCfg

MESH = (1, 4)
ARCHS = ["falcon-mamba-7b", "gemma-2b"]
CELLS = [f"{a}/decode" for a in ARCHS]


@pytest.fixture(scope="module")
def sides():
    result = helper.start_reference(["decode"], MESH, ARCHS)
    port = helper.port(["decode"], MESH, ARCHS)
    return result(), port


@pytest.mark.parametrize("cell", CELLS)
def test_argument_and_output_bytes_equal_the_reference(sides, cell):
    """Output bytes: XLA's also count one 8-byte tuple pointer a leaf."""
    ref, port = sides
    p = port[cell]
    assert p["argument_bytes"] == ref[cell]["argument_bytes"]
    assert p["output_bytes"] + 8 * p["output_leaves"] == \
        ref[cell]["output_bytes"]


@pytest.mark.parametrize("cell", CELLS)
def test_flops_equal_the_dots_of_xla(sides, cell):
    """Each rank runs the matmuls XLA's partitioned step runs: the port's
    FLOPs equal the FLOPs of the dots in XLA's per-device HLO, depth 1
    and 2 (and so lie in the band of all of XLA's FLOPs)."""
    ref, port = sides
    for n in (1, 2):
        assert port[cell][f"flops{n}"] == ref[cell][f"dots{n}"], n
        ratio = port[cell][f"flops{n}"] / ref[cell][f"flops{n}"]
        assert helper.FLOP_BAND[0] <= ratio <= helper.FLOP_BAND[1], \
            (n, ratio)


@pytest.mark.parametrize("arch", ARCHS)
def test_no_decode_work_replicates_over_the_model_ranks(arch):
    """Each rank of the (1, 4) mesh counts a quarter of one rank's FLOPs,
    at depth 1 and 2: the embedding's pending vocab sum is taken before
    the first layer, and the SSM's x_proj sum before dt_proj, so no
    projection runs on a gathered weight."""
    shape = ShapeCfg(*helper.shape_of("decode"))
    dev = torch.device("cpu")
    for n in (1, 2):
        cfg = d._cost_cfg(get_config(arch, smoke=True), n)
        with d._fake_world((1, 1), ("data", "model"), "cpu") as mesh:
            one = d.count_cost(cfg, shape, mesh, dev).flops
        with d._fake_world(MESH, ("data", "model"), "cpu") as mesh:
            four = d.count_cost(cfg, shape, mesh, dev).flops
        assert 4 * four == one, (n, four, one)


def test_long_decode_remesh_agrees_at_two_layers(tmp_path, monkeypatch):
    """bridge_validation §1 on falcon-mamba-7b x long_500k cut to two
    layers: the 1x256 mesh's memory term is under a quarter of 16x16's,
    as the TOPS bridge predicts."""
    from repro_torch.bench import bridge_validation

    monkeypatch.chdir(tmp_path)
    common = ["--arch", "falcon-mamba-7b", "--shape", "long_500k",
              "--override", "n_layers=2", "--device", "cpu", "--out",
              "results/perf_iters.jsonl"]
    assert d.main(common + ["--tag", "long_i0_falcon_base_refresh"]) == 0
    assert d.main(common + ["--mesh-shape", "1x256",
                            "--tag", "long_i1_falcon_mesh1x256"]) == 0
    got = bridge_validation.run(device="cpu", print_fn=lambda *_: None)
    assert got["long_decode_remesh_agrees"] is True
    assert got["long_decode_speedup"] > 4


def test_vocab_sharded_loss_makes_no_global_logits():
    """A train step of gemma-2b smoke (vocab raised to 4096, so the
    logits are the step's largest activation) on a fake (2, 4) mesh, the
    vocab over the 4 'model' ranks: the step's temp bytes a device stay
    below the bytes of the global (B, S, V) float32 logits, which a
    gathered logsumexp or a gather's replicated gradient would make."""
    cfg = get_config("gemma-2b", smoke=True).replace(vocab=4096)
    shape = ShapeCfg("train_vocab", "train", 64, 16)
    with d._fake_world((2, 4), ("data", "model"), "cpu") as mesh:
        mem = d.proof(cfg, shape, mesh, torch.device("cpu"))["memory"]
    logits = shape.global_batch * shape.seq_len * cfg.vocab_padded * 4
    assert mem["temp_bytes"] < logits, (mem, logits)
