"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's on the CPU: prefill and decode cells of one dense, one MoE,
one SSM and one hybrid smoke architecture on a (2, 2) mesh
(``tests/_torch_dryrun_ref.py``: the reference's ``_lower(...).compile()``
on 4 host devices with Auto axes, the port's step on fake tensors over a
fake process group; FLOPs against the partitioned HLO's dots), the
extrapolation, the cell records, the CLI and the fake world.  The train cells are in ``test_torch_dryrun_train.py``."""
import json

import pytest
import torch

import _torch_dryrun_ref as helper
import repro_torch.launch.dryrun as d
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeCfg

KINDS = ["prefill", "decode"]
CELLS = [f"{a}/{k}" for a in helper.ARCHS for k in KINDS]

FLOP_BAND = helper.FLOP_BAND


@pytest.fixture(scope="module")
def sides():
    result = helper.start_reference(KINDS)
    port = helper.port(KINDS)
    return result(), port


@pytest.mark.parametrize("cell", CELLS)
def test_argument_bytes_equal_the_reference(sides, cell):
    ref, port = sides
    assert port[cell]["argument_bytes"] == ref[cell]["argument_bytes"]


@pytest.mark.parametrize("cell", CELLS)
def test_output_bytes_equal_the_reference(sides, cell):
    """XLA's output size also counts the output tuple's table: one 8-byte
    pointer a leaf of the flattened outputs."""
    ref, port = sides
    p = port[cell]
    assert p["output_bytes"] + 8 * p["output_leaves"] == \
        ref[cell]["output_bytes"]


@pytest.mark.parametrize("cell", CELLS)
def test_flops_within_the_band_of_xla(sides, cell):
    """Against the dots of XLA's partitioned step, the same kind of work
    the port counts: equal, where no matmul replicates over 'model'."""
    ref, port = sides
    for n in (1, 2):
        ratio = port[cell][f"flops{n}"] / ref[cell][f"dots{n}"]
        assert FLOP_BAND[0] <= ratio <= FLOP_BAND[1], (n, ratio)
        if cell != helper.REPLICATED:
            assert port[cell][f"flops{n}"] == ref[cell][f"dots{n}"], n


def test_skipped_cell_equals_the_reference(sides):
    ref, _ = sides
    rec = d.run_cell(*helper.SKIPPED, multi_pod=False, verbose=False,
                     device="cpu")
    assert rec == ref["skipped"]
    assert rec["status"] == "skipped"


@pytest.mark.parametrize("arch,kind", [("gemma-2b", "train"),
                                       ("falcon-mamba-7b", "decode")])
def test_extrapolated_cost_equals_a_direct_count(arch, kind):
    cfg = get_config(arch, smoke=True).replace(n_layers=4)
    shape = ShapeCfg(*helper.shape_of(kind))
    dev = torch.device("cpu")
    with d._fake_world((2, 2), ("data", "model"), "cpu") as mesh:
        ext = d.extrapolated_cost(cfg, shape, mesh, dev)
        direct = d.count_cost(d._cost_cfg(cfg, 4), shape, mesh, dev)
    assert ext["units_extrapolated_to"] == 4
    assert ext["flops"] == direct.flops
    assert ext["collectives"]["total"] == direct.collectives["total"]
    assert {k: v for k, v in ext["collectives"].items() if v} == \
        {k: v for k, v in direct.collectives.items() if v}
    # bytes accessed are not linear in the depth to the byte (the
    # optimizer's work over the stacked leaves), so only within 1%
    assert ext["hbm_bytes"] == pytest.approx(direct.bytes_accessed,
                                             rel=1e-2)


def _train_shard_bytes(cfg, shape, mesh_shape):
    """Local shard bytes of the train state and the batch that
    ``train_shardings`` implies, from the specs alone (a shape-only
    mesh)."""
    from types import SimpleNamespace

    from repro_torch.configs.shapes import batch_specs
    from repro_torch.launch.steps import (default_optimizer, state_specs,
                                          train_shardings)
    from repro_torch.tree import leaves

    mesh = SimpleNamespace(mesh_dim_names=("data", "model"),
                           shape=mesh_shape)
    sizes = dict(zip(mesh.mesh_dim_names, mesh_shape))
    opt = default_optimizer(cfg)
    state_sh, bshard = train_shardings(cfg, opt, mesh)
    bsp = batch_specs(cfg, shape)
    total = 0
    for spec_tree, sh_tree in ((state_specs(cfg, opt), state_sh),
                               (bsp, {k: bshard(v) for k, v in bsp.items()})):
        for x, sh in zip(leaves(spec_tree), leaves(sh_tree)):
            n = x.element_size()
            for dim, entry in zip(x.shape, tuple(sh.spec)
                                  + (None,) * (x.dim() - len(sh.spec))):
                axes = (entry if isinstance(entry, tuple)
                        else (() if entry is None else (entry,)))
                ways = 1
                for ax in axes:
                    ways *= sizes[ax]
                n *= -(-dim // ways)
            total += n
    return total


def test_whisper_train_cell_on_the_production_mesh():
    """The counterpart of the reference's ``test_dryrun_cell_small_smoke``:
    whisper-base x train_4k on the 16x16 fake mesh, the proof only."""
    from repro_torch.configs import SHAPES

    rec = d.run_cell("whisper-base", "train_4k", multi_pod=False,
                     skip_cost=True, verbose=False, device="cpu")
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == 256 and rec["mesh"] == "16x16"
    assert rec["memory"]["argument_bytes"] == _train_shard_bytes(
        get_config("whisper-base"), SHAPES["train_4k"], (16, 16))
    mem = rec["memory"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert rec["memory_analysis_str"].startswith("MemTracker")


def test_error_cell_and_the_cli(tmp_path, capsys):
    out = tmp_path / "sub" / "d.jsonl"
    rc = d.main(["--arch", "gemma-2b", "--shape", "train_4k", "--override",
                 "no_such_field=1", "--mesh-shape", "1x4", "--tag", "t1",
                 "--skip-cost", "--device", "cpu", "--out", str(out)])
    assert rc == 1
    lines = out.read_text().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["status"] == "error" and "no_such_field" in rec["error"]
    assert "Traceback" in rec["traceback"]
    assert rec["tag"] == "t1" and rec["mesh"] == "1x4"
    assert rec["overrides"] == {"no_such_field": "1"}
    assert "1 failed" in capsys.readouterr().out
    assert d.parse_overrides(["a=true", "b=3", "c=0.5", "e=x"]) == \
        {"a": True, "b": 3, "c": 0.5, "e": "x"}


def test_the_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is real")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        d.run_cell("gemma-2b", "train_4k", multi_pod=False)


def test_fake_world_refuses_an_existing_group_and_leaves_none(tmp_path):
    import torch.distributed as dist

    with d._fake_world((2, 2), ("data", "model"), "cpu") as mesh:
        assert dist.get_world_size() == 4 and mesh.shape == (2, 2)
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="process of its own"):
            with d._fake_world((2, 2), ("data", "model"), "cpu"):
                pass
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()


def test_moe_counts_are_bincount():
    """``expert_counts`` (static shape, traceable on fake tensors) equals
    ``bincount`` integer for integer; the MoE module calls no bincount."""
    import inspect

    import repro_torch.models.moe as moe

    g = torch.Generator().manual_seed(0)
    for e in (1, 4, 64):
        ids = torch.randint(0, e, (257,), generator=g)
        assert torch.equal(moe.expert_counts(ids, e),
                           torch.bincount(ids, minlength=e))
    assert "torch.bincount" not in inspect.getsource(moe)
