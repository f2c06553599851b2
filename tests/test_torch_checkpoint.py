"""The port's checkpoints (``repro_torch.checkpoint``): round trips of
float32, bfloat16 and int32 leaves; the keep-latest-k manager; atomic
renames (no ``.tmp`` is ever taken for a checkpoint); host copies taken
before an async save returns; and checkpoints that cross between the
packages: a TrainState written by the JAX package (bfloat16 params
included) restores in the port, and the port writes the same state to the
same files, byte for byte, which the reference restores where it can
restore its own (its ``restore_state`` has no cast from the ``<V2`` records
that bfloat16 leaves are stored as, for its own files and the port's
alike)."""
import filecmp
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore_state as j_restore  # noqa: E402
from repro.checkpoint import save_state as j_save  # noqa: E402
from repro.launch.steps import TrainState as JTrainState  # noqa: E402

from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    latest_step, restore_state, save_state)
from repro_torch.checkpoint import checkpoint as ckpt_mod  # noqa: E402
from repro_torch.launch.steps import TrainState, state_specs  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32),
            "m": rng.standard_normal((6, 5)).astype(np.float32)}


def _port_state(a, param_dtype=torch.bfloat16):
    return TrainState(
        params={"layer": {"w": torch.from_numpy(a["w"]).to(param_dtype)},
                "b": torch.from_numpy(a["b"])},
        opt={"m": {"layer": {"w": torch.from_numpy(a["m"])},
                   "b": torch.zeros(5)}},
        step=torch.tensor(7, dtype=torch.int32))


def _ref_state(a, param_dtype=jnp.bfloat16):
    return JTrainState(
        params={"layer": {"w": jnp.asarray(a["w"], param_dtype)},
                "b": jnp.asarray(a["b"])},
        opt={"m": {"layer": {"w": jnp.asarray(a["m"])},
                   "b": jnp.zeros(5)}},
        step=jnp.asarray(7, jnp.int32))


def _equal(got, want):
    for x, y in zip(leaves(got), leaves(want)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_roundtrip_float32_bfloat16_int32(tmp_path):
    state = _port_state(_arrays())
    save_state(str(tmp_path), 7, state)
    restored = restore_state(str(tmp_path), 7, state, "cpu")
    assert isinstance(restored, TrainState)
    _equal(restored, state)
    assert restored.step.dtype == torch.int32 and restored.step.dim() == 0


def test_restore_onto_meta_specs_casts_to_the_spec_dtype(tmp_path):
    state = {"a": torch.arange(12.0).reshape(3, 4),
             "b": {"c": torch.ones((5,), dtype=torch.int32)}}
    save_state(str(tmp_path), 3, state)
    spec = {"a": torch.empty((3, 4), dtype=torch.bfloat16, device="meta"),
            "b": {"c": torch.empty((5,), dtype=torch.int32, device="meta")}}
    got = restore_state(str(tmp_path), 3, spec, "cpu")
    assert got["a"].dtype == torch.bfloat16 and got["a"].device.type == "cpu"
    assert torch.equal(got["a"], state["a"].bfloat16())
    with pytest.raises(ValueError, match="shape"):
        restore_state(str(tmp_path), 3,
                      {"a": torch.empty((4, 3), device="meta"),
                       "b": {"c": torch.empty((5,), device="meta")}}, "cpu")
    with pytest.raises(ValueError, match="leaves"):
        restore_state(str(tmp_path), 3, {"a": spec["a"]}, "cpu")


def test_restore_onto_the_card_by_default_raises_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    save_state(str(tmp_path), 0, {"x": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore_state(str(tmp_path), 0, {"x": torch.zeros(2)})


def test_train_state_specs_match_a_written_state(tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config("gemma-2b", smoke=True)
    opt = adamw(1e-3)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = TrainState(params, opt.init(params),
                       torch.tensor(2, dtype=torch.int32))
    save_state(str(tmp_path), 2, state)
    _equal(restore_state(str(tmp_path), 2, state_specs(cfg, opt), "cpu"),
           state)


def test_checkpoint_manager_keep_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=True)
    state = {"x": torch.zeros((4,))}
    for step in (10, 20, 30):
        mgr.save(step, state)
    mgr.wait()
    assert mgr.latest() == 30
    dirs = sorted(os.listdir(tmp_path))
    assert "step_10" not in dirs and "step_30" in dirs
    restored, step = mgr.restore({"x": torch.empty(4, device="meta")},
                                 "cpu")
    assert step == 30 and torch.equal(restored["x"], state["x"])
    assert CheckpointManager(str(tmp_path / "none")).restore(
        {"x": torch.zeros(4)}, "cpu") == (None, None)


def test_no_tmp_is_ever_taken_for_a_checkpoint(tmp_path, monkeypatch):
    """A write in flight sits in ``step_<N>.tmp``; until it is renamed,
    ``latest`` does not see it, and after the rename no ``.tmp`` is left."""
    release = threading.Event()
    write_leaf = ckpt_mod._write_leaf

    def slow(path, a, dtype):
        assert release.wait(10)
        write_leaf(path, a, dtype)

    mgr = CheckpointManager(str(tmp_path), keep=3, async_write=True)
    mgr.save(5, {"x": torch.ones(3)})
    mgr.wait()
    monkeypatch.setattr(ckpt_mod, "_write_leaf", slow)
    mgr.save(6, {"x": torch.ones(3)})
    assert sorted(os.listdir(tmp_path)) == ["step_5", "step_6.tmp"]
    assert mgr.latest() == 5 and latest_step(str(tmp_path)) == 5
    release.set()
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_5", "step_6"]
    assert mgr.latest() == 6
    # a .tmp left by a crash is never taken, even with a manifest in it
    os.makedirs(tmp_path / "step_9.tmp")
    (tmp_path / "step_9.tmp" / "manifest.json").write_text("{}")
    assert mgr.latest() == 6


def test_async_save_snapshots_before_it_returns(tmp_path, monkeypatch):
    """An optimizer updates its tensors in place right after ``save``: the
    checkpoint holds the values at the save."""
    release = threading.Event()
    write_leaf = ckpt_mod._write_leaf

    def slow(path, a, dtype):
        assert release.wait(10)
        write_leaf(path, a, dtype)

    monkeypatch.setattr(ckpt_mod, "_write_leaf", slow)
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    state = {"w": torch.ones(4), "h": torch.ones(4, dtype=torch.bfloat16)}
    mgr.save(1, state)
    for x in state.values():
        x.add_(1.0)
    release.set()
    restored, _ = mgr.restore({k: torch.empty_like(v, device="meta")
                               for k, v in state.items()}, "cpu")
    for k in state:
        assert torch.equal(restored[k], torch.ones_like(state[k])), k


def test_reference_written_state_restores_in_the_port(tmp_path):
    a = _arrays(1)
    j_save(str(tmp_path), 7, _ref_state(a))
    want = _port_state(a)
    _equal(restore_state(str(tmp_path), 7, want, "cpu"), want)


@pytest.mark.parametrize("param_dtype", ["bfloat16", "float32"])
def test_port_writes_the_reference_files_byte_for_byte(tmp_path,
                                                       param_dtype):
    a = _arrays(2)
    tdt = getattr(torch, param_dtype)
    jdt = getattr(jnp, param_dtype)
    save_state(str(tmp_path / "port"), 7, _port_state(a, tdt))
    j_save(str(tmp_path / "ref"), 7, _ref_state(a, jdt))
    port, ref = tmp_path / "port" / "step_7", tmp_path / "ref" / "step_7"
    names = sorted(os.listdir(ref))
    assert names == sorted(os.listdir(port))
    assert names == ["leaf_0.npy", "leaf_1.npy", "leaf_2.npy", "leaf_3.npy",
                     "leaf_4.npy", "manifest.json"]
    for name in names:
        assert filecmp.cmp(port / name, ref / name, shallow=False), name
    spec = jax.eval_shape(lambda: _ref_state(a, jdt))
    if param_dtype == "float32":
        got = j_restore(str(tmp_path / "port"), 7, spec)
        for x, y in zip(jax.tree.leaves(got),
                        jax.tree.leaves(_ref_state(a, jdt))):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    else:
        # the reference's own restore of bfloat16 leaves (a caveat of the
        # reference, not of the port): the same error for either file
        for where in ("port", "ref"):
            with pytest.raises(ValueError, match="cast"):
                j_restore(str(tmp_path / where), 7, spec)
        # what it wrote reads back through numpy as the reference's values
        raw = np.load(port / "leaf_1.npy")
        assert raw.dtype.str == "|V2"
        np.testing.assert_array_equal(
            raw.view(jnp.bfloat16),
            np.asarray(_ref_state(a, jdt).params["layer"]["w"]))
