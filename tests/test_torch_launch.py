"""The port's fault-tolerant loop and training launcher on the CPU.

tests/test_fault_tolerance.py's loop checks on torch state (restart-exact,
no duplicate steps in the history), then ``launch.train.run_training`` on
stablelm-3b smoke with a fault at step 17: it meets the reference's own
assertions (tests/test_serving_and_data.py, the end-to-end run), its final
checkpoint equals a fault-free run's bit for bit, and its per-step losses
equal a plain loop over the JAX package's jitted ``make_train_step`` (AdamW,
the same cosine schedule) on the same batches from the same initial params
at 1e-5 relative (float32; 1.7e-7 measured over the 30 steps).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.optim import schedule_cosine as j_cosine  # noqa: E402

from _torch_train_anchors import one_torch_thread  # noqa: E402,F401

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.train import main, run_training  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.runtime import (FaultInjector,  # noqa: E402
                                 FaultTolerantLoop)
from repro_torch.tree import named_leaves  # noqa: E402

RUN = dict(smoke=True, steps=30, batch=4, seq=32, ckpt_every=10,
           optimizer="adamw", lr=3e-3, log_every=100, seed=0)
LOSS_RTOL = 1e-5


def _toy():
    def train_step(state, batch):
        new = {"w": state["w"] + torch.sum(batch["x"]),
               "step": state["step"] + 1}
        return new, {"loss": float(torch.sum(batch["x"]))}

    def make_state():
        return {"w": torch.zeros(()), "step": torch.tensor(0)}

    def batch_at(step):
        rng = np.random.default_rng(step)
        return {"x": torch.as_tensor(rng.normal(size=(4,)),
                                     dtype=torch.float32)}

    return train_step, make_state, batch_at


def _run_toy(fail_at, path):
    train_step, make_state, batch_at = _toy()
    mgr = CheckpointManager(path, keep=2, async_write=False)
    spec = {"w": torch.empty((), device="meta"),
            "step": torch.empty((), dtype=torch.int64, device="meta")}
    loop = FaultTolerantLoop(train_step, make_state, batch_at, mgr,
                             ckpt_every=5, device="cpu", abstract_state=spec,
                             fault_injector=FaultInjector(fail_at))
    res = loop.run(20)
    final, _ = mgr.restore(spec, "cpu")
    return res, final


def test_fault_tolerant_loop_restarts_exactly(tmp_path):
    """Injected faults at steps 7 and 13; the loop must finish all 20 steps
    and produce the SAME final state as a fault-free run (determinism)."""
    res_f, final_f = _run_toy((7, 13), str(tmp_path / "a"))
    res_c, final_c = _run_toy((), str(tmp_path / "b"))
    assert res_f.final_step == res_c.final_step == 20
    assert res_f.restarts == 2 and res_c.restarts == 0
    assert torch.equal(final_f["w"], final_c["w"])
    assert int(final_f["step"]) == 20


def test_fault_tolerant_loop_history_no_duplicate_steps(tmp_path):
    """Faults at 7 and 13 re-run steps 6-7 and 11-13 after restoring the
    step-5 / step-10 checkpoints: the history holds each step once and
    matches a fault-free run's metrics."""
    res_f, _ = _run_toy((7, 13), str(tmp_path / "a"))
    res_c, _ = _run_toy((), str(tmp_path / "b"))
    steps_f = [m["step"] for m in res_f.metrics_history]
    assert steps_f == list(range(1, 21)), "history has duplicate/missing steps"
    assert res_f.metrics_history == res_c.metrics_history


def _reference_losses(steps, batch, seq, lr, seed):
    """A plain loop over the reference's jitted train step from the port's
    initial params, on the port's batches."""
    cfg, jcfg = get_config("stablelm-3b", True), j_get_config("stablelm-3b",
                                                             True)
    gen = torch.Generator().manual_seed(seed)
    params = jax.tree.map(lambda x: jnp.asarray(x.numpy()),
                          init_params(cfg, gen, "cpu"))
    opt = j_adamw(j_cosine(lr, warmup=max(steps // 20, 5), total=steps))
    step = jax.jit(JS.make_train_step(jcfg, opt))
    state = JS.TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    ds = make_dataset(cfg, seq_len=seq, global_batch=batch, seed=seed)
    losses = []
    for s in range(steps):
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in ds.batch_at(s).items()})
        losses.append(float(m["loss"]))
    return losses


def test_run_training_restarts_and_equals_the_reference_loop(tmp_path):
    lines = []
    res = run_training("stablelm-3b", ckpt_dir=str(tmp_path / "f"),
                       fail_at=(17,), print_fn=lines.append, device="cpu",
                       **RUN)
    # the reference's own assertions
    assert res.final_step == 30
    assert res.restarts == 1
    losses = [m["loss"] for m in res.metrics_history]
    assert losses[-1] < losses[0]
    assert [m["step"] for m in res.metrics_history] == list(range(1, 31))
    assert all(isinstance(v, float) for m in res.metrics_history
               for k, v in m.items() if k != "step")
    assert lines[-1].startswith("done: 30 steps, 1 restarts") \
        and "tok/s" in lines[-1]

    clean = run_training("stablelm-3b", ckpt_dir=str(tmp_path / "c"),
                         print_fn=lines.append, device="cpu", **RUN)
    assert [m["loss"] for m in clean.metrics_history] == losses
    cfg = get_config("stablelm-3b", smoke=True)
    spec = TS.state_specs(cfg, TS.default_optimizer(cfg))
    finals = [CheckpointManager(str(tmp_path / d)).restore(spec, "cpu")
              for d in ("f", "c")]
    assert finals[0][1] == finals[1][1] == 30
    for (name, a), (_, b) in zip(named_leaves(finals[0][0]),
                                 named_leaves(finals[1][0])):
        assert torch.equal(a, b), name

    want = _reference_losses(30, 4, 32, 3e-3, 0)
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)


def test_launcher_cli_and_refusals(tmp_path, capsys):
    main(["--arch", "gemma-2b", "--smoke", "--steps", "3", "--batch", "2",
          "--seq", "8", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"],
         device="cpu")
    out = capsys.readouterr().out
    assert "done: 3 steps, 0 restarts" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2", "step_3"]
    # a mesh of two ranks needs a process group of two (torchrun)
    with pytest.raises(RuntimeError, match="torchrun"):
        run_training("gemma-2b", steps=1, mesh_shape=(2, 1), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_training("gemma-2b", steps=1)


def test_run_training_grad_accum_and_sgd(tmp_path):
    res = run_training("lm-100m", smoke=True, steps=4, batch=4, seq=16,
                       n_micro=2, optimizer="sgd", lr=1e-2,
                       print_fn=lambda *a: None, device="cpu")
    assert res.final_step == 4 and res.restarts == 0
    assert sorted(res.metrics_history[0]) == ["loss", "step"]
