"""Training launcher, on the CUDA card unless the caller asks for the CPU.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --smoke \
      --steps 200 --batch 8 --seq 128 --ckpt-dir ckpt

The counterpart of ``repro/launch/train.py``: train_step -> deterministic
data -> fault-tolerant loop (checkpoint/restart, straggler telemetry), on
one device.  A mesh other than (1, 1) needs the distribution layer, which
the port does not have yet (ROADMAP.md, Queue 1 #3).
"""
from __future__ import annotations

import argparse
import tempfile
import time
from typing import Optional


def pick_mesh_autoshard(arch: str, seq: int, batch: int, n_chips: int,
                        print_fn=print):
    """Flexibility-aware deployment: run the TOPS pod-level DSE
    (``core.tops_bridge``) and take the best feasible mapping — the
    paper's constrained mapper used as an auto-sharding tool."""
    from ..configs import get_config
    from ..configs.shapes import ShapeCfg
    from ..core.tops_bridge import autoshard

    cfg = get_config(arch)
    shape = ShapeCfg("custom", "train", seq, batch)
    (m, c), *_ = autoshard(cfg, shape, n_chips=n_chips, flexible=True)
    print_fn(f"[autoshard] {arch}: mesh {m.dp}x{m.tp} fsdp={m.fsdp} "
             f"seqP={m.seq_acts} micro={m.n_micro} remat={m.remat} "
             f"(predicted bound {c.bound_s*1e3:.1f} ms, {c.dominant}-bound)")
    return (m.dp, m.tp), dict(fsdp=m.fsdp, seq_shard_activations=m.seq_acts,
                              remat=m.remat), m.n_micro


def run_training(arch: str, smoke: bool = True, steps: int = 100,
                 batch: int = 8, seq: int = 128,
                 mesh_shape=(1, 1), ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 50, log_every: int = 10,
                 optimizer: str = "auto", lr: float = 3e-4,
                 fail_at=(), seed: int = 0, n_micro: int = 1,
                 config_overrides: Optional[dict] = None,
                 print_fn=print, device=None):
    """Train ``arch`` from params drawn from ``seed`` on ``device``; returns
    the loop's LoopResult (floats only: the state is freed on return).
    Without ``ckpt_dir`` the checkpoints go to a temporary directory that
    is removed at the end."""
    import torch

    from ..checkpoint import CheckpointManager
    from ..configs import get_config
    from ..data import make_dataset
    from ..device import resolve_device
    from ..launch.steps import (TrainState, default_optimizer,
                                make_grad_accum_train_step, make_train_step,
                                state_specs)
    from ..models import init_params
    from ..optim import adamw, schedule_cosine, sgd
    from ..runtime import FaultInjector, FaultTolerantLoop, StragglerDetector

    if tuple(mesh_shape) != (1, 1):
        raise NotImplementedError(
            f"mesh {tuple(mesh_shape)}: the port trains on one device; a "
            f"device mesh needs the distribution layer (ROADMAP.md, "
            f"Queue 1 #3)")
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    if config_overrides:
        cfg = cfg.replace(**config_overrides)

    if optimizer == "auto":
        opt = default_optimizer(cfg)
    elif optimizer == "adamw":
        opt = adamw(schedule_cosine(lr, warmup=max(steps // 20, 5),
                                    total=steps))
    else:
        opt = sgd(lr)

    ds = make_dataset(cfg, seq_len=seq, global_batch=batch, seed=seed)
    step_fn = (make_train_step(cfg, opt) if n_micro <= 1
               else make_grad_accum_train_step(cfg, opt, n_micro))

    def make_state():
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
        params = init_params(cfg, generator, dev)
        return TrainState(params=params, opt=opt.init(params),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=dev))

    straggler = StragglerDetector(n_workers=1)
    t_last = [time.time()]

    def on_metrics(m):
        now = time.time()
        straggler.record(0, now - t_last[0])
        t_last[0] = now
        if int(m["step"]) % log_every == 0:
            print_fn(f"step {int(m['step']):5d}  loss {m['loss']:.4f}")

    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as tmp:
        ckpt = CheckpointManager(ckpt_dir or tmp, keep=2)
        loop = FaultTolerantLoop(
            train_step=step_fn, make_state=make_state,
            batch_at=lambda s: {k: torch.as_tensor(v, device=dev)
                                for k, v in ds.batch_at(s).items()},
            ckpt_manager=ckpt, ckpt_every=ckpt_every, device=dev,
            abstract_state=state_specs(cfg, opt),
            fault_injector=FaultInjector(fail_at) if fail_at else None)
        t0 = t_last[0] = time.time()
        result = loop.run(steps, on_metrics=on_metrics)
        to_last_step, wall = t_last[0] - t0, time.time() - t0
    losses = [m["loss"] for m in result.metrics_history]
    print_fn(f"done: {result.final_step} steps, {result.restarts} restarts, "
             f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
             f"{steps * batch * seq / to_last_step:.1f} tok/s "
             f"({to_last_step:.2f} s from the loop's start to the last "
             f"step, {wall:.2f} s with the final checkpoint) on {dev}")
    return result


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--optimizer", default="auto")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--autoshard", action="store_true",
                    help="pick mesh/FSDP/SP/microbatch via the TOPS "
                         "pod-level DSE (dp*tp = --dp * --tp chips)")
    args = ap.parse_args(argv)
    mesh_shape, overrides, n_micro = (args.dp, args.tp), None, args.n_micro
    if args.autoshard:
        mesh_shape, overrides, n_micro = pick_mesh_autoshard(
            args.arch, args.seq, args.batch, args.dp * args.tp)
    run_training(args.arch, smoke=args.smoke, steps=args.steps,
                 batch=args.batch, seq=args.seq,
                 mesh_shape=mesh_shape, ckpt_dir=args.ckpt_dir,
                 ckpt_every=args.ckpt_every, optimizer=args.optimizer,
                 lr=args.lr, seed=args.seed, n_micro=n_micro,
                 config_overrides=overrides, device=device)


if __name__ == "__main__":
    main()
