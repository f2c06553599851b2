"""Training launcher, on the CUDA card unless the caller asks for the CPU.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --smoke \
      --steps 200 --batch 8 --seq 128 --ckpt-dir ckpt

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch olmoe-1b-7b --smoke --steps 8 --batch 4 --seq 16 --dp 2 --tp 2

The counterpart of ``repro/launch/train.py``: train_step -> deterministic
data -> fault-tolerant loop (checkpoint/restart, straggler telemetry).
Over a ('data', 'model') mesh of ``--dp`` x ``--tp`` ranks (one process a
rank, one device each: ``torchrun`` supplies ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``) it trains through the sharded step ``jit_train_step``.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import shutil
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


def _distributed() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def init_from_env(device=None) -> bool:
    """Open the default process group from ``torchrun``'s environment
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``), NCCL
    on the cards (each rank on card ``LOCAL_RANK``) and gloo on the CPU.
    Returns whether a group is open."""
    import torch
    import torch.distributed as dist

    if _distributed() or "WORLD_SIZE" not in os.environ:
        return _distributed()
    if device is not None and torch.device(device).type == "cpu":
        dist.init_process_group("gloo")
        return True
    card = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(card)
    dist.init_process_group("nccl", device_id=card)
    return True


@contextlib.contextmanager
def _checkpoint_dir(ckpt_dir: Optional[str], shared: bool):
    """``ckpt_dir``, or a temporary directory removed at the end; across
    ranks (``shared``) rank 0 makes it and the others get its path."""
    if ckpt_dir:
        yield ckpt_dir
        return
    import torch.distributed as dist

    rank0 = not shared or dist.get_rank() == 0
    path = [tempfile.mkdtemp(prefix="repro_torch_ckpt_") if rank0 else None]
    if shared:
        dist.broadcast_object_list(path, src=0)
    try:
        yield path[0]
    finally:
        if shared:
            dist.barrier()
        if rank0:
            shutil.rmtree(path[0], ignore_errors=True)


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
    is removed at the end.

    On a mesh other than (1, 1), or whenever a process group is open (a
    launch under ``torchrun``), every rank calls this: it builds the
    ('data', 'model') mesh of ``mesh_shape`` over the group and the rules
    ``make_rules(mesh, fsdp=cfg.fsdp, seq_activations=
    cfg.seq_shard_activations)``, trains through ``jit_train_step``, and
    only rank 0 prints.  At (1, 1) with no process group it takes the
    one-device step (``make_train_step``): a 1x1 mesh shards nothing, so
    the one-device numbers stay comparable."""
    import torch

    from ..checkpoint import CheckpointManager
    from ..configs import get_config
    from ..data import make_dataset
    from ..device import resolve_device
    from ..dist.sharding import distribute_tree, make_rules
    from ..launch.mesh import make_mesh
    from ..launch.steps import (TrainState, default_optimizer,
                                jit_train_step, make_grad_accum_train_step,
                                make_train_step, state_specs)
    from ..models import init_params
    from ..optim import adamw, schedule_cosine, sgd
    from ..runtime import FaultInjector, FaultTolerantLoop, StragglerDetector

    dev = resolve_device(device)
    sharded = tuple(mesh_shape) != (1, 1) or _distributed()
    if sharded:
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError(
                f"mesh {tuple(mesh_shape)} needs one process a rank: launch "
                f"under torchrun --nproc-per-node "
                f"{mesh_shape[0] * mesh_shape[1]}")
        if dist.get_rank() != 0:
            print_fn = lambda *a, **k: None  # noqa: E731
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
    state_sh = None
    if sharded:
        mesh = make_mesh(mesh_shape, ("data", "model"), dev.type)
        rules = make_rules(mesh, fsdp=cfg.fsdp,
                           seq_activations=cfg.seq_shard_activations)
        batch_specs = {k: torch.empty(v.shape, device="meta")
                       for k, v in ds.batch_at(0).items()}
        step_fn, state_sh, _ = jit_train_step(cfg, opt, mesh, batch_specs,
                                              rules, n_micro)
    else:
        step_fn = (make_train_step(cfg, opt) if n_micro <= 1
                   else make_grad_accum_train_step(cfg, opt, n_micro))

    def make_state():
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
        params = init_params(cfg, generator, dev)
        if state_sh is not None:
            # every rank drew the same params: each keeps its shards
            params = distribute_tree(params, state_sh.params)
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

    with _checkpoint_dir(ckpt_dir, sharded) as path:
        ckpt = CheckpointManager(path, keep=2)
        loop = FaultTolerantLoop(
            train_step=step_fn, make_state=make_state,
            batch_at=lambda s: {k: torch.as_tensor(v, device=dev)
                                for k, v in ds.batch_at(s).items()},
            ckpt_manager=ckpt, ckpt_every=ckpt_every, device=dev,
            shardings=state_sh, abstract_state=state_specs(cfg, opt),
            fault_injector=FaultInjector(fail_at) if fail_at else None)
        t0 = t_last[0] = time.time()
        result = loop.run(steps, on_metrics=on_metrics)
        to_last_step, wall = t_last[0] - t0, time.time() - t0
    losses = [m["loss"] for m in result.metrics_history]
    print_fn(f"done: {result.final_step} steps, {result.restarts} restarts, "
             f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
             f"{steps * batch * seq / to_last_step:.1f} tok/s "
             f"({to_last_step:.2f} s from the loop's start to the last "
             f"step, {wall:.2f} s with the final checkpoint) on {dev}"
             + (f", mesh {tuple(mesh_shape)}" if sharded else ""))
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
    init_from_env(device)
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
