"""End-to-end driver: train the ~110M-parameter `lm-100m` for a few hundred
steps through the full substrate — train step, deterministic data
pipeline, async checkpointing, fault-tolerant loop (one injected fault to
demonstrate restart), straggler telemetry.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_end_to_end [--steps 200]
(on the CUDA card; ``main(argv, device="cpu")`` runs it on the CPU, ~100M
there: expect a few seconds/step.  Use --smoke for a quick pass.)

Without ``--ckpt-dir`` the checkpoints go to a temporary directory that is
removed at the end, as ``run_training``'s do; a directory that is given
resumes from the checkpoint it holds.
"""
import argparse

from ..launch.train import run_training


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced model (fast CPU pass)")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)

    return run_training(
        "lm-100m", smoke=args.smoke, steps=args.steps, batch=args.batch,
        seq=args.seq, ckpt_dir=args.ckpt_dir, ckpt_every=50,
        optimizer="adamw", lr=6e-4,
        fail_at=(args.steps // 2,),       # demonstrate checkpoint/restart
        log_every=10, device=device)


if __name__ == "__main__":
    main()
