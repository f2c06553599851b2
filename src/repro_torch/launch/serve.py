"""Serving launcher: batched requests through the ServeEngine, on the CUDA
card unless the caller asks for the CPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      --requests 8 --max-new 16
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def run_serving(arch: str, smoke: bool = True, n_requests: int = 8,
                max_new: int = 16, max_batch: int = 4, seed: int = 0,
                print_fn=print, device=None):
    """The reference's request mix (prompts of 4–31 tokens, even uids
    greedy and odd ones at temperature 0.8) against params drawn from
    ``seed``; returns the Results."""
    from ..configs import get_config
    from ..device import resolve_device
    from ..models import init_params
    from ..serve import Request, ServeEngine

    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    params = init_params(cfg, generator, dev)
    engine = ServeEngine(cfg, params, max_batch=max_batch,
                         max_len=64 + max_new, seed=seed)

    rng = np.random.default_rng(seed)
    for i in range(n_requests):
        plen = int(rng.integers(4, 32))
        engine.submit(Request(
            uid=i, prompt=rng.integers(1, cfg.vocab, plen).astype(np.int32),
            max_new_tokens=max_new,
            temperature=0.0 if i % 2 == 0 else 0.8))

    t0 = time.time()
    results = engine.run_all()
    dt = time.time() - t0
    total_tokens = sum(len(r.tokens) for r in results)
    print_fn(f"served {len(results)} requests, {total_tokens} tokens "
             f"in {dt:.2f}s ({total_tokens / dt:.1f} tok/s) on {dev}")
    for r in results[:4]:
        print_fn(f"  uid={r.uid} prompt_len={r.prompt_len} "
                 f"tokens={r.tokens[:8].tolist()}...")
    return results


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    args = ap.parse_args(argv)
    run_serving(args.arch, smoke=args.smoke, n_requests=args.requests,
                max_new=args.max_new, max_batch=args.max_batch,
                device=device)


if __name__ == "__main__":
    main()
