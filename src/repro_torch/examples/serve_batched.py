"""Serve a small model with batched requests: wave-scheduled prefill +
lockstep decode with per-slot early stop (see repro_torch/serve/engine.py).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_batched
(on the CUDA card; ``main(device="cpu")`` runs it on the CPU)
"""
from ..launch.serve import run_serving


def main(argv=None, device=None):
    return run_serving("gemma-2b", smoke=True, n_requests=12, max_new=24,
                       max_batch=4, device=device)


if __name__ == "__main__":
    main()
