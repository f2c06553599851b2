"""Twins of the reference's ``examples/``: each runs as
``python -m repro_torch.examples.<name>`` on the CUDA card, and through
``main(argv, device="cpu")`` on the CPU."""
