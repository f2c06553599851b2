"""PyTorch port of the ``repro`` package for an NVIDIA H100.

Module for module it mirrors ``src/repro`` (``repro_torch.core.cost_model``
is the counterpart of ``repro.core.cost_model``), imports torch, numpy and
the standard library only, and never the JAX package.  Entry points take a
``device``: ``None`` means the CUDA card, and without one they raise unless
the caller asks for ``"cpu"``.
"""
