"""Hand-written Hopper kernels for the compute hot-spots, each beside its
plain PyTorch version, plus the ONE place that maps the mapper's R-axis
bit-widths onto executable kernel dtypes (``kernel_bits`` /
``dtype_for_bits``).  ``repro_torch.core`` imports this package, never the
reverse.

Three kernels, one per Pallas TPU kernel of the JAX package: the tiled
matmul (``tiled_matmul``), flash attention (``flash_attention``) and the
Mamba-1 selective scan (``mamba_scan``); and two the JAX package leaves to
XLA, the model path's causal attention with its backward
(``attention_train``) and the model path's Mamba-1 selective scan with its
backward (``selective_scan_train``).
"""
import torch

# Widths each kernel's datapath can execute.  Sub-byte mapper widths (the
# R axis offers 2/4-bit) execute at the narrowest supported container — the
# cost model still credits the sub-byte storage/bandwidth, the silicon just
# computes at byte granularity.  Attention and the selective scan keep f32
# state (online softmax / recurrent exp), so their floors are wider.
SUPPORTED_BITS = {
    "matmul": (8, 16, 32),
    "attention": (16, 32),
    "mamba": (32,),
}


def kernel_bits(bits: int, kind: str = "matmul") -> int:
    """Executed operand width for a requested R-axis width: the smallest
    supported width >= ``bits``, saturating at the widest supported."""
    menu = SUPPORTED_BITS[kind]
    for b in menu:
        if bits <= b:
            return b
    return menu[-1]


def dtype_for_bits(bits: int, kind: str = "matmul") -> torch.dtype:
    """The torch dtype a kernel executes a requested R-axis width at
    (8 -> int8 quantized, 16 -> bfloat16, 32 -> float32)."""
    return {8: torch.int8, 16: torch.bfloat16,
            32: torch.float32}[kernel_bits(bits, kind)]


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``astype`` with the JAX package's semantics: a float converted to
    int8 saturates (NaN -> 0, clamp to [-128, 127], truncate toward zero),
    where ``Tensor.to(torch.int8)`` would wrap."""
    if dtype == torch.int8 and t.is_floating_point():
        t = torch.nan_to_num(t.float(), nan=0.0).clamp(-128.0, 127.0)
        return t.trunc().to(torch.int8)
    return t.to(dtype)
