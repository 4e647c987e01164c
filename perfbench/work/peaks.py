"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no
sparsity, at the full 700 W power limit)."""

BF16_FLOPS = 989e12        # bf16 / fp16 tensor-core FLOP/s
HBM_BYTES = 3.35e12        # HBM3 bytes/s


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over the memory peak."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES)
