"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit) and the least time a piece of work can take on
them."""

PEAK_F32_FLOPS = 67e12        # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12      # HBM3 bytes a second


def least_ms(n_bytes: float, n_ops: float) -> float:
    """The larger of bytes over peak bandwidth and operations over peak
    float32 rate, in ms."""
    return max(n_bytes / PEAK_HBM_BYTES, n_ops / PEAK_F32_FLOPS) * 1e3
