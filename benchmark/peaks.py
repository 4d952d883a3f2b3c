"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet: dense rates
without sparsity, at the 700 W power limit), and the least time a piece of
work can take on it."""

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {"bf16": 989e12, "fp32": 67e12, "tf32": 495e12, "fp8": 1979e12, "int8": 1979e12}
BYTES = {"bf16": 2, "fp32": 4, "fp8": 1, "int8": 1}


def bound_s(ops: float, moved_bytes: float, dtype: str) -> float:
    """The larger of the operations over the peak for their type and the
    bytes over the HBM rate."""
    return max(ops / OPS_PER_S[dtype], moved_bytes / HBM_BYTES_PER_S)
