"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), frozen for the benchmark."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {'bf16': 989e12, 'fp16': 989e12, 'tf32': 495e12, 'f32': 67e12,
         'fp8': 1979e12}


def bound_s(ops: float, nbytes: float, precision: str) -> float:
    """The least time the chip needs: max(bytes / bandwidth, operations /
    peak at ``precision``)."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FLOPS[precision])
