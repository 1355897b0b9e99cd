"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W power limit), frozen here so that no change to the program can
move the yardstick.  Every result line records the card's power limit
beside any share of these peaks."""

#: float32 on the CUDA cores (not the tensor cores), operations per second
PEAK_FP32_FLOPS = 67e12
#: HBM3 bandwidth, bytes per second
PEAK_HBM_BYTES_S = 3.35e12


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the work can take: the larger of its operations over
    the float32 peak and its bytes over the HBM bandwidth."""
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES_S)
