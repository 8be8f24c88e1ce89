"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at its 700 W limit) and the least time a piece of work can take on it:
the larger of its bytes over the memory rate and its operations over
their unit's rate (float32 and float64 run side by side)."""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12


def bound_s(nbytes, fp32_ops=0, fp64_ops=0):
    return max(nbytes / HBM_BYTES_PER_S, fp32_ops / FP32_OPS_PER_S,
               fp64_ops / FP64_OPS_PER_S)
