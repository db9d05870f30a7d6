"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at
its full 700 W power limit)."""

BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12          # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
# special-function results (exp): 16 per clock per SM, 132 SMs, 1.98 GHz
SFU_PER_S = 16 * 132 * 1.98e9
