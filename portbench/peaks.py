"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, no sparsity, at the full 700 W power limit).  A card set below
700 W (the result line's `power_limit_w`) reaches less."""

BF16_FLOPS_PER_S = 989e12     # tensor cores, bf16 / fp16
INT8_OPS_PER_S = 1979e12      # tensor cores, int8 (two operations a multiply-add)
F32_FLOPS_PER_S = 67e12       # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12     # HBM3
L2_BYTES = 50e6               # a working set under this may beat the HBM rate
