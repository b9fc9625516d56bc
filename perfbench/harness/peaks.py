"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit): what every roofline share and ``mfu`` is
taken against."""
BF16_FLOPS = 989e12  # tensor cores, bf16 in, float32 accumulate
HBM_BYTES_PER_S = 3.35e12  # 80 GB of HBM3
