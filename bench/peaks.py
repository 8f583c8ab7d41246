"""Published peaks of one NVIDIA H100 SXM5 (the data sheet's dense
rates at the full 700 W; the same figures as the program's own roofline
table).  A run prints the card's power limit beside them."""

CARD = "NVIDIA H100 80GB HBM3"
BF16_FLOPS = 989.4e12          # tensor cores, dense
FP32_FLOPS = 67e12             # CUDA cores, no tensor cores
HBM_BYTES_S = 3.35e12
