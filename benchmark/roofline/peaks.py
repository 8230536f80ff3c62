"""Peaks of one NVIDIA H100 SXM (80 GB HBM3), each with its source."""

# NVIDIA H100 Tensor Core GPU data sheet, SXM: memory bandwidth 3.35 TB/s
HBM_BYTES_PER_S = 3.35e12
# the same data sheet: FP64 Tensor Core 67 TFLOPS
FP64_FLOP_PER_S = 67e12
# mma.sync m16n8k256 .b1 AND-POPC, 2 M N K operations a product: no figure
# is published; chip_diag.py --rates measured 10.08 P a second on an NVIDIA
# H100 80GB HBM3 at its 700 W power limit, 5.1x the data sheet's int8 peak
B1_OPS_PER_S = 10.08e15
