"""Published peaks of one NVIDIA H100 80GB HBM3 (SXM), NVIDIA's data sheet,
dense rates without sparsity, at the card's 700 W power limit.  A frozen
copy of the figures the program's roofline tool uses, kept here so that no
change to the program moves the yardstick."""

PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 tensor cores
PEAK_OPS_INT8 = 1979e12         # OP/s, int8 tensor cores
HBM_BYTES_PER_S = 3.35e12       # bytes/s
HARDWARE = "NVIDIA H100 80GB HBM3 (SXM), data-sheet peaks at 700 W"
