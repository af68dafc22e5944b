"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no
sparsity), at its full 700 W power limit: the runs print the card's limit
beside every number."""

BF16_FLOPS = 989e12          # tensor cores, bf16 in, f32 accumulate
HBM_BYTES_PER_S = 3.35e12    # HBM3
