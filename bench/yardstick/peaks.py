"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).  A card set below 700 W runs
slower under load; the benchmark states its shares against these figures
and prints the card's limit beside them."""

HBM_BYTES_S = 3.35e12
BF16_FLOPS_S = 989e12        # dense tensor-core bf16 / fp16
