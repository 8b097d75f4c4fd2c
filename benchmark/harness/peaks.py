"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the full 700 W power limit).  A card set to a lower limit runs
below them; the run reports the card's name and limit beside every
share."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12          # outside the tensor cores
HBM_BYTES = 80e9
