"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates), the yardstick of every roofline share. They assume the card's full
700 W power limit; the result line carries the card's own limit."""

#: HBM3 bytes per second
HBM_BYTES_PER_S = 3.35e12
#: float32 operations per second outside the tensor cores, an FMA counted
#: as two
FP32_OPS_PER_S = 67e12
