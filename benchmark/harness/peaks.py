"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates) and the integer issue width of its SMs (the Hopper architecture's
count). A roofline share is stated against these, with the card's power
limit beside it; the SM clock is read from the card (nvidia-smi's maximum
SM clock) at run time."""

HBM_BYTES_PER_S = 3.35e12
SMS = 132
INT32_LANES_PER_SM = 64       # INT32 operations an SM issues per clock
LANES_PER_INT32 = 2           # 16-bit values packed two to a 32-bit lane (16x2 SIMD)
