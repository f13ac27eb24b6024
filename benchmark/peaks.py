"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense rates, at
its full power limit of 700 W.

Pass 1 is held to the fastest rate that keeps float32-class accuracy:
three bf16 products per float32 product (bf16x3), so 989 / 3 TFLOP/s,
whichever route (CUDA-core FMA or 3xTF32 tensor cores) an implementation
takes. No implementation in float32's error class can read over 100 %.
"""
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_CLASS_FLOPS = BF16_FLOPS / 3
