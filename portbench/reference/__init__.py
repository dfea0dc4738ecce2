"""The plain reference of what the benchmark's cells run: float32 torch
with TF32 off, written from the published description of F-Lite (v1
shared AdaLN, residual_v, 2-D RoPE, register tokens), the Flux VAE
decoder, the CFG Euler sampler over the resolution-shifted schedule, W8A8
as `quant.py` defines it, the flow-matching loss and optax's AdamW.

It imports nothing of the measured program and takes no tensor the
program made: weights come from `portbench.weights`, inputs from the
drivers' own draws.
"""

import torch


def strict_fp32() -> None:
    """Float32 products stay float32 (no TF32) in cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
