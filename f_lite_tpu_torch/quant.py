"""Int8 W8A8 quantization for inference (counterpart of
`f_lite_tpu/quant.py`): int8 weights with per-output-channel fp32 scales,
activations quantized per token at run time, int8 x int8 -> int32 products,
outputs in the activations' dtype.

Only the large projections quantize (`QUANT_TARGETS`: qkv, proj, q,
context_kv, gate/up/down_proj); patch, final, modulation, time-embed and
context projections stay in the model's dtype.

The weight layout is torch's (N, K), one scale per output row. JAX keeps
(K, *out) kernels (head-aligned (K, *split, H, D) for qkv, q, context_kv)
and quantizes per output column; the flattened output columns are the
fused weight's rows, so the scales agree once `convert.from_jax`
reorders the kernel.

Usage:
    quantize_dit(dit)               # in place, after the cast to dtype
or FLitePipeline.from_pretrained(path, quantize=True). On the card the
projections run `csrc/int8_gemm.cu` (the quantize kernel and the int8
product with its dequant epilogue); on the CPU, their plain versions.
"""

from __future__ import annotations

import dataclasses

import torch

from f_lite_tpu_torch.ops.cuda.int8_gemm import (  # noqa: F401 (re-exported)
    int8_gemm_dequant,
    int8_linear_plain,
    quantize_rows,
    quantize_rows_plain,
)

QUANT_TARGETS = frozenset(
    {"qkv", "proj", "q", "context_kv", "gate_proj", "up_proj", "down_proj"}
)


def quantize_weight(w: torch.Tensor):
    """(w8 (N, K) int8, scale (N,) fp32) of a (N, K) weight, computed in
    fp32 from the weight as it is held: symmetric per output row, amax over
    K, scale = amax / 127 (1 where amax is 0), w8 = clip(round(w / scale),
    -127, 127) rounding half to even (`quantize_kernel`)."""
    wf = w.detach().float()
    amax = wf.abs().amax(dim=1, keepdim=True)
    # a tensor divisor: true division on the card too (quantize_rows_plain)
    scale = torch.where(amax == 0, torch.ones_like(amax),
                        amax / torch.full_like(amax, 127.0))
    w8 = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return w8, scale[:, 0]


def quant_matmul(x, w8, scale, bias=None):
    """x (..., K) -> (..., N) in x's dtype: x quantized per token, the int8
    product with w8 (N, K) dequantized by sx and scale (N,), then the bias
    (added in x's dtype). CPU tensors take the plain versions, CUDA tensors
    the kernels."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.device.type == "cuda":
        x2 = x2.contiguous()
    x8, sx = quantize_rows(x2)
    y = int8_gemm_dequant(x8, sx, w8, scale, bias, out_dtype=x.dtype)
    return y.reshape(*lead, w8.shape[0])


def _replace_children(module, fn) -> None:
    """Replace each child `c` named `name` of every module below `module`
    by fn(name, c) where that is not None, one module's children at a time
    (so that a replaced layer is freed before the next is made)."""
    for name, child in list(module.named_children()):
        new = fn(name, child)
        if new is None:
            _replace_children(child, fn)
        else:
            setattr(module, name, new)


@torch.no_grad()
def quantize_dit(dit):
    """Replace the DiT's `QUANT_TARGETS` Dense layers by `QuantDense` in
    place (`quantize_dit_params`): weights quantized from their current
    dtype, biases kept. Each layer's float weight is freed as soon as its
    int8 copy exists. Returns `dit`, its config marked quantized."""
    from f_lite_tpu_torch.models.dit import Dense, QuantDense

    def swap(name, child):
        if name not in QUANT_TARGETS or type(child) is not Dense:
            return None
        w8, scale = quantize_weight(child.weight)
        child.weight = None
        return QuantDense.from_quantized(w8, scale, child.bias)

    _replace_children(dit, swap)
    dit.config = dataclasses.replace(dit.config, quantized=True)
    return dit


@torch.no_grad()
def dequantize_dit(dit, dtype=torch.bfloat16):
    """The inverse (lossy) transform in place (`dequantize_dit_params`):
    each `QuantDense` back to a Dense of weight (w8 * scale) in `dtype`,
    the bias kept as it is. Returns `dit`."""
    from f_lite_tpu_torch.models.dit import Dense, QuantDense

    def swap(_name, child):
        if not isinstance(child, QuantDense):
            return None
        n, k = child.w8.shape
        dense = Dense(k, n, bias=child.bias is not None,
                      device=child.w8.device, dtype=dtype)
        dense.weight.copy_((child.w8.float() * child.scale[:, None]).to(dtype))
        if child.bias is not None:
            dense.bias = child.bias
        return dense

    _replace_children(dit, swap)
    dit.config = dataclasses.replace(dit.config, quantized=False)
    return dit
