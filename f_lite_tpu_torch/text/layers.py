"""What the text towers share: the RMS norm, the hidden-state index and
the projection in fp32.

The towers keep their weights in their dtype (bf16 as loaded) and every
activation in fp32: a projection rounds its input to the weight's dtype,
multiplies with fp32 accumulation and returns fp32 (`linear32`); norms,
scores, softmax, activations and the residual stream stay fp32. Rounding
each of them to bf16 as well, as the JAX package does, leaves the hidden
state after 17 T5-XXL blocks (21 Qwen2.5-VL layers) of seeded weights
outside the bf16 bar (largest abs error within 5% of the fp32 result's
rms); bf16 products into fp32 activations stay inside it.
`python -m f_lite_tpu_torch.tools.text_precision` measures both recipes on
the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from f_lite_tpu_torch.ops.norms import rms_norm


def linear32(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """`layer(x)` in fp32: x rounded to the weight's dtype, the product
    accumulated and returned in fp32, the bias added in fp32."""
    w = layer.weight
    x2 = x.reshape(-1, x.shape[-1]).to(w.dtype)
    if w.dtype == torch.float32:
        y = F.linear(x2, w)
    elif x2.is_cuda:
        y = torch.mm(x2, w.t(), out_dtype=torch.float32)
    else:  # the same products: bf16 values are exact in fp32
        y = F.linear(x2.float(), w.float())
    if layer.bias is not None:
        y = y + layer.bias.float()
    return y.view(*x.shape[:-1], w.shape[0])


class RMSNorm(nn.Module):
    """T5LayerNorm / Qwen2RMSNorm: fp32 statistics and output."""

    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x):
        return rms_norm(x.float(), self.weight, eps=self.eps)


def resolve_index(return_index: int, n_states: int) -> int:
    """hidden_states[return_index] as a position in [0, n_states)."""
    if not -n_states <= return_index < n_states:
        raise IndexError(f"return_index {return_index} outside the "
                         f"{n_states} hidden states")
    return return_index % n_states
