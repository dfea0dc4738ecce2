"""Learning-rate schedules, global-norm clipping and AdamW with optax's
arithmetic (counterpart of `f_lite_tpu/train/optim.py`, which chains
`optax.clip_by_global_norm` and `optax.adamw`).

What differs from PyTorch's defaults, and is matched here:
- warmup is `linear_schedule(0, lr, warmup)`: lr 0 at count 0, so the
  first update is a no-op; schedules are evaluated in float32 with optax's
  formulas at the optimizer's own update count (0 for the first update);
- clipping scales by max_norm / norm only when norm >= max_norm, with no
  epsilon (`clip_grad_norm_` adds 1e-6);
- AdamW: b1 0.9, b2 0.95, eps 1e-8 outside the square root, bias
  correction by 1 - b**count, then the decoupled decay lr * wd * p added to
  the update before the learning rate scales it;
- `mu_dtype=torch.bfloat16` (`--use_8bit_adam`) stores only mu in bf16:
  nu stays in the parameter dtype; the stored mu is scaled in bf16 by b1 rounded
  to bf16 (0.8984375), and the step computes with the new fp32 mu before
  rounding it (optax's `mu_dtype`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_F32 = np.float32


def _linear(init: float, end: float, steps: int):
    """`optax.linear_schedule(init, end, steps)`."""
    def schedule(count: int):
        c = _F32(min(max(count, 0), steps))
        frac = _F32(1) - c / _F32(steps)
        return _F32(init - end) * frac + _F32(end)
    return schedule


def _cosine(init: float, decay_steps: int):
    """`optax.cosine_decay_schedule(init, decay_steps)`."""
    def schedule(count: int):
        c = _F32(min(count, decay_steps))
        decay = _F32(0.5) * (_F32(1) + np.cos(_F32(math.pi) * c / _F32(decay_steps)))
        return _F32(init) * decay
    return schedule


def _constant(value: float):
    return lambda count: _F32(value)


def _join(schedules, boundaries):
    """`optax.join_schedules`: each schedule counts from its boundary."""
    def schedule(step: int):
        out = schedules[0](step)
        for boundary, fn in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = fn(step - boundary)
        return out
    return schedule


def build_lr_schedule(name: str, learning_rate: float, *,
                      num_warmup_steps: int = 0, max_steps: int = 10_000):
    """step -> lr (a float32 value as a Python float): linear warmup from 0
    over `num_warmup_steps`, then linear / cosine decay to 0 at
    `max_steps`, wsd (constant, then linear to 0 over the last 10%), or
    constant."""
    warmup = _linear(0.0, learning_rate, max(num_warmup_steps, 1))
    rest = max(max_steps - num_warmup_steps, 1)
    if name == "linear":
        decay = _linear(learning_rate, 0.0, rest)
    elif name == "cosine":
        decay = _cosine(learning_rate, rest)
    elif name == "wsd":
        decay_steps = max_steps // 10
        stable_steps = max(max_steps - num_warmup_steps - decay_steps, 0)
        decay = _join([_constant(learning_rate),
                       _linear(learning_rate, 0.0, max(decay_steps, 1))],
                      [stable_steps])
    elif name == "constant":
        decay = _constant(learning_rate)
    else:
        raise ValueError(f"unknown lr schedule: {name}")
    joined = _join([warmup, decay], [num_warmup_steps])
    return lambda step: float(joined(int(step)))


@torch.no_grad()
def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, fp32 (`optax.global_norm`)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class AdamW:
    """`optax.chain(clip_by_global_norm(max_grad_norm), adamw(schedule, b1,
    b2, eps, weight_decay, mu_dtype))` over a list of parameters, updated in
    place. The update runs tensor by tensor, so its temporaries stay the
    size of one parameter."""

    def __init__(self, params, schedule, *, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.01,
                 max_grad_norm: float | None = 1.0,
                 mu_dtype: torch.dtype | None = None):
        self.params = list(params)
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype)
                   for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0  # updates applied so far

    @torch.no_grad()
    def step(self, grads) -> torch.Tensor:
        """Clip `grads` (one per parameter) and apply one AdamW update.
        Returns the global gradient norm before clipping (a device
        scalar; nothing here waits for the device)."""
        grads = list(grads)
        norm = global_norm(grads)
        if self.max_grad_norm is not None:
            factor = torch.where(norm < self.max_grad_norm,
                                 torch.ones_like(norm),
                                 self.max_grad_norm / norm)
            grads = torch._foreach_mul(grads, factor)
        lr = self.schedule(self.count)
        self.count += 1
        b1, b2 = self.b1, self.b2
        bc1 = float(_F32(1) - _F32(b1) ** _F32(self.count))
        bc2 = float(_F32(1) - _F32(b2) ** _F32(self.count))
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            if mu.dtype == g.dtype:
                mu.mul_(b1).add_(g, alpha=1 - b1)
                mu_new = mu
            else:
                # low-precision mu: optax multiplies it by b1 rounded to
                # mu's dtype, in mu's dtype, then adds in fp32
                b1_low = float(torch.tensor(b1, dtype=mu.dtype))
                mu_new = (1 - b1) * g + (b1_low * mu).to(g.dtype)
            nu.mul_(b2).addcmul_(g, g, value=1 - b2)
            update = (mu_new / bc1).div_((nu / bc2).sqrt_().add_(self.eps))
            update.add_(p, alpha=self.weight_decay)
            p.add_(update, alpha=-lr)
            if mu_new is not mu:
                mu.copy_(mu_new)
        return norm


def build_optimizer(params, *, learning_rate: float = 1e-4,
                    lr_scheduler: str = "linear", num_warmup_steps: int = 0,
                    max_steps: int = 10_000, weight_decay: float = 0.01,
                    max_grad_norm: float | None = 1.0,
                    moment_dtype=None) -> AdamW:
    """Clipping + AdamW over `params` with the named schedule;
    `moment_dtype="bfloat16"` keeps mu in bf16 (`--use_8bit_adam`)."""
    schedule = build_lr_schedule(lr_scheduler, learning_rate,
                                 num_warmup_steps=num_warmup_steps,
                                 max_steps=max_steps)
    if isinstance(moment_dtype, str):
        moment_dtype = getattr(torch, moment_dtype)
    return AdamW(params, schedule, weight_decay=weight_decay,
                 max_grad_norm=max_grad_norm, mu_dtype=moment_dtype)
