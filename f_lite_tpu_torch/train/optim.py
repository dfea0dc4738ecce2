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

`Accumulate(opt, k)` is `optax.MultiSteps(opt, k)`: a running mean of k
micro-batch gradients, applied by `opt` on every k-th call. Both keep
their state in `state_dict()` / `load_state_dict()` (counts as ints,
moments and the accumulator as tensors), which the checkpoint writes.

Under FSDP2 the parameters and gradients are DTensor shards: the moments
and the accumulator are shards beside them (`zeros_like`), every update
runs on the local shards, `global_norm` is the norm of the whole
gradient, `state_dict()` hands out the DTensors (the checkpoint gathers
them) and `load_state_dict` takes whole tensors and keeps this rank's
shard. Each micro-batch's gradients are reduced by FSDP2 as they come.
Under pipeline parallelism each stage's optimizer holds its stage's
parameters, and the norm also sums over the stages (`norm_group`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from f_lite_tpu_torch.parallel.sharding import copy_full_, local
from f_lite_tpu_torch.utils.trace import span

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


def _shard_dims(t) -> tuple:
    """The mesh dims of more than one rank that split DTensor `t` (a shard
    placement); () for a plain tensor, or one replicated everywhere."""
    if not isinstance(t, DTensor):
        return ()
    return tuple(d for d, p in enumerate(t.placements)
                 if p.is_shard() and t.device_mesh.size(d) > 1)


@torch.no_grad()
def global_norm(tensors, group=None) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, fp32 (`optax.global_norm`).
    DTensor shards give the norm of the whole tensors: each tensor's local
    sum of squares is summed over the groups that split it and never over
    one that replicates it, so the placements may differ from tensor to
    tensor (FSDP2 + TP: column-, row-parallel and tp-replicated
    parameters). Tensors that share their split dims are summed together
    first, in the order they come (every rank must call this). `group`:
    ranks of more than one that hold other tensors (a pipeline's stages),
    over which the sum of squares is summed too."""
    tensors = list(tensors)
    norms = torch._foreach_norm([local(t).float() for t in tensors])
    layouts: dict = {}
    for t, n in zip(tensors, norms):
        key = (t.device_mesh, _shard_dims(t)) if _shard_dims(t) else None
        layouts.setdefault(key, []).append(n)
    if group is not None and dist.get_world_size(group) == 1:
        group = None
    if list(layouts) == [None] and group is None:  # the one-rank arithmetic
        return torch.linalg.vector_norm(torch.stack(norms))
    total = None
    for key, group_norms in layouts.items():
        squares = torch.linalg.vector_norm(torch.stack(group_norms)).square()
        if key is not None:
            mesh, dims = key
            for d in dims:
                dist.all_reduce(squares, group=mesh.get_group(d))
        total = squares if total is None else total + squares
    if group is not None:
        dist.all_reduce(total, group=group)
    return total.sqrt()


class AdamW:
    """`optax.chain(clip_by_global_norm(max_grad_norm), adamw(schedule, b1,
    b2, eps, weight_decay, mu_dtype))` over a list of parameters, updated in
    place. The update runs tensor by tensor, so its temporaries stay the
    size of one parameter."""

    def __init__(self, params, schedule, *, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.01,
                 max_grad_norm: float | None = 1.0,
                 mu_dtype: torch.dtype | None = None, norm_group=None):
        self.params = list(params)
        self.norm_group = norm_group
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
        scalar; nothing here waits for the device). Spans `optim.norm`,
        `optim.clip` and `optim.update`."""
        grads = list(grads)
        with span("optim.norm"):
            norm = global_norm(grads, self.norm_group)
        grads = [local(g) for g in grads]
        if self.max_grad_norm is not None:
            with span("optim.clip"):
                factor = torch.where(norm < self.max_grad_norm,
                                     torch.ones_like(norm),
                                     self.max_grad_norm / norm)
                grads = torch._foreach_mul(grads, factor)
        with span("optim.update"):
            lr = self.schedule(self.count)
            self.count += 1
            b1, b2 = self.b1, self.b2
            bc1 = float(_F32(1) - _F32(b1) ** _F32(self.count))
            bc2 = float(_F32(1) - _F32(b2) ** _F32(self.count))
            for p, g, mu, nu in zip(map(local, self.params), grads,
                                    map(local, self.mu), map(local, self.nu)):
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

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: dict) -> None:
        """`state` as `state_dict` gives it, the moments whole (in the
        reference layout of the parameters named by `state["names"]`,
        where given)."""
        self.count = int(state["count"])
        names = state.get("names") or [""] * len(self.params)
        for dst, key in ((self.mu, "mu"), (self.nu, "nu")):
            for t, v, name in zip(dst, state[key], names, strict=True):
                copy_full_(t, v, name)


class Accumulate:
    """`optax.MultiSteps(opt, k)` over `opt`'s parameters: each call folds
    its gradients into a running mean (Welford's update, acc + (g - acc) /
    (n + 1), in the gradients' dtype); the k-th call hands the mean to
    `opt` (clip + AdamW, whose count and schedule advance once per update)
    and resets it. The other calls leave the parameters untouched. Each
    call returns the global norm of its own gradients, the JAX trainer's
    `grad_norm`."""

    def __init__(self, opt: AdamW, k: int):
        self.opt = opt
        self.k = k
        self.params = opt.params
        self.norm_group = opt.norm_group
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.mini_step = 0

    @property
    def count(self) -> int:
        return self.opt.count

    @torch.no_grad()
    def step(self, grads) -> torch.Tensor:
        """Spans `optim.norm` and `optim.accumulate`; `opt`'s on the k-th call."""
        grads = list(grads)
        with span("optim.norm"):
            norm = global_norm(grads, self.norm_group)
        n = self.mini_step
        with span("optim.accumulate"):
            for acc, g in zip(map(local, self.acc), map(local, grads)):
                acc.add_((g - acc) / (n + 1))
        self.mini_step = (n + 1) % self.k
        if self.mini_step == 0:
            self.opt.step(self.acc)
            for acc in self.acc:
                acc.zero_()
        return norm

    def state_dict(self) -> dict:
        return {**self.opt.state_dict(), "mini_step": self.mini_step,
                "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state)
        self.mini_step = int(state["mini_step"])
        names = state.get("names") or [""] * len(self.params)
        for t, v, name in zip(self.acc, state["acc"], names, strict=True):
            copy_full_(t, v, name)


def build_optimizer(params, *, learning_rate: float = 1e-4,
                    lr_scheduler: str = "linear", num_warmup_steps: int = 0,
                    max_steps: int = 10_000, weight_decay: float = 0.01,
                    max_grad_norm: float | None = 1.0,
                    moment_dtype=None, accumulation_steps: int = 1,
                    norm_group=None):
    """Clipping + AdamW over `params` with the named schedule;
    `moment_dtype="bfloat16"` keeps mu in bf16 (`--use_8bit_adam`);
    `accumulation_steps` > 1 wraps it in `Accumulate`; `norm_group`: the
    pipeline's stages, whose other parameters the norm also counts."""
    schedule = build_lr_schedule(lr_scheduler, learning_rate,
                                 num_warmup_steps=num_warmup_steps,
                                 max_steps=max_steps)
    if isinstance(moment_dtype, str):
        moment_dtype = getattr(torch, moment_dtype)
    opt = AdamW(params, schedule, weight_decay=weight_decay,
                max_grad_norm=max_grad_norm, mu_dtype=moment_dtype,
                norm_group=norm_group)
    return Accumulate(opt, accumulation_steps) if accumulation_steps > 1 else opt
