"""CFG-batched flow-matching sampler (counterpart of
`f_lite_tpu/sampling/euler.py`: `_denoise_schedule`, `_interval_segments`,
`denoise`, `schedule_start_time`, `auto_steps_per_dispatch` and the
schedule windows of `make_denoise_fn`).

A plain Python loop over the (t, t_next) schedule: per step one DiT forward
on the CFG pair batched as [neg, pos] with masks [neg_mask, pos_mask] (or
the conditional forward alone outside `guidance_interval`), the CFG or APG
combine, and z += (t - t_next) * v on an fp32 accumulator. Extras:
- `method="ab2"`: variable-step Adams-Bashforth 2, v_eff = v + (h / (2
  h_prev)) (v - v_prev); a step with no history (h_prev == 0) is Euler, and
  the history restarts at every guidance-interval segment;
- `start_step`: the trajectory begins at that schedule row (image to
  image);
- inpainting: after every step the kept region (mask 0) is put back at the
  step's marginal, (1 - t_next) x + t_next eps, with fresh noise eps per
  row; ab2 with a mask is Euler, and a zero-dt row is a full no-op;
- `steps_per_dispatch` and `callback`: the trajectory runs in windows, each
  guidance-interval segment chunked at k steps, as JAX dispatches them. The
  ab2 history is carried from window to window within a segment, so any k
  gives the same latents bit for bit; `callback(done, total)` runs after
  each window and a truthy return stops the loop there.
The schedule's scalars stay on the host in fp32, so the loop never waits
for the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from f_lite_tpu_torch.ops.guidance import APGConfig, guidance_combine
from f_lite_tpu_torch.ops.timesteps import euler_timestep_pairs, resolution_alpha
from f_lite_tpu_torch.utils.trace import span

SAMPLERS = ("euler", "ab2")


@dataclasses.dataclass(frozen=True)
class DenoiseSettings:
    num_inference_steps: int = 30
    guidance_scale: float = 6.0
    apg: APGConfig | None = None
    alpha: float | None = None  # None: derive from latent h*w
    # CFG only while the shifted t is inside [lo, hi]; other steps run the
    # conditional forward alone. None: CFG on every step
    guidance_interval: tuple | None = None
    method: str = "euler"  # one of SAMPLERS

    def __post_init__(self):
        if self.method not in SAMPLERS:
            raise ValueError(f"method must be one of {SAMPLERS}, got {self.method!r}")


def full_schedule(settings: DenoiseSettings, lh: int, lw: int) -> torch.Tensor:
    alpha = settings.alpha
    if alpha is None:
        alpha = resolution_alpha(lh * lw)
    return euler_timestep_pairs(settings.num_inference_steps, alpha)


def schedule_start_time(settings: DenoiseSettings, lh: int, lw: int,
                        start_step: int) -> float:
    """t at schedule row `start_step`, the noise level image-to-image starts
    from; exactly 1.0 for row 0 (the fp32 shift of 1 is not always 1), so
    strength 1.0 is text-to-image."""
    if start_step == 0:
        return 1.0
    return float(full_schedule(settings, lh, lw)[start_step, 0])


def interval_segments(settings: DenoiseSettings, schedule: torch.Tensor) -> list:
    """[(start, end, use_cfg)]: the runs of consecutive schedule rows whose t
    is inside (or outside) `guidance_interval`; one CFG segment when the
    interval is unset or CFG is off."""
    n = schedule.shape[0]
    if settings.guidance_interval is None or settings.guidance_scale < 1.0:
        return [(0, n, True)]
    lo, hi = settings.guidance_interval
    on = [bool(lo <= float(t) <= hi) for t in schedule[:, 0]]
    segs = []
    s = 0
    while s < n:
        e = s + 1
        while e < n and on[e] == on[s]:
            e += 1
        segs.append((s, e, on[s]))
        s = e
    return segs


def denoise_schedule(dit: Callable, latents, prompt_embeds, negative_embeds,
                     context_mask, negative_mask, schedule: torch.Tensor,
                     settings: DenoiseSettings, inpaint=None, carry=None):
    """The loop over an explicit fp32 (N, 2) schedule slice (on the host);
    returns (z fp32, carry).

    `carry` = (v_prev, h_prev), the ab2 history: the last velocity and its
    step (an fp32 host scalar), as the previous slice returned it; None (or
    h_prev == 0) starts without history.

    `inpaint` = (x_lat (B,h,w,C) fp32, mask (B,h,w,1) fp32, noise (N,B,h,w,C)
    fp32): row i puts the kept region back with noise[i].

    Each row run is span `sample.step` (index: the row of this slice)."""
    b = latents.shape[0]
    ab2 = settings.method == "ab2"
    do_cfg = settings.guidance_scale >= 1.0
    if do_cfg:
        context = torch.cat([negative_embeds, prompt_embeds])
        if context_mask is not None:
            nm = negative_mask if negative_mask is not None else context_mask
            context_mask = torch.cat([nm, context_mask])
    else:
        context = prompt_embeds

    def velocity(z, t):
        if do_cfg:
            out = dit(torch.cat([z, z]), context, context_mask,
                      torch.full((2 * b,), float(t), device=z.device))
            return guidance_combine(out[:b], out[b:], settings.guidance_scale,
                                    settings.apg).float()
        return dit(z, context, context_mask,
                   torch.full((b,), float(t), device=z.device)).float()

    zero = torch.zeros((), dtype=torch.float32)
    z = latents.float()
    v_prev, h_prev = carry if carry is not None else (None, zero)
    for i in range(schedule.shape[0]):
        t, t_next = schedule[i, 0], schedule[i, 1]
        if inpaint is not None:
            # the re-imposed noise jumps the state every step: no history
            h_prev = zero
            if not t > t_next:
                continue  # a zero-dt row changes nothing
        with span("sample.step", index=i):
            dt = t - t_next
            v = velocity(z, t)
            if ab2 and h_prev > 0:
                v_eff = v + (dt / (2.0 * h_prev)) * (v - v_prev)
            else:
                v_eff = v
            z_new = z + dt * v_eff
            if inpaint is not None:
                x_lat, mask, noise = inpaint
                known = (1.0 - t_next) * x_lat + t_next * noise[i]
                z_new = mask * z_new + (1.0 - mask) * known
            z, v_prev, h_prev = z_new, v, dt
    return z, (v_prev, h_prev)


def auto_steps_per_dispatch(batch: int, steps: int,
                            latent_tokens: int = 16384) -> int | None:
    """The default window: about a batch-1 1024 px (128 x 128 latents)
    32-step trajectory's work, scaled down by batch and latent tokens;
    None (one window) when the whole trajectory fits. JAX's rule, kept so
    a window ends where a JAX dispatch does (`callback` runs there)."""
    units = batch * max(latent_tokens, 1) / 16384.0
    k = int(32.0 / max(units, 1e-9))
    if k >= steps:
        return None
    return max(1, k)


@torch.no_grad()
def denoise(dit: Callable, latents: torch.Tensor, prompt_embeds: torch.Tensor,
            negative_embeds: torch.Tensor, context_mask: torch.Tensor | None,
            settings: DenoiseSettings,
            negative_mask: torch.Tensor | None = None, *, start_step: int = 0,
            inpaint=None, steps_per_dispatch: int | None = None,
            callback: Callable | None = None) -> torch.Tensor:
    """Run the trajectory from schedule row `start_step`. latents (B, h, w,
    C) NHWC; embeds (B, S, Ctx).

    `dit(x, context, context_mask, t)` is the model forward. `negative_mask`
    defaults to `context_mask`. `inpaint` = (x_lat, mask, noise) as in
    `denoise_schedule`, with one noise row per step run (N - start_step).
    Guidance-interval segments run in turn, the ab2 history restarting at
    each; each segment runs in windows of `steps_per_dispatch` steps (None
    or 0: the whole segment), the history carried across them.
    `callback(e, n)` runs after every window, `e` the window's end in the
    schedule from `start_step` and n = N - start_step; a truthy return
    stops there. Returns the latents reached, in `latents.dtype`."""
    _, lh, lw, _ = latents.shape
    n = settings.num_inference_steps
    if not 0 <= start_step < n:
        raise ValueError(f"start_step {start_step} outside [0, {n})")
    schedule = full_schedule(settings, lh, lw)[start_step:]
    n = schedule.shape[0]
    if inpaint is not None and inpaint[2].shape[0] != n:
        raise ValueError(f"inpaint noise has {inpaint[2].shape[0]} rows for "
                         f"{n} steps")
    nocfg = dataclasses.replace(settings, guidance_scale=0.0, apg=None,
                                guidance_interval=None)
    k = steps_per_dispatch or n
    z = latents
    for s, e, use_cfg in interval_segments(settings, schedule):
        carry = None  # the cfg <-> no-cfg switch changes the field
        for ws in range(s, e, k):
            we = min(ws + k, e)
            window_inpaint = (None if inpaint is None
                              else (*inpaint[:2], inpaint[2][ws:we]))
            z, carry = denoise_schedule(
                dit, z, prompt_embeds, negative_embeds, context_mask,
                negative_mask, schedule[ws:we],
                settings if use_cfg else nocfg, window_inpaint, carry)
            if callback is not None and callback(we, n):
                return z.to(latents.dtype)
    return z.to(latents.dtype)
