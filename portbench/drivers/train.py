"""Training: the port's `train/step.py` `train_step` on one `TrainState`,
step after step, on batches drawn on the device from the seed.

Set-up builds the one state the window trains: the DiT with the mix's
compute dtype over float32 master weights drawn from the seed, blocks
from `remat_from` on recomputed in the backward, and the port's
`build_optimizer` (clipping and AdamW). It then runs the first
`check_steps` steps through the window's own feed and call, which also
warm every shape, and keeps what the check compares: each step's loss,
each leaf's first clipped gradient (read from the optimizer's first
moment) and each leaf's move over those steps (against the weights drawn
again). The window then runs steps until its clock passes `seconds`, each
step's end synchronised.

Step k's batch: `batch` rows of N(0, 1) normalized latents at the mix's
resolution, `text_rows` N(0, embed_std^2) text rows of which the first n
are real (the mix's `text_lengths`, in an order drawn from the seed,
taken in turn), and the loss's draws made by the benchmark with the
port's rule: caption dropout with probability `uncond_prob`, t 90%
sigmoid(N(0, 1)) through the resolution shift and 10% uniform, and N(0, 1)
noise.

With `trace`, CUDA events time the optimizer's step (clip and update) on
every step, and a profiled window covers steps `trace.first` to
`trace.first + trace.steps - 1` of the window (which runs on until it has
them).

After the window the state is freed and the reference follows the same
first steps from the same weights and batches in float32.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from portbench import checks
from portbench.model import dit_fields
from portbench.reference import strict_fp32
from portbench.reference.dit import ReferenceDiT
from portbench.reference.train import AdamW as ReferenceAdamW
from portbench.reference.train import loss as reference_loss
from portbench.trace import Window, counts_since, launch_counts, sync
from portbench.weights import derive, dit_weights, seeded_order


def text_lengths(traffic: dict, seed: int) -> list[int]:
    """The mix's lengths in an order drawn from the seed."""
    return seeded_order(traffic["text_lengths"], seed, "batch")


def resolution_alpha(tokens: int) -> float:
    return 2.0 * math.sqrt(tokens / 4096.0)


def draw_batch(cfg: dict, traffic: dict, seed: int, k: int, lengths: list, device) -> dict:
    """Step k's rows and the loss's draws for them."""
    b, rows = traffic["batch"], traffic["text_rows"]
    side = traffic["resolution"] // traffic["latent_scale"]
    gen = torch.Generator(device).manual_seed(derive(seed, "batch", k))
    latents = torch.randn(b, side, side, cfg["in_channels"], generator=gen, device=device)
    context = traffic["embed_std"] * torch.randn(b, rows, cfg["cross_attn_input_size"],
                                                 generator=gen, device=device)
    n = [lengths[(k * b + j) % len(lengths)] for j in range(b)]
    mask = torch.arange(rows, device=device)[None] < torch.tensor(n, device=device)[:, None]
    drop = torch.rand(b, generator=gen, device=device) < traffic["uncond_prob"]
    z = torch.randn(b, generator=gen, device=device)
    a = resolution_alpha(side * side)
    shifted = torch.sigmoid(z) * a / (1.0 + (a - 1.0) * torch.sigmoid(z))
    uniform_rows = torch.rand(b, generator=gen, device=device) < 0.1
    t = torch.where(uniform_rows, torch.rand(b, generator=gen, device=device), shifted)
    noise = torch.randn(b, side, side, cfg["in_channels"], generator=gen, device=device)
    return {"latents": latents, "context": context, "mask": mask, "drop": drop,
            "t": t, "noise": noise, "lengths": n}


def build_state(cfg: dict, traffic: dict, seed: int, device):
    from f_lite_tpu_torch.models.dit import DiT, DiTConfig
    from f_lite_tpu_torch.train.optim import build_optimizer
    from f_lite_tpu_torch.train.step import TrainState

    dcfg = DiTConfig(**dit_fields(cfg), gradient_checkpoint=True,
                     gradient_checkpoint_from=traffic["remat_from"],
                     remat_policy=traffic["remat_policy"],
                     dtype=getattr(torch, traffic["compute_dtype"]))
    with torch.device("meta"):
        model = DiT(dcfg)
    model.load_state_dict(dit_weights(cfg, seed, device, getattr(torch, traffic["param_dtype"])),
                          strict=True, assign=True)
    model.train()
    opt = build_optimizer(list(model.parameters()), learning_rate=traffic["learning_rate"],
                          lr_scheduler=traffic["lr_scheduler"],
                          max_grad_norm=traffic["max_grad_norm"],
                          weight_decay=traffic["weight_decay"])
    return TrainState(model, opt)


def time_optimizer(opt, timing: dict, events: list) -> None:
    """CUDA events around each call of `opt.step` while timing is on."""
    inner = opt.step

    def timed_step(grads):
        if not timing["on"]:
            return inner(grads)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = inner(grads)
        b.record()
        events.append((a, b))
        return out

    opt.step = timed_step


def run(ctx) -> dict:
    from f_lite_tpu_torch.train.loss import LossDraws
    from f_lite_tpu_torch.train.step import train_step

    cfg, traffic, device = ctx.config, ctx.traffic, ctx.device
    strict_fp32()
    lengths = text_lengths(traffic, ctx.seed)

    def feed(k):
        return draw_batch(cfg, traffic, ctx.seed, k, lengths, device)

    stand_in = (ctx.control or {}).get("reference_dit")
    if stand_in:  # the reference in a lower precision in the program's place
        numbers = compare(reference(ctx, stand_in, feed), reference(ctx, "fp32", feed))
        return {"attempted": 0, "failed": 0, "e2e": {}, "memory_peak_bytes": 0,
                "numbers": numbers}

    state = build_state(cfg, traffic, ctx.seed, device)
    names = [n for n, _ in state.model.named_parameters()]
    opt_ms = []
    timing = {"on": False}

    def step(batch):
        draws = LossDraws(batch["drop"], batch["t"], batch["noise"], None)
        return train_step(state, batch["latents"], batch["context"], batch["mask"],
                          draws=draws, patch_size=cfg["patch_size"])

    if ctx.trace and device.type == "cuda":
        time_optimizer(state.optimizer, timing, opt_ms)

    # the first steps: warm-up, and what the check compares
    n_check = traffic["check_steps"]
    losses, grad_norms = [], {}
    b1 = state.optimizer.b1
    for k in range(1, n_check + 1):
        m = step(feed(k))
        losses.append(float(m["loss"]))
        if k == 1:
            grad_norms = {n: float(mu.float().norm()) / (1.0 - b1)
                          for n, mu in zip(names, state.optimizer.mu)}
    with torch.no_grad():
        start = dit_weights(cfg, ctx.seed, device, getattr(torch, traffic["param_dtype"]))
        params = dict(state.model.named_parameters())
        moves = {n: float((params[n] - start[n]).norm()) for n in names}
        del start, params

    window = Window(device) if ctx.trace else None
    trace_first, trace_steps = traffic["trace"]["first"], traffic["trace"]["steps"]
    rows = []
    sync(device)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    counts0 = launch_counts()
    setup_s = time.time() - ctx.t_start
    t0 = time.perf_counter()
    timing["on"] = True
    while ctx.steps is None or len(rows) < ctx.steps:
        done = len(rows)
        batch = feed(n_check + 1 + done)
        traced = bool(ctx.trace) and trace_first <= done < trace_first + trace_steps
        if traced and done == trace_first:
            window.start("step")
        ts = time.perf_counter()
        step(batch)
        sync(device)
        rows.append({"seconds": time.perf_counter() - ts, "lengths": batch["lengths"],
                     "drop": batch["drop"].tolist(), "profiled": traced})
        if traced and done == trace_first + trace_steps - 1:
            window.stop()
        traced_all = not ctx.trace or len(rows) >= trace_first + trace_steps
        if ctx.steps is None and traced_all and time.perf_counter() - t0 >= ctx.seconds:
            break
    elapsed = time.perf_counter() - t0
    timing["on"] = False
    counts = counts_since(counts0)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    done = len(rows)
    record = {"attempted": done, "failed": 0,
              "e2e": {"train_step_s": elapsed / max(done, 1), "peak_gb": peak / 1e9,
                      "setup_s": setup_s},
              "memory_peak_bytes": peak, "counts": counts, "steps": rows,
              "optimizer_ms": [a.elapsed_time(b) for a, b in opt_ms],
              "model": {"config": cfg, "traffic": traffic}}
    if ctx.trace and window.counts is not None:
        record["profile"] = window.summary()
    del state, window
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    prog = {"losses": losses, "grads": grad_norms, "moves": moves}
    record["numbers"] = compare(prog, reference(ctx, "fp32", feed))
    return record


def reference(ctx, precision: str, feed) -> dict:
    """The first steps of the reference in `precision`: losses, the first
    clipped gradient's norms and the moves, per leaf."""
    cfg, traffic, device = ctx.config, ctx.traffic, ctx.device
    dtype = getattr(torch, traffic["param_dtype"])
    w = {k: v.float() for k, v in dit_weights(cfg, ctx.seed, device, dtype).items()}
    for v in w.values():
        v.requires_grad_(True)
    model = ReferenceDiT(w, cfg, precision, remat=True)
    opt = ReferenceAdamW(w, traffic["learning_rate"], weight_decay=traffic["weight_decay"],
                         max_grad_norm=traffic["max_grad_norm"])
    losses, grads = [], {}
    for k in range(1, traffic["check_steps"] + 1):
        b = feed(k)
        value = reference_loss(model, b["latents"], b["context"], b["mask"], b["drop"],
                               b["t"], b["noise"])
        g = torch.autograd.grad(value, list(w.values()))
        norms = opt.step(dict(zip(w, g)))
        losses.append(float(value.detach()))
        if k == 1:
            grads = norms
        del g
    del model, opt
    with torch.no_grad():
        start = dit_weights(cfg, ctx.seed, device, dtype)
        moves = {n: float((w[n] - start[n].float()).norm()) for n in w}
    del w, start
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "grads": grads, "moves": moves}


def compare(prog: dict, ref: dict) -> dict:
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    grad_gap, _ = checks.leaf_gap(prog["grads"], ref["grads"])
    change_gap, _ = checks.leaf_gap(prog["moves"], ref["moves"],
                                    keep=checks.moved_leaves(ref["grads"]))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}
