"""Text-to-image serving: one client, closed loop, requests back to back
through the port's `FLitePipeline.__call__` (text embeddings in, uint8
images out).

Set-up draws the DiT's weights (in the served dtype) and the VAE
decoder's (fp32) on the device from the seed, loads them into the port's
modules, quantizes the DiT where the mix says so, draws every request's
inputs, and warms the cell's shapes with one call of one denoise step and
one decode. The window then runs requests until its clock passes
`seconds`; the request in flight is finished and counted.

Request i has `text_rows` text rows of which the first n are real, n the
i-th of the mix's `text_lengths` in an order drawn from the seed (every
seed serves the same lengths), N(0, embed_std^2) embeddings and N(0, 1)
start latents in the DiT's dtype, all drawn from the seed and i.

While a request runs, the benchmark's hooks keep the DiT's input state at
the steps the check may read, the decoder's input, and at one step drawn
from the seed a few rows (drawn too) of the input and output of every
large projection in two blocks drawn from the seed. With `trace`, the
hooks also synchronise and time the denoise loop and the decode of every
request, and a profiled window covers the last `trace.steps` steps, the
decode and the return of request 0.

After the window, the program is freed and the reference checks two
finished requests (the one with the longest text, and one drawn from the
seed): the step from the program's own state at two steps of each (the
first, from the benchmark's start latents, and the last, whose next state
is the decoder's input, for the first request; two drawn from the seed
for the other), each kept projection's rows against the reference's
product of the same input rows, and the decode of its final latents
against the returned image (`portbench.checks`).
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from portbench import checks
from portbench.reference import strict_fp32
from portbench.reference.dit import ReferenceDiT
from portbench.reference.sampler import cfg_step, schedule
from portbench.reference.vae import decode, to_uint8
from portbench.trace import Window, counts_since, launch_counts, sync
from portbench.model import dit_fields, spatial_scale, vae_fields
from portbench.weights import (derive, dit_weights, has_cross_attn, seeded_order,
                               vae_decoder_weights)

# requests drawn before the window: one a second of it (more are drawn as
# they are needed)
LEAST_REQUEST_S = 1.0
# rows of each checked projection's input and output kept a request
PROJ_ROWS = 16


def text_lengths(traffic: dict, seed: int) -> list[int]:
    """The mix's lengths in an order drawn from the seed."""
    return seeded_order(traffic["text_lengths"], seed, "request")


def draw_request(cfg: dict, traffic: dict, seed: int, i: int, lengths: list,
                 device) -> dict:
    """Request i's inputs, on the host as a client sends them."""
    s = spatial_scale(cfg["vae"])
    lh, lw = traffic["height"] // s, traffic["width"] // s
    gen = torch.Generator(device).manual_seed(derive(seed, "request", i))
    rows = traffic["text_rows"]
    embeds = traffic["embed_std"] * torch.randn(
        1, rows, cfg["cross_attn_input_size"], generator=gen, device=device)
    latents = torch.randn(1, lh, lw, cfg["in_channels"], generator=gen, device=device,
                          dtype=getattr(torch, traffic["dit_dtype"]))
    n = lengths[i % len(lengths)]
    return {"embeds": embeds.cpu().numpy(), "mask": (np.arange(rows) < n)[None],
            "latents": latents.cpu(), "text_len": n}


def checked_projections(cfg: dict, seed: int) -> list[str]:
    """The large projections (`weights.QUANT_TARGETS`) of a cross-attention
    block and of one other block, both drawn from the seed."""
    gen = torch.Generator().manual_seed(derive(seed, "check", 2))
    cross = [i for i in range(cfg["depth"]) if has_cross_attn(cfg, i)]
    first = cross[int(torch.randint(len(cross), (1,), generator=gen))]
    rest = [i for i in range(cfg["depth"]) if i != first]
    second = rest[int(torch.randint(len(rest), (1,), generator=gen))]
    names = []
    for i in (first, second):
        parts = ["self_attn.qkv", "self_attn.proj", "mlp.gate_proj", "mlp.up_proj",
                 "mlp.down_proj"]
        if has_cross_attn(cfg, i):
            parts += ["cross_attn.q", "cross_attn.context_kv", "cross_attn.proj"]
        names += [f"blocks.{i}.{part}" for part in parts]
    return names


def build_pipeline(cfg: dict, traffic: dict, seed: int, device, quantize: bool):
    from f_lite_tpu_torch.models.dit import DiT, DiTConfig
    from f_lite_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from f_lite_tpu_torch.pipeline import FLitePipeline
    from f_lite_tpu_torch.quant import quantize_dit

    dtype = getattr(torch, traffic["dit_dtype"])
    with torch.device("meta"):
        dit = DiT(DiTConfig(**dit_fields(cfg)))
        vae = AutoencoderKL(VAEConfig(**vae_fields(cfg["vae"])))
    dit.load_state_dict(dit_weights(cfg, seed, device, dtype), strict=True, assign=True)
    dit.eval()
    if quantize:
        quantize_dit(dit)
    # text to image never encodes: the encoder stays without weights
    vae.decoder.load_state_dict(vae_decoder_weights(cfg["vae"], seed, device),
                                strict=True, assign=True)
    vae.eval()
    return FLitePipeline(dit, vae)


def run(ctx) -> dict:
    cfg, traffic, device = ctx.config, ctx.traffic, ctx.device
    control = ctx.control or {}
    steps, guidance = traffic["steps"], traffic["guidance_scale"]
    strict_fp32()
    if control.get("tf32"):
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    quantize = bool(control.get("quantize", traffic["quantize"]))
    pipe = build_pipeline(cfg, traffic, ctx.seed, device, quantize)
    lengths = text_lengths(traffic, ctx.seed)
    budget = ctx.requests or math.ceil(ctx.seconds / LEAST_REQUEST_S) + 2
    reqs = [draw_request(cfg, traffic, ctx.seed, i, lengths, device) for i in range(budget)]

    def call(req, n_steps=steps):
        return pipe(prompt_embeds=req["embeds"], context_mask=req["mask"],
                    height=traffic["height"], width=traffic["width"],
                    num_inference_steps=n_steps, guidance_scale=guidance,
                    latents=req["latents"], output_type="uint8").images

    call(reqs[0], n_steps=1)  # one denoise step and one decode: the cell's shapes

    # the steps the check may read: the first and the last (whose next
    # state is the decoder's input), and two drawn from the seed
    gen = torch.Generator().manual_seed(derive(ctx.seed, "check"))
    check_steps = [0, steps - 1] + (1 + torch.randperm(steps - 2, generator=gen)[:2]).tolist()
    keep = sorted({s + d for s in check_steps for d in (0, 1)} - {steps})
    proj_step = check_steps[2] if steps > 2 else 0
    rows_gen = torch.Generator().manual_seed(derive(ctx.seed, "check", 3))
    rows_of = {}  # input rows -> the rows kept, drawn from the seed

    def kept_rows(n):
        if n not in rows_of:
            rows_of[n] = torch.randperm(n, generator=rows_gen)[:PROJ_ROWS].to(device)
        return rows_of[n]

    state = {"step": 0, "states": {}, "final": None, "proj": {}}
    marks = {}
    window = Window(device) if ctx.trace else None
    profiled = {"request": 0 if ctx.trace else -1, "current": -1}
    trace_from = steps - traffic["trace"]["steps"]

    def dit_pre(_m, args):
        s = state["step"]
        if s in keep:
            state["states"][s] = args[0][: args[0].shape[0] // 2].float().clone()
        if ctx.trace:
            if s == 0:
                sync(device)
                marks["dit0"] = time.perf_counter()
            if s == trace_from and profiled["current"] == profiled["request"]:
                window.start("denoise")
        state["step"] = s + 1

    def dec_pre(_m, args):
        state["final"] = args[0].permute(0, 2, 3, 1).clone()
        if ctx.trace:
            sync(device)
            marks["dec0"] = time.perf_counter()
            if profiled["current"] == profiled["request"]:
                window.phase("decode")

    def dec_post(_m, _args, _out):
        if ctx.trace:
            sync(device)
            marks["dec1"] = time.perf_counter()
            if profiled["current"] == profiled["request"]:
                window.phase("return")

    def proj_post(name):
        def hook(_m, args, out):
            if state["step"] - 1 == proj_step:  # dit_pre has counted this step
                x = args[0].reshape(-1, args[0].shape[-1])
                rows = kept_rows(x.shape[0])
                state["proj"][name] = (x.index_select(0, rows),
                                       out.reshape(-1, out.shape[-1]).index_select(0, rows))
        return hook

    modules = dict(pipe.dit.named_modules())
    hooks = [pipe.dit.register_forward_pre_hook(dit_pre),
             pipe.vae.decoder.register_forward_pre_hook(dec_pre),
             pipe.vae.decoder.register_forward_hook(dec_post)]
    hooks += [modules[n].register_forward_hook(proj_post(n))
              for n in checked_projections(cfg, ctx.seed)]
    # the rows' draws for the CFG pair's image tokens and text rows
    cells = (spatial_scale(cfg["vae"]) * cfg["patch_size"]) ** 2
    grid = traffic["height"] * traffic["width"] // cells
    kept_rows(2 * (grid + cfg["n_register_tokens"]))
    kept_rows(2 * traffic["text_rows"])

    done, spans = [], []
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    counts0 = launch_counts()
    setup_s = time.time() - ctx.t_start
    t0 = time.perf_counter()
    while True:
        i = len(done)
        req = reqs[i] if i < len(reqs) else draw_request(cfg, traffic, ctx.seed, i,
                                                         lengths, device)
        state.update(step=0, states={}, final=None, proj={})
        profiled["current"] = i
        t_call = time.perf_counter()
        image = call(req)
        t_end = time.perf_counter()
        if ctx.trace and i == profiled["request"]:
            window.stop()
        done.append({"image": image, "states": state["states"], "final": state["final"],
                     "proj": state["proj"], "text_len": req["text_len"], "i": i})
        if ctx.trace:
            spans.append({"total_s": t_end - t_call, "prep_s": marks["dit0"] - t_call,
                          "denoise_s": marks["dec0"] - marks["dit0"],
                          "decode_s": marks["dec1"] - marks["dec0"],
                          "return_s": t_end - marks["dec1"], "text_len": req["text_len"],
                          "profiled": i == profiled["request"]})
        if ctx.requests:
            if len(done) >= ctx.requests:
                break
        elif time.perf_counter() - t0 >= ctx.seconds:
            break
    elapsed = time.perf_counter() - t0
    counts = counts_since(counts0)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    for h in hooks:
        h.remove()
    record = {"attempted": len(done), "failed": 0,
              "e2e": {"image_s": elapsed / len(done), "peak_gb": peak / 1e9,
                      "setup_s": setup_s},
              "memory_peak_bytes": peak, "counts": counts, "spans": spans,
              "model": {"config": cfg, "traffic": traffic, "quantized": quantize}}
    if ctx.trace:
        record["profile"] = window.summary()
    del pipe, hooks, window
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    record["numbers"] = check(ctx, done, reqs, check_steps, control)
    return record


def check(ctx, done, reqs, check_steps, control) -> dict:
    """The numbers of `portbench.checks` over two finished requests."""
    cfg, traffic, device = ctx.config, ctx.traffic, ctx.device
    gen = torch.Generator().manual_seed(derive(ctx.seed, "check", 1))
    longest = max(done, key=lambda d: (d["text_len"], -d["i"]))
    others = [d for d in done if d is not longest]
    chosen = [(longest, check_steps[:2])]
    if others:
        other = others[int(torch.randint(len(others), (1,), generator=gen))]
        chosen.append((other, check_steps[2:]))
    dtype = getattr(torch, traffic["dit_dtype"])
    w = {k: v.float() for k, v in dit_weights(cfg, ctx.seed, device, dtype).items()}
    precision = "int8" if traffic["quantize"] else "fp32"
    model = ReferenceDiT(w, cfg, precision)
    stand_in = (ReferenceDiT(w, cfg, control["reference_dit"])
                if control.get("reference_dit") else None)
    s = spatial_scale(cfg["vae"])
    sched = schedule(traffic["steps"], traffic["height"] // s, traffic["width"] // s)
    guidance = traffic["guidance_scale"]
    step_err = 0.0
    with torch.no_grad():
        for d, step_list in chosen:
            req = (reqs[d["i"]] if d["i"] < len(reqs) else draw_request(
                cfg, traffic, ctx.seed, d["i"], text_lengths(traffic, ctx.seed), device))
            context = torch.from_numpy(req["embeds"]).to(device)
            mask = torch.from_numpy(req["mask"]).to(device)
            for st in step_list:
                z = (req["latents"].to(device).float() if st == 0
                     else d["states"].get(st))
                nxt = d["states"].get(st + 1) if st + 1 < len(sched) else d["final"]
                if z is None or nxt is None:  # the program never reached it
                    step_err = math.inf
                    continue
                if st + 1 == len(sched):  # the decoder's input, normalized again
                    nxt = (nxt.float() - cfg["vae"]["shift_factor"]) * cfg["vae"]["scaling_factor"]
                z = z.to(device)
                t, t_next = sched[st]
                want = cfg_step(model, z, context, mask, t, t_next, guidance)
                got = (cfg_step(stand_in, z, context, mask, t, t_next, guidance)
                       if stand_in is not None else nxt.to(device))
                step_err = max(step_err, checks.rel_l2(got, want, want - z))
        proj_err = 0.0
        for d, _ in chosen:
            if not d["proj"]:  # the program never reached the step
                proj_err = math.inf
            for name, (x, y) in d["proj"].items():
                x = x.to(device).float()
                want = model.linear(name, x, True)
                got = stand_in.linear(name, x, True) if stand_in is not None else y
                proj_err = max(proj_err, checks.rel_l2(got, want, want))
        del model, stand_in, w
        gc.collect()
        wv = vae_decoder_weights(cfg["vae"], ctx.seed, device)
        pixel_mad = 0.0
        for d, _ in chosen:
            if d["final"] is None:
                pixel_mad = math.inf
                continue
            ref = to_uint8(decode(wv, cfg["vae"], d["final"].to(device))).cpu()
            got = torch.from_numpy(d["image"])
            pixel_mad = max(pixel_mad, float((got.int() - ref.int()).abs().float().mean()))
    return {"step_err": step_err, "proj_err": proj_err, "pixel_mad": pixel_mad}
