#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`f_lite_tpu_torch`) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failed check raises and the run exits non-zero):
1. the card's name and power limit; TF32 off, so fp32 means fp32;
2. build the CUDA kernels (`f_lite_tpu_torch/csrc/*.cu`, one nvcc each, in
   parallel) and print ptxas' register, spill and warning lines and each
   source's nvcc seconds;
3. the forward kernel (bf16: TMA + wgmma, warp-specialised) against its
   plain PyTorch version on the card, at the shapes the serving and
   training paths give it (7B self and cross at 1024 px, 4112 tokens, and
   at 1280 px, 6416 tokens; the fixture's; training's 1040 tokens, and
   528 under sequence dropout; ragged tails), in bf16 and fp32, timed beside the plain version, one PyTorch
   library call of the same function (`scaled_dot_product_attention`, a
   yardstick the port never calls) and the card's bound for the work; the
   largest abs error allowed is 1e-5 in fp32 and 5% of the plain fp32
   result's rms in bf16 (`flash_attention.tolerance`), printed with each
   shape; ptxas' lines of its bf16 instances, none of which may spill or
   have its wgmma serialised (C7512);
4. the dq and dkv kernels (bf16: TMA + wgmma, warp-specialised) against
   `flash_attention_bwd_plain` at the training path's shapes (1040 and,
   under sequence dropout, 528 tokens) and at a head
   dim the wrapper pads (128 -> 256), in bf16 and fp32 (`grad_tolerance`:
   5% of the plain gradient's rms in bf16, with P and dS rounded to bf16
   where the kernels round them, the error against the plain result
   rounded to the kernels' output dtype and that rounding's own error
   printed beside; 1e-5 of its largest magnitude in fp32),
   with exact zeros at masked keys and kv_len 0 rows, timed beside the
   plain version, SDPA forward + backward minus forward, and the bound;
   ptxas' register, spill and C7512 lines of the bf16 backward kernels,
   none of which may spill or have its wgmma serialised;
5. the perf lab's variant kernel (`csrc/flash_attention_variants.cu`, on
   the forward's mainloop) against `flash_fwd_plain`: ptxas' lines of its
   42 instances (no spill, no C7512); its seven variants at every block
   pair of `flash_variants.blocks(d)`, at 2x10x4112x256, at 333 keys
   (ragged tiles) with D 256 and 64, and at a head dim the wrapper pads
   (128 -> 256), within `flash_attention.tolerance`, condmask equal to its
   twin bit for bit, each flag's `flag_step` within 0.25 of 1, with the
   plain version's, SDPA's and the bound's ms; then the lab as a user runs
   it (`python -m f_lite_tpu_torch.tools.flash_variants`), its launches
   counted against `blocks(256)`, and its sweep at the other shapes;
6. one 7B-width DiT block with cross-attention and residual_v (bf16
   compute, fp32 weights, 512 px, batch 4): every parameter and input
   gradient through the kernels within 2e-2 (relative norm) of the same
   block through the plain attention;
6a. the int8 kernels (`csrc/int8_gemm.cu`: the per-token quantize and the
   persistent int8 product with its dequant epilogue) against their plain
   versions, bit for bit, at every projection shape of the 7B's and the
   fixture's int8 paths and at the product's grid edges (SMs - 1, SMs,
   SMs + 1 m-tiles and a partial last round at K 144, 2576 and 5136,
   `int8_tiles.edge_shapes`) (bf16 and fp32 input, with and without bias,
   the int32 accumulators too); the path shapes timed beside the plain
   versions, `torch._int_mm` plus the dequant (a yardstick the port never
   calls), bf16 `F.linear` at the same shape (what int8 replaces) and the
   bound; for each of the product's two designs its fixed cost a tile and
   cost a k-tile, fitted with their residual to its times at M 8224, N 7680
   and three K at which the wrapper picks it (`int8_tiles.fit_k_sweep`);
   ptxas' lines of both kernels, none of which may spill or have its wgmma
   serialised;
6b. the quantize kernel's entries for a row-parallel layer under tensor
   parallelism (`row_amax`, and `quantize_rows_given`, which quantizes
   with a given amax: the tp ranks' maximum, so sx is the whole row's)
   against their plain versions bit for bit, and the given entry fed the
   row's own amax bit-equal to the fused entry, at the row-parallel
   layers' K at tp 2 (the 7B's proj and down, the fixture's), bf16 and
   fp32; timed beside the plain versions, the fused entry and the bound;
6c. the RMSNorm kernel (`csrc/rms_norm.cu`, forward and backward through
   `ops/norms.py`) against its plain twins at the 7B's, the 10B's, the
   QK-norm's, the training cell's and the T5 tower's shapes and at the
   cross-attention's q and k layouts (`NORM_SHAPES`): y, dx and dw within
   `rms_norm.excess`, y in the plain path's layout (contiguous where the
   wrapper copies x), dw bit-repeatable; the dense shapes timed beside
   the plain path, `F.rms_norm` and the byte bound (CUDA-graph replays
   over inputs beyond the L2);
7. serving, the committed trained fixture (`artifacts/fixture_run/
   pipeline`): 4 requests of the 24 shape captions, 64x64 px, 30 steps,
   g=6; both_acc >= 0.95 and exactly 4 * 30 * 12 forward launches;
8. the fixture again with limited-interval guidance (0.1, 0.9), both_acc
   >= 0.95, and at 15 steps with Euler and with ab2, each one's MSE to
   Euler@30 printed;
8a. int8 serving, the fixture loaded with `quantize=True` (bf16), the
   requests of phase 7: both_acc >= 0.95 and PSNR >= 30 dB against phase
   7's bf16 images (10 log10(4 / MSE) on [-1, 1]); exactly 4 * 30 * 12
   forward and 4 * 30 * 48 launches of each int8 kernel;
8h. int8 under tensor parallelism at tp 1 (run after 8a): phase 8a's
   pipeline split by `parallel.tensor.parallelize_dit` over a one-rank tp
   mesh of an NCCL group of one, formed in this process and destroyed
   after: the first 2 of phase 8a's requests, their images bit for bit
   (each row-parallel layer takes its rows' amax, all-reduces it and
   quantizes with it); exactly 2 * 30 * 12 forward, 2 * 30 * 48 product
   and 2 * 30 * (48 + 2 x 18 row-parallel layers) quantize launches;
8b. the fixture from prompts: phase 7's requests as `pipe(prompt=
   captions)` with the port's `ZeroTextEncoder(64, seq_len=32)` attached:
   images equal to phase 7's bit for bit, both_acc >= 0.95, exactly
   4 * 30 * 12 forward launches;
8c. the fixture with a LoRA merged at load (`from_pretrained(lora_path=)`):
   seeded rank-4 factors on every qkv, q, context_kv and proj, written
   here in the framework's safetensors form (the port's writer) and in
   the peft `.pt` form; at lora_scale 0 phase 7's images bit for bit; at
   scale 1 the two forms give equal images, finite and not phase 7's
   (both_acc printed, no bar: the factors are random); exactly
   4 * 30 * 12 forward launches in each run, and with quantize=True
   4 * 30 * 48 launches of each int8 kernel;
8d. `save_pretrained` of the bf16 fixture and `from_pretrained` of the
   result; a diffusers-layout snapshot of the fixture written here
   (reference key names under `dit_model/`) through `from_pretrained`
   twice, the first load converting and caching, the second taking the
   cache: each gives phase 7's images bit for bit, with exact launch
   counts; the save, convert and cached-load seconds printed;
8e. the fixture through `generate` (`--no_text_encoder`, whose 32
   md5-seeded tokens are the fixture's training context, 64 px, 30 steps,
   g=6): in-process `generate.main` for captions 0 and 23 at
   `--num_images 2`, the PNGs (read back with the port's `read_png`) equal
   to `pipe(prompt=..., generator=...)` bit for bit, both_acc >= 0.95,
   exactly 2 * 30 * 12 forward launches; `--from_png` regenerates the same
   pixels; the 24 captions' both_acc with 32 and with 128 (JAX's
   front-ends') pseudo tokens, printed; `--quantize`: exactly 30 * 12
   forward and 30 * 48 launches of each int8 kernel, pixels equal to the
   direct int8 call; once more as a subprocess (`python -m
   f_lite_tpu_torch.generate`, started first, beside the rest), bit-equal;
8f. the fixture through `serve`: batch mode from a `.jsonl` of 4 captions
   with seeds at batch 2, each PNG equal to the solo request with its seed
   bit for bit, exactly 2 * 30 * 12 forward launches, images/min printed;
   HTTP mode (`make_http_server` on an ephemeral port after `warm_up`,
   urllib): /healthz, 4 requests each equal to the direct call with its
   seed and exactly 4 * 30 * 12 forward launches, a 400 and a 413,
   /metrics equal to what was sent, and a drain that finishes the request
   in flight and answers 503 to a new one (the fixture has no VAE, so its
   image-to-image request runs in phase 9e);
8g. the converter CLI (`f_lite_tpu_torch.tools.convert_checkpoint`): the
   fixture exported with `--export_torch --pt_file` and ingested back from
   the `.pt` (`--pt --width 256 --head_dim 64`) and from the export
   (`--hf_dir`): each loaded with `from_pretrained` gives phase 7's images
   bit for bit with phase 7's launch counts, the conversions launch
   nothing; `--test_image` on the card (pixel space: latents) finite with
   exactly 4 * 12 forward launches; then `DiTConfig.f_lite_7b()` at depth 1
   (full width; the depth cut stated in the output), seeded, saved
   natively, `--export_torch --pt_file` and `--pt` back: each direction's
   host seconds, GB written and GB/s, the re-ingested tensors bit-equal to
   the saved ones;
8i. the fabricated 7B release (`python -m
   f_lite_tpu_torch.tools.fabricated_release_dryrun --convert_only` as a
   subprocess on the card, started after phase 6b and running beside
   phases 7-12c): the full `freepik-f-lite-7b` manifest (depth 40) drawn on
   the card in the released diffusers layout (the reference's keys, a
   Flux-shaped VAE in diffusers naming), written in memory (`memory_tmp`:
   the 39 GB of files fail the phase where memory cannot hold them) and
   ingested with F_LITE_STRICT_INGEST=error: exit 0, 399 keys and
   4,749,401,703 parameters, fabricate and convert seconds. Then, in a
   thread of this process beside phases 7-12c, the pipeline of phases 9-11:
   `from_pretrained` in bf16 of the tool's strict `resolve_pretrained` of
   the snapshot, which takes the cache (cached load seconds);
   F_LITE_STRICT_INGEST given back; every tensor finite, peak under 80
   GB. After phase 11a, the tool's serve step
   (`fabricated_release_dryrun.serve`) on the int8 pipeline: the JAX
   tool's embeddings, 2 images of 1024 px in 30 steps, finite, exactly
   2 * 30 * 56 forward and 2 * 30 * 248 launches of each int8 kernel, the
   sample PNG read back, peak under 80 GB, p50 s/image;
9a. T5-XXL at full width and depth (`T5Config()`: 24 blocks, d_model
   4096, 64 heads x 64, d_ff 10240, gated-gelu), seeded bf16 weights, at
   return_index -8 (blocks 0-16): one prompt of 77 seeded ids padded to
   80, and a batch of lengths 5, 40, 77 and 300 padded to 304. Shapes
   (B, S, 4096), finite, no kernel of the port launched; within
   `flash_attention.tolerance` (5% of the fp32 result's rms) of the same
   weights in fp32 (TF32 off) on the real rows, and the 77 real rows
   padded to 80 and to 128 within it of each other (the largest err/tol
   printed); encode ms (CUDA events, median of 10) beside the bound (the
   17 blocks' bf16 weights over 3.35 TB/s against their FLOPs over 989
   TFLOP/s) and peak GB. The fp32 copy is freed before the DiT is built;
9b. the Qwen2.5-VL-7B language tower (`Qwen2Config()`: 28 layers, hidden
   3584, 28 / 4 kv heads, intermediate 18944), the checks and figures of
   9a on 160 seeded ids (padded to 160 and to 192) and a batch of lengths
   5, 40, 160 and 300, with nothing else resident (it runs first);
9c. phase 9's pipeline with the phase-9a T5-XXL attached through a
   tokenizer defined here (`WordTokenizer`: words to seeded ids):
   `pipe(prompt=...)` without and then with a negative prompt, 1024 px,
   30 steps, g=6; finite images and exactly 30 * 56 forward launches
   each; s/image with the encode's share, peak GB with T5 resident.
   Phases 9b, 9a, (12-12c, T5 resident) and 9c run in that order before
   phase 9, whose figures are taken with T5 freed again;
9. serving, one 7B-width request on phase 8i's release (DiT f_lite_7b +
   Flux VAE, seeded random weights through the released layout, bf16):
   1024x1024, 30 steps, g=6, 128 text tokens of which 77 are real; finite
   output, exactly 30 * 56 forward launches;
10. image to image with a mask at 1280 px on the same pipeline: strength
   0.5 (15 of 30 steps), the left half repainted, encode and decode tiled
   (9 tiles each); finite output, exactly 15 * 56 forward launches, the
   kept region of the final latents equal to the encoded image's;
11. strength 1.0 without a mask equals text to image bit for bit (256 px);
9d. phase 9's request with a seeded rank-64 LoRA on every target
   (`train.lora.apply_lora`, what `from_pretrained` merges with) merged
   into a copy of phase 9's DiT, the original parked on the host: finite,
   exactly 30 * 56 forward launches, merge s, s/image and peak GB beside
   phase 9's; `return_latents=True` equal to `output_type="latent"` bit
   for bit (2 steps);
9e. phase 9's pipeline behind the HTTP server (`ZeroTextEncoder` of the
   7B's width, 77 tokens, `--text_bucket 128`), warmed by `serve.warm_up`
   first: one 1024 px 30-step request, finite, exactly 30 * 56 forward
   launches, the client's s/request beside phase 9's s/image, PNG encode
   and decode ms, and `read_png`'s decode ms of the same image filtered
   adaptively (as libpng and PIL write it), all Average and all Paeth
   (the filters decoded byte by byte); an image-to-image request with a base64 PNG (256 px, 4
   steps, strength 0.5) equal to the direct call bit for bit with exactly
   2 * 56 launches; `steps_per_dispatch=5` with a callback on 2- and
   6-step trajectories, Euler and ab2: latents bit-equal to one window and
   JAX's (e, n) calls; a callback cancelling after the first window:
   exactly 5 * 56 forward launches;
9f. head padding at load (run after 9e): phase 9's DiT padded from 10 to
   12 heads (`convert.heads.pad_dit_heads`, what `from_pretrained(
   pad_heads_to=12)` does), the original parked on the host: phase 9's
   request, its final latents (the decoder's input) within the forward
   kernel's tolerance (`flash_attention.tolerance`) of phase 9's, exactly
   30 * 56 forward launches as unpadded, s/image and peak GB beside phase
   9's; the padded DiT quantized in place, the same request: 30 * 56
   forward and 30 * 248 launches of each int8 kernel, its final latents
   against phase 11a's (printed with their gap after 11a, held to the same
   tolerance). Then phase 9's pipeline saved (`save_pretrained`) with a
   precompute cache of PROMPT's 77-token embedding, and `torchrun
   --nproc_per_node 1 -m f_lite_tpu_torch.serve --precomputed_dir ...
   --http_port 0 --dp 1 --tp 1` (an NCCL group of one, the DiT under
   `parallelize_dit` at tp 1, TF32 off as in this process; saved after
   phase 9 and loading while phases 10-9f run here) answering
   phase 9e's request (1024 px, 30 steps, seed 4) with phase 9e's pixels
   bit for bit; /healthz; SIGTERM drains it; save, load, warm-up and
   request seconds printed;
11a. int8 serving at 7B width: the pipeline of phases 9-11 quantized in
   place (`quant.quantize_dit`), the request of phase 9: finite output,
   exactly 30 * 56 forward and 30 * 248 launches of each int8 kernel,
   s/step, s/image, peak GB and a step profile beside phase 9's;
12. training, the fixture's recipe from scratch through the port's trainer
   (`f_lite_tpu_torch.train`): a precomputed cache of 24 classes x 128
   shapes images (64 px, pixel space) written here, 300 steps at batch 32,
   bf16; the mean logged loss over steps 260-300 must be <= 0.15 (the JAX
   run's `artifacts/fixture_run/train.log` reads 0.073); exactly 12
   launches of each kernel per step; the exported pipeline reloads with
   the same DiT output;
12b. resume: the fixture recipe 40 steps straight against 20, then
   `--resume_from_checkpoint latest` to 40, with `--async_checkpoint` saves
   at step 20: every step's loss and the final checkpoint's tensors
   bit-equal, exactly 12 launches of each kernel a step; SIGTERM to a
   trainer subprocess (started first, training beside those runs) once it
   has logged a step: exit 0, the stop
   (`preempted_at`) logged with a checkpoint at its step, and a resume 10
   steps on;
12c. fine-tuning: the committed fixture through `--pretrained_model_path`
   with `--use_lora --lora_rank 4`, `--ema_decay 0.99`,
   `--gradient_accumulation_steps 2`, `--bs_rampup 20` and
   `--sequence_dropout 0.5` (528 self-attention tokens), 60 micro-steps:
   finite losses, exactly 12 launches of each kernel a micro-step; the
   exported pipeline (EMA factors merged) scores phase 7's requests at
   both_acc >= 0.95 with exact launch counts;
13. training, `f_lite_7b_width_d20_train512`: the 7B's widths at depth 20,
   512 px latents (1040 tokens), batch 4, bf16 with fp32 master weights,
   checkpointing from block 8, 10 steps; finite loss and grad norm,
   exactly 46 forward, 31 dq and 31 dkv launches per step, peak memory
   under 80 GB, a profile of one step, and the trainer's final (full
   state) checkpoint's seconds and GB;
13b. the same cut to depth 10 (`OPTIONS_7B_DEPTH`, for the script's
   time) with `--remat_policy dots`, then with `--sequence_dropout 0.5`
   (528 self-attention tokens): each 10 steps with phase 13's checks and
   figures (22/19/19 launches a step at depth 10: "dots" runs attention
   again in the backward);
13c. the same with `--use_lora --lora_rank 64` (the base frozen: its
   zero-initialised head leaves the factors' gradients 0, the work and
   launches those of a real run); then one full-state checkpoint at that
   width cut to depth 6 (`CHECKPOINT_7B_DEPTH`: its two saves are the
   only 7B files on the disk), `--async_checkpoint` at step 2 and the final
   sync save at step 3: seconds blocked and writing, GB on disk against
   n_params x 12, free disk checked first. The other 7B training runs (13,
   13b, 13d, 13e, 13g) keep their files in memory where there is room
   (`memory_tmp`);
12d. the fixture's recipe on the online image path (run after 12c): phase
   12's images written as 64 px PNGs by the port's writer with a JSON
   table (`--root_dir_type json --base_url file:// --center_crop
   --resolution 64 --text_encoder_type zero --uncond_prob 0.01
   --num_workers 4`), 300 steps at batch 32, bf16: mean logged loss over
   steps 260-300 <= 0.15, exactly 12 launches of each kernel a step;
   `--val_data_path` (two held-out batches) every 100 steps: val/loss
   finite, 12 forward and no backward launches an eval batch; `--sample_every
   300` with 4 captions: `samples/step_300.png` read back, 50 * 12 forward
   launches, its tiles' both_acc printed; `--profile_steps 10,12`: the
   trace names the three flash kernels; loader wait ms a step and s/step
   beside phase 12's;
12e. resume on the online path with `--random_flip`: 40 steps straight
   against 20 + `--resume_from_checkpoint latest`, every loss and the final
   checkpoint's tensors bit-equal; 5 steps with `--debug_nans` with losses
   bit-equal to 5 without; 12 launches of each kernel a step;
12f. buckets: the fixture's width from scratch on a dummy-backed table of
   three declared aspects, `--use_resolution_buckets` without
   `--center_crop`, batch 8, 20 steps: every batch of one shape, the
   kernels seeing 2064, 2256 and 2320 self tokens, 12 launches of each a
   step;
13d. 13f's run (the 7B width at depth 12) on the online path (after 13f):
   13f's dummy-backed JSON table of 512x512 rows, the Flux VAE at full
   width with seeded weights (`--vae_path`) encoding in fp32,
   `ZeroTextEncoder(4096, 32)`, batch 4, bf16, 10 steps: finite loss and
   grad norm, 26/21/21 launches a step, peak under 80 GB; s/step, the VAE
   encode's ms a step, the loader's wait ms, idle share and peak GB
   beside 13f's run from the same images' cache;
12g. the trainer under torchrun (`torchrun --standalone --nproc_per_node 1
   -m f_lite_tpu_torch.train --fsdp 0`, a subprocess: a real NCCL process
   group of one rank, the DiT under FSDP2's `fully_shard`), phase 12b's
   straight run (40 steps, an async save at 20): every step's loss (read
   from the run's `metrics.jsonl`) bit-equal to 12b's unwrapped run, or
   within 1e-6 relative with the gap printed; exactly 12 launches of each
   kernel a step, read from the same file (none in this process); the
   step-20 checkpoint resumed in an unwrapped run gives 12b's steps 21-40;
   s/step beside phase 12's;
12h. tensor and sequence parallelism at tp 1: phase 12b's straight run in a
   torchrun subprocess of this script (an NCCL group of one; it runs
   beside 12g's, and 12g's resume waits for it) in which the
   trainer's `parallelize_dit` is applied with `sequence_parallel=True`
   on the one-rank tp mesh (the split stream, its all-gathers and
   reduce-scatters, and the permuted fused rows at their tp-1 identity;
   the run logs that it was applied): every loss bit-equal to 12b's, or
   within 1e-6 relative with the gap printed; exactly 12 launches of each
   kernel a step; s/step beside 12g's (both taken side by side);
13e. 13f's run (the 7B width at depth 12 from the tool's cache) under
   torchrun with `--fsdp 0`, 10 steps (after 13f): finite loss and grad
   norm, 26/21/21 launches a step, peak under 80 GB; whether its losses
   equal 13f's bit for bit (printed), its s/step, peak GB and idle share
   (the run's own trace of step 9) beside 13f's, the final full-state
   checkpoint's gather and write seconds beside 13c's sync save;
13f. the cache builder (`f_lite_tpu_torch.tools.precompute_embeddings`): the
   first 256 rows of phase 12d's PNG table with a seeded tiny VAE
   (`--vae_path`), the zero encoder and `--center_crop`, built on the card
   and with `--device cpu`: the indexes equal, the embeddings bit-equal,
   every latent within 1e-5 x max |CPU| (fp32, TF32 off, the same CPU-drawn
   noise), no kernel launched; then phase 13d's 512 px dummy-backed table
   (64 rows) through the Flux VAE at full width and `ZeroTextEncoder(4096,
   32)`: s/image split into the VAE encode (CUDA events) and the text
   encode (host clock), the cache's GB on disk and peak GB; and
   the 7B width at depth 12 (`TOOL_CACHE_7B_DEPTH`) for 10 steps from
   that cache with phase 13's checks (26/21/21 launches a step), s/step
   beside phase 13's;
13g. pipeline parallelism at one stage: 13f's run (the 7B width at depth
   12 from the tool's cache) plus `--scan_layers --export_pipeline` in a
   torchrun subprocess of this script (an NCCL group of one) whose trainer
   runs the GPipe schedule (`parallel/pipeline.py`) at 1 stage and 2
   microbatches (the trainer's own check, as JAX's, refuses microbatches
   without `--pp` > 1; the run logs that it was applied), 10 steps:
   finite losses, exactly 52 / 42 / 42 launches a step (2 x 13f's),
   step 1's loss within 1e-3 relative of 13f's and every loss within
   1e-2 (the gaps printed), peak under 80 GB, s/step and peak GB beside
   13f's; the export (the scan-stacked layout, `scan_layers: true`,
   `pipeline_stages: 1`) loaded back on the card by
   `FLitePipeline.from_pretrained` bit-equal to the final checkpoint's
   weights (its files in memory where there is room, `memory_tmp`);
14. a `{"gpus": N, "multi_rank_checks": "cpu/gloo"}` line (runs of 2 and 4
   ranks, tp and dp x tp among them, are checked on the CPU with gloo:
   the card's machine has one GPU), a `{"kernels": [...]}` line (with
   the `release_7b` record of phase 8i: fabricate, convert and cached-load
   seconds, bf16 and int8 s/image, peak GB), the script's total seconds,
   then the
   card line, then the last line `{"ok": true, "device": {...}}`.
Every path runs with the launch counts set to 0 just before it and read
just after; a kernel of another path launched there fails the run. The
RMSNorm kernel's counts are checked on every path too: `norm_calls` a DiT
forward, `train_step_launches` a training step, `tower_norms` a text
tower's forward.
Before phase 9 and at the end the card's state is printed (`card_state`:
power draw, SM clock against its maximum, temperature, the throttle
reasons and the processes holding memory), so a slow run shows whether
the card or this script held it back.

Exits non-zero, printing no result, where `torch.cuda.is_available()` is
false or the package is missing.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import logging
import math
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "artifacts" / "fixture_run" / "pipeline"

# every entry of the {"kernels": [...]} line carries these
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err",
               "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12

# fixture classes (own copy of tools/make_shapes_dataset.py constants)
COLORS = {
    "red": (220, 40, 40),
    "green": (40, 180, 60),
    "blue": (50, 80, 220),
    "yellow": (230, 210, 50),
    "purple": (150, 60, 200),
    "cyan": (60, 200, 210),
    "orange": (235, 140, 40),
    "white": (245, 245, 245),
}
SHAPES = ("circle", "square", "triangle")
BACKGROUND = (110, 110, 110)


def classify(img):
    """img (H, W, 3) float in [-1, 1] -> (color_name, shape_name): nearest
    colour anchor of the non-background pixels, and the shape whose
    bounding-box fill ratio is nearest (own copy of the fixture audit's
    geometric classifier)."""
    import numpy as np

    rgb = (np.clip(img, -1, 1) + 1.0) * 127.5
    bg = np.asarray(BACKGROUND, np.float32)
    mask = np.linalg.norm(rgb - bg, axis=-1) > 60.0
    if mask.mean() < 0.02:
        return None, None
    mean_rgb = rgb[mask].mean(axis=0)
    color = min(
        COLORS, key=lambda c: np.linalg.norm(mean_rgb - np.asarray(COLORS[c]))
    )
    ys, xs = np.nonzero(mask)
    fill = mask.sum() / float((ys.max() - ys.min() + 1) * (xs.max() - xs.min() + 1))
    ratios = {"triangle": 0.5, "circle": np.pi / 4, "square": 0.97}
    shape = min(ratios, key=lambda s: abs(fill - ratios[s]))
    return color, shape


def log(*args):
    print(*args, flush=True)


def reset_counts():
    from f_lite_tpu_torch.ops.cuda import flash_attention as fa
    from f_lite_tpu_torch.ops.cuda import flash_variants as fv
    from f_lite_tpu_torch.ops.cuda import int8_gemm as ig
    from f_lite_tpu_torch.ops.cuda import rms_norm as rn

    for counter in (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES, fv.LAUNCHES,
                    ig.QUANTIZE_LAUNCHES, ig.GEMM_LAUNCHES, rn.LAUNCHES, rn.BWD_LAUNCHES):
        counter.reset()


def read_counts() -> dict:
    from f_lite_tpu_torch.ops.cuda import flash_attention as fa
    from f_lite_tpu_torch.ops.cuda import flash_variants as fv
    from f_lite_tpu_torch.ops.cuda import int8_gemm as ig
    from f_lite_tpu_torch.ops.cuda import rms_norm as rn

    return dict(fwd=fa.LAUNCHES.count, dq=fa.DQ_LAUNCHES.count,
                dkv=fa.DKV_LAUNCHES.count, variants=fv.LAUNCHES.count,
                quantize=ig.QUANTIZE_LAUNCHES.count, gemm=ig.GEMM_LAUNCHES.count,
                rms_norm=rn.LAUNCHES.count, rms_norm_bwd=rn.BWD_LAUNCHES.count)


def launches(fwd=0, dq=0, dkv=0, variants=0, quantize=0, gemm=0, rms_norm=0,
             rms_norm_bwd=0) -> dict:
    """The counts `read_counts` should give."""
    return dict(fwd=fwd, dq=dq, dkv=dkv, variants=variants, quantize=quantize,
                gemm=gemm, rms_norm=rms_norm, rms_norm_bwd=rms_norm_bwd)


def attention_calls(cfg) -> int:
    """Attention calls of one DiT forward of `cfg` (kernel #1's launches):
    one a block, two in a cross-attention block."""
    return cfg.depth + sum(cfg.block_has_cross_attn(i) for i in range(cfg.depth))


def norm_calls(cfg, blocks=None) -> int:
    """`rms_norm` calls of one DiT forward of `cfg` (kernel #7's forward
    launches): norm1, norm3 and the self-attention's q and k in every
    block, norm2 and the cross-attention's q and k besides in a
    cross-attention block, then the context norm and the head's. `blocks`:
    those of these block indices alone (a recomputed region)."""
    if blocks is not None:
        return sum(4 + 3 * cfg.block_has_cross_attn(i) for i in blocks)
    return norm_calls(cfg, range(cfg.depth)) + 2


def dit_launches(cfg, forwards: int, **int8) -> dict:
    """What `read_counts` should give after `forwards` DiT forwards of
    `cfg` without gradients (a denoise step each: the CFG pair is one
    batch): kernel #1 once an attention, kernel #7 once a norm; `int8`
    the int8 kernels' counts."""
    return launches(fwd=forwards * attention_calls(cfg),
                    rms_norm=forwards * norm_calls(cfg), **int8)


def train_step_launches(cfg, lora=False) -> dict:
    """Launches of one training (micro-)step of a DiT of `cfg`, its blocks
    from `gradient_checkpoint_from` recomputed where `cfg` checkpoints
    ("full" or "dots": the norms run again either way): every attention
    and norm forward once, the recomputed blocks' again in the backward;
    one dq and one dkv an attention; one norm backward a norm but, under
    LoRA (everything frozen but the factors), the context norm's and block
    0's norm1, whose inputs and weights take no gradient."""
    remat = range(cfg.gradient_checkpoint_from if cfg.gradient_checkpoint else cfg.depth,
                  cfg.depth)
    n_attn = attention_calls(cfg)
    n_remat = sum(1 + cfg.block_has_cross_attn(i) for i in remat)
    return dict(fwd=n_attn + n_remat, dq=n_attn, dkv=n_attn,
                rms_norm=norm_calls(cfg) + norm_calls(cfg, remat),
                rms_norm_bwd=norm_calls(cfg) - (2 if lora else 0))


def tower_norms(stack, return_index=-8) -> int:
    """`rms_norm` calls of one text-tower forward to `return_index`: two a
    block run (T5's two layer norms, Qwen2's input and post-attention
    norms), and the final norm where the index is the last state."""
    from f_lite_tpu_torch.text.layers import resolve_index

    cfg = stack.config
    depth = getattr(cfg, "num_layers", None) or cfg.num_hidden_layers
    idx = resolve_index(return_index, depth + 1)
    return 2 * idx + (idx == depth)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def card_state(label: str) -> None:
    """Print the card's power draw, clocks, temperature and throttle
    reasons, and the processes holding its memory."""
    queries = (("--query-gpu=name,power.limit,power.draw,clocks.sm,clocks.max.sm,"
                "temperature.gpu,clocks_throttle_reasons.active"),
               "--query-compute-apps=pid,used_memory")
    for query in queries:
        out = subprocess.run(["nvidia-smi", query, "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        text = (out.stdout.strip() or out.stderr.strip()).replace("\n", " | ")
        log(f"card_state {label} {query.split('=')[0][8:]}: {text or '(none)'}")


def time_ms(fn) -> float:
    """Mean device time of fn() in ms, with CUDA events, after warm-up;
    as many launches (3 to 50) as fit in about 0.2 s."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = max(3, min(50, int(0.2 / max(time.perf_counter() - t0, 1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 3: the flash-attention kernel against its plain version
# ---------------------------------------------------------------------------

# (label, B, H, Lq, Lk, D, kv_lens or None)
ATTN_SHAPES = [
    ("fixture_self", 48, 4, 1040, 1040, 64, None),
    ("fixture_cross", 48, 4, 1040, 32, 64, [32] * 48),
    ("7b_self", 2, 10, 4112, 4112, 256, None),
    ("7b_cross", 2, 10, 4112, 128, 256, [77, 128]),
    ("odd_d64", 3, 2, 333, 77, 64, [77, 0, 41]),
    ("odd_d256", 2, 3, 130, 93, 256, [0, 93]),
    ("train_7b_self", 4, 10, 1040, 1040, 256, None),
    ("train_7b_cross", 4, 10, 1040, 128, 256, [77, 128, 77, 128]),
    ("7b1280_self", 2, 10, 6416, 6416, 256, None),
    ("7b1280_cross", 2, 10, 6416, 128, 256, [77, 128]),
    # sequence dropout 0.5: 16 registers + 512 kept tokens
    ("seqdrop_fixture_self", 32, 4, 528, 528, 64, None),
    ("seqdrop_fixture_cross", 32, 4, 528, 32, 64, [32] * 32),
    ("seqdrop_7b_self", 4, 10, 528, 528, 256, None),
    ("seqdrop_7b_cross", 4, 10, 528, 128, 256, [77, 128, 77, 128]),
    # the online path: the fixture's 80x112 bucket (2240 patches + 16
    # registers) and the 7B's 32 ZeroTextEncoder tokens
    ("bucket_fixture_self", 8, 4, 2256, 2256, 64, None),
    ("online_7b_cross", 4, 10, 1040, 32, 256, [32] * 4),
]


def attention_bound_ms(b, h, lq, lk, d, kv_lens, dtype_name) -> tuple:
    keys = sum(kv_lens) if kv_lens is not None else b * lk
    item = 2 if dtype_name == "bfloat16" else 4
    flops = 4.0 * h * lq * d * keys
    nbytes = item * (2 * b * h * lq * d + 2 * h * d * keys)
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_attention() -> list[dict]:
    import torch
    import torch.nn.functional as F

    from f_lite_tpu_torch.ops.cuda import flash_attention as fa

    ptxas_check(("flash_attention_fwd",), ("flash_fwd_bf16_kernel",), "forward")
    rows = []
    gen = torch.Generator("cuda").manual_seed(0)
    for label, b, h, lq, lk, d, kv in ATTN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).removeprefix("torch.")
            q, k, v = (
                torch.randn((b, h, n, d), generator=gen, device="cuda",
                            dtype=dtype)
                for n in (lq, lk, lk)
            )
            lens = None if kv is None else torch.tensor(
                kv, dtype=torch.int32, device="cuda")
            got = fa.flash_attention(q, k, v, lens)
            torch.cuda.synchronize()
            ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), lens)
            err = float((got.float() - ref).abs().max())
            tol = fa.tolerance(ref, dtype)
            if not math.isfinite(err) or err > tol:
                raise AssertionError(
                    f"flash_attention {label} {name}: max abs err {err} > {tol}"
                )
            mask = None if lens is None else (
                torch.arange(lk, device="cuda")[None, :] < lens[:, None]
            )[:, None, None, :]
            ms = time_ms(lambda: fa.flash_attention(q, k, v, lens))
            plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, lens))
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask))
            bound, bound_by = attention_bound_ms(b, h, lq, lk, d, kv, name)
            row = dict(shape=label, dtype=name, q=[b, h, lq, d],
                       kv=[b, h, lk, d], kv_lens=kv, max_abs_err=err,
                       tolerance=tol, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound, bound_by=bound_by)
            log("attention", json.dumps(row))
            rows.append(row)
            del q, k, v, got, ref
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 4: the backward kernels against their plain version
# ---------------------------------------------------------------------------

# (label, B, H, Lq, Lk, D, kv_lens or None): the training path's calls
BWD_SHAPES = [
    ("fixture_self", 32, 4, 1040, 1040, 64, None),
    ("fixture_cross", 32, 4, 1040, 32, 64, [32] * 32),
    ("7b_self", 4, 10, 1040, 1040, 256, None),
    ("7b_cross", 4, 10, 1040, 128, 256, [77, 128, 77, 128]),
    ("odd_d64", 3, 2, 333, 77, 64, [77, 0, 41]),
    ("odd_d256", 2, 3, 130, 93, 256, [0, 93]),
    # a head dim with no compiled instance: zero-padded to 256
    ("7b_d128", 4, 10, 1040, 1040, 128, None),
    # sequence dropout 0.5: 16 registers + 512 kept tokens
    ("seqdrop_fixture_self", 32, 4, 528, 528, 64, None),
    ("seqdrop_fixture_cross", 32, 4, 528, 32, 64, [32] * 32),
    ("seqdrop_7b_self", 4, 10, 528, 528, 256, None),
    ("seqdrop_7b_cross", 4, 10, 528, 128, 256, [77, 128, 77, 128]),
    # the online path (see ATTN_SHAPES)
    ("bucket_fixture_self", 8, 4, 2256, 2256, 64, None),
    ("online_7b_cross", 4, 10, 1040, 32, 256, [32] * 4),
]


def kernel_label(mangled: str, name: str) -> str:
    """`name<template arguments>` of a mangled kernel name, e.g.
    flash_variant_kernel<256,80,1,1,0,0> (D, BK, then the flags)."""
    import re

    args = re.findall(r"L[ib](\d+)E", mangled.split(name, 1)[-1])
    return f"{name}<{','.join(args)}>"


def ptxas_check(sources, names, what) -> list[str]:
    """ptxas' register, spill and warning lines of the kernels named by
    one of `names` in the build logs of `sources`; raises where one spills
    or has its wgmma serialised (C7512)."""
    import re

    from f_lite_tpu_torch.ops.cuda.build import library_path

    lines, bad = [], []
    for source in sources:
        report = library_path(source).with_suffix(".log").read_text()
        kernel = None
        for line in map(str.strip, report.splitlines()):
            if "Compiling entry" in line:
                name = next((n for n in names if n in line), None)
                kernel = name and kernel_label(line, name)
            elif "C7512" in line and any(n in line for n in names):
                lines.append(line)
                bad.append(line)
            elif kernel and ("registers" in line or "spill" in line):
                lines.append(f"{kernel}: {line}")
                spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if spills and spills.groups() != ("0", "0"):
                    bad.append(f"{kernel}: {line}")
    for line in lines:
        log(f"  ptxas {what}: {line}")
    if bad:
        raise AssertionError(f"{what} kernels spill or serialise: {bad}")
    return lines


def backward_ptxas() -> list[str]:
    """ptxas' lines of the bf16 backward kernels; raises where one spills
    or has its wgmma serialised (C7512)."""
    return ptxas_check(("flash_attention_bwd",),
                       ("flash_bwd_dq_bf16", "flash_bwd_dkv_bf16"), "backward")


def backward_bound_ms(b, h, lq, lk, d, kv_lens, dtype_name, which) -> tuple:
    """The least time of the work on an H100 SXM: products over the real
    keys (dq: 3 -> 6*H*Lq*D*keys flops, dkv: 4 -> 8*..., the pair: 14, a
    fused design's least: 5 -> 10*...), against the bytes read and written
    once (k, v over the real keys; lse and D fp32)."""
    keys = sum(kv_lens) if kv_lens is not None else b * lk
    item = 2 if dtype_name == "bfloat16" else 4
    q_rows = b * h * lq * d * item      # q, dO, O or dq
    kv_real = h * keys * d * item      # k or v, real keys only
    kv_all = b * h * lk * d * item     # dk or dv, every key written
    stats = b * h * lq * 4             # lse or D
    products, nbytes = {
        "dq": (3, 2 * q_rows + 2 * kv_real + 2 * stats + q_rows),
        "dkv": (4, 2 * q_rows + 2 * kv_real + 2 * stats + 2 * kv_all),
        "pair": (7, 3 * q_rows + 2 * kv_real + 2 * stats + q_rows + 2 * kv_all),
        "fused": (5, 3 * q_rows + 2 * kv_real + 2 * stats + q_rows + 2 * kv_all),
    }[which]
    t_ops = 2.0 * products * h * lq * d * keys / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def sdpa_backward_ms(q, k, v, dout, mask):
    """SDPA forward + backward minus forward (a yardstick the port never
    calls); None where no SDPA backend takes the shape."""
    import torch
    import torch.nn.functional as F

    qq, kk, vv = (x.detach().clone().requires_grad_() for x in (q, k, v))

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)

    def fwd_bwd():
        F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask).backward(dout)

    try:
        return time_ms(fwd_bwd) - time_ms(fwd)
    except RuntimeError as err:  # no backend for this shape and dtype
        log(f"  sdpa backward: none ({str(err).splitlines()[0][:120]})")
        return None


def check_backward() -> list[dict]:
    import torch

    from f_lite_tpu_torch.ops.cuda import flash_attention as fa

    backward_ptxas()
    rows = []
    gen = torch.Generator("cuda").manual_seed(1)
    for label, b, h, lq, lk, d, kv in BWD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).removeprefix("torch.")
            q, k, v, dout = (
                torch.randn((b, h, n, d), generator=gen, device="cuda",
                            dtype=dtype)
                for n in (lq, lk, lk, lq)
            )
            lens = None if kv is None else torch.tensor(
                kv, dtype=torch.int32, device="cuda")
            qf, kf, vf, dof = (x.float() for x in (q, k, v, dout))
            lse = fa.flash_attention_lse_plain(qf, kf, lens)
            delta = fa.attention_delta(fa.flash_attention_plain(qf, kf, vf, lens), dof)
            got = fa.flash_attention_bwd(q, k, v, dout, lse, delta, lens)
            torch.cuda.synchronize()
            # the plain version rounds P and dS to bf16 where the kernels do
            want = fa.flash_attention_bwd_plain(q, k, v, dout, lse, delta, lens,
                                                out_dtype=torch.float32)
            # beside the error: the error against the plain result rounded
            # to the kernels' output dtype, and that rounding's own error
            # (in bf16 it alone passes 5% of the rms where |g| > 12.8 rms)
            errs, tols, errs_rounded, floors = {}, {}, {}, {}
            for gname, g, w in zip(("dq", "dk", "dv"), got, want):
                errs[gname] = float((g.float() - w).abs().max())
                errs_rounded[gname] = float((g.float() - w.to(dtype).float()).abs().max())
                floors[gname] = float((w.to(dtype).float() - w).abs().max())
                tols[gname] = fa.grad_tolerance(w, dtype)
                if not math.isfinite(errs[gname]) or errs[gname] > tols[gname]:
                    raise AssertionError(
                        f"backward {label} {name} {gname}: max abs err "
                        f"{errs[gname]} > {tols[gname]}")
            if kv is not None:
                if got[0][lens == 0].any():
                    raise AssertionError(f"backward {label} {name}: dq != 0 at kv_len 0")
                masked = torch.arange(lk, device="cuda")[None, :] >= lens[:, None]
                if any(g.transpose(1, 2)[masked].any() for g in got[1:]):
                    raise AssertionError(f"backward {label} {name}: dk/dv != 0 at masked keys")
            del got, want
            args = (q, k, v, dout, lse, delta, lens)
            dq_ms = time_ms(lambda: fa.flash_attention_bwd_dq(*args))
            dkv_ms = time_ms(lambda: fa.flash_attention_bwd_dkv(*args))
            plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(*args))
            mask = None if lens is None else (
                torch.arange(lk, device="cuda")[None, :] < lens[:, None]
            )[:, None, None, :]
            lib_ms = sdpa_backward_ms(q, k, v, dout, mask)
            bounds = {w: backward_bound_ms(b, h, lq, lk, d, kv, name, w)
                      for w in ("dq", "dkv", "pair", "fused")}
            row = dict(shape=label, dtype=name, q=[b, h, lq, d],
                       kv=[b, h, lk, d], kv_lens=kv, max_abs_err=errs,
                       max_abs_err_vs_rounded=errs_rounded, rounding_floor=floors,
                       tolerance=tols, dq_ms=dq_ms, dkv_ms=dkv_ms,
                       pair_ms=dq_ms + dkv_ms, plain_ms=plain_ms,
                       library_ms=lib_ms,
                       bound_ms={w: bd[0] for w, bd in bounds.items()},
                       bound_by={w: bd[1] for w, bd in bounds.items()})
            log("backward", json.dumps(row))
            rows.append(row)
            del q, k, v, dout, qf, kf, vf, dof, lse, delta
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 5: the perf lab's variant kernel against its plain version, then the
# lab itself
# ---------------------------------------------------------------------------

# (label, B, H, L, D): the lab's default shape, ragged key tails, and a
# head dim the wrapper pads (128 -> 256)
VARIANT_SHAPES = [
    ("7b_serving", 2, 10, 4112, 256),
    ("ragged_d256", 1, 2, 333, 256),
    ("ragged_d64", 1, 2, 333, 64),
    ("padded_d128", 1, 2, 333, 128),
]


def variants_ptxas() -> list[str]:
    """ptxas' lines of every variant kernel instance; raises where one
    spills or has its wgmma serialised."""
    return ptxas_check(("flash_attention_variants",), ("flash_variant_kernel",),
                       "variants")


def check_variants() -> list[dict]:
    """Every variant of `flash_variants.VARIANTS` at every block pair of
    `blocks(d)` against `flash_fwd_plain` at the same block_k (plain in fp32
    on the same bf16 inputs), within `flash_attention.tolerance`; `condmask`
    equal to its unmasked twin bit for bit; each other flag's branch at the
    full step from its twin (`flag_step` near 1). Per shape: the plain
    version's ms (base, block_k 64), SDPA's ms on the same q, k, v and the
    bound. First, ptxas' lines of every instance (no spill, no C7512)."""
    import torch
    import torch.nn.functional as F

    from f_lite_tpu_torch.ops.cuda import flash_attention as fa
    from f_lite_tpu_torch.ops.cuda import flash_variants as fv

    variants_ptxas()
    rows = []
    gen = torch.Generator("cuda").manual_seed(2)
    for label, b, h, l, d in VARIANT_SHAPES:
        q, k, v = (torch.randn((b, h, l, d), generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        errs, ratios, steps = [], [], []
        for bq, bk in fv.blocks(d):
            outs, wants = {}, {}
            for name, kw in fv.VARIANTS.items():
                got = fv.flash_fwd(q, k, v, block_q=bq, block_k=bk, **kw)
                torch.cuda.synchronize()
                want = fv.flash_fwd_plain(q, k, v, block_k=bk,
                                          out_dtype=torch.float32, **kw)
                err = float((got.float() - want).abs().max())
                tol = fa.tolerance(want, torch.bfloat16)
                if not math.isfinite(err) or err > tol:
                    raise AssertionError(f"variant {name} {label} ({bq}, {bk}): "
                                         f"max abs err {err} > {tol}")
                errs.append(err)
                ratios.append(err / tol)
                outs[name], wants[name] = got, want
            for twin, masked in (("base", "condmask-e"), ("exp2", "condmask")):
                if not torch.equal(outs[twin], outs[masked]):
                    raise AssertionError(f"variant {masked} {label} ({bq}, {bk}) "
                                         f"differs from {twin}")
            # the twins differ by less than the tolerance: each flag branch
            # must also move the output from its twin's plain result to its own
            for own, twin in fv.FLAG_TWINS:
                c = fv.flag_step(outs[own], wants[own], wants[twin])
                if not abs(c - 1) < fv.FLAG_STEP_TOLERANCE:
                    raise AssertionError(f"variant {own} {label} ({bq}, {bk}): "
                                         f"flag step {c} from {twin}, expected 1")
                steps.append(c)
            del outs, wants
        bound, bound_by = attention_bound_ms(b, h, l, l, d, None, "bfloat16")
        row = dict(shape=label, q=[b, h, l, d], blocks=fv.blocks(d),
                   max_abs_err=max(errs), max_err_over_tolerance=max(ratios),
                   flag_step=[min(steps), max(steps)],
                   plain_ms=time_ms(lambda: fv.flash_fwd_plain(q, k, v, block_k=64)),
                   library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                   bound_ms=bound, bound_by=bound_by)
        log("variants", json.dumps(row))
        rows.append(row)
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return rows


def run_lab() -> dict:
    """The lab's entry point as a user runs it (`python -m
    f_lite_tpu_torch.tools.flash_variants`: every variant at every pair of
    `blocks(d)` at 2x10x4112x256 bf16, 20 timed launches each), its launch
    counts, and its sweep at the other shapes of VARIANT_SHAPES."""
    from f_lite_tpu_torch.ops.cuda import flash_variants as fv
    from f_lite_tpu_torch.tools import flash_variants as lab

    reset_counts()
    rows = lab.main([])
    counts = read_counts()
    per_row = 1 + 1 + lab.REPS  # checked call, warm-up, timed launches
    n_rows = len(fv.blocks(lab.lab_shape()[3])) * len(fv.VARIANTS)
    expected = launches(variants=n_rows * per_row)
    if counts != expected or len(rows) != n_rows:
        raise AssertionError(f"lab: launches {counts} and {len(rows)} rows, "
                             f"expected {expected} and {n_rows}")
    ragged = {label: lab.sweep((b, h, l, d))
              for label, b, h, l, d in VARIANT_SHAPES[1:]}
    for label, rs in ragged.items():
        for r in rs:
            log("lab", label, lab.format_row(r))
    res = dict(launches=counts, rows=rows, ragged=ragged)
    log("lab_sweep", json.dumps(dict(launches=counts, rows=rows)))
    return res


# ---------------------------------------------------------------------------
# phase 6: one 7B-width block's gradients, kernels against plain attention
# ---------------------------------------------------------------------------

def check_block_grads(batch=4, size=512, text_len=128) -> dict:
    """Block 1 of f_lite_7b (self-attention mixing block 0's V through
    lambda_v, cross-attention), fp32 weights computing in bf16 at 512 px
    (64x64 latents, 1040 tokens): every parameter and input gradient through
    the kernels within 2e-2 (relative norm) of the plain attention's.

    The loss is sum(w * out), w a random tensor plus, at the same norm, the
    output's response to lambda_v (out at lambda_v + 0.1 minus out at
    lambda_v - 0.1). lambda_v's gradient is one number summing 10.6M
    products; with a random w alone it sums to near zero and its relative
    error is a ratio of two near-zero sums."""
    import numpy as np
    import torch

    import f_lite_tpu_torch.ops.attention as attn_mod
    from f_lite_tpu_torch.models.dit import DiTBlock, DiTConfig
    from f_lite_tpu_torch.ops.cuda import flash_attention as fa
    from f_lite_tpu_torch.ops.rope import rope_2d_freqs
    from f_lite_tpu_torch.utils.random_weights import randomize_

    cfg = DiTConfig.f_lite_7b(dtype=torch.bfloat16)
    with torch.device("cuda"):
        block = randomize_(DiTBlock(cfg, 1), seed=5)
    assert block.do_cross_attn and hasattr(block.self_attn, "lambda_v")
    g = torch.Generator("cuda").manual_seed(6)
    tokens = cfg.n_register_tokens + (size // 8 // cfg.patch_size) ** 2
    d, h, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    inputs = dict(x=rand(batch, tokens, d), context=rand(batch, text_len, d),
                  modulation=rand(batch, 9, d, scale=0.1),
                  v_first=rand(batch, h, tokens, hd))
    mask = torch.from_numpy(
        np.arange(text_len)[None, :] < np.asarray([77, 128, 77, 128])[:batch, None]
    ).cuda()
    rope = rope_2d_freqs(hd, size // 16, size // 16, base=cfg.rope_base,
                         n_register_tokens=cfg.n_register_tokens, device="cuda")
    weight = torch.randn((batch, tokens, d), generator=g, device="cuda")
    with torch.no_grad():
        lam = block.self_attn.lambda_v
        saved = lam.clone()
        outs = []
        for shift in (0.1, -0.1):
            lam.copy_(saved + shift)
            outs.append(block(inputs["x"], inputs["context"], mask,
                              inputs["modulation"], rope, inputs["v_first"])[0].float())
        lam.copy_(saved)
        response = outs[0] - outs[1]
        weight += response * (weight.norm() / response.norm())

    def grads(attention_fn):
        attn_mod.flash_attention = attention_fn
        try:
            block.zero_grad(set_to_none=True)
            leaves = {n: t.detach().clone().requires_grad_() for n, t in inputs.items()}
            out, _ = block(leaves["x"], leaves["context"], mask,
                           leaves["modulation"], rope, leaves["v_first"])
            (out.float() * weight).sum().backward()
            res = {f"param:{n}": p.grad.float().clone() for n, p in block.named_parameters()}
            res.update({f"input:{n}": t.grad.float() for n, t in leaves.items()})
            return res
        finally:
            attn_mod.flash_attention = fa.flash_attention

    reset_counts()
    kernel = grads(fa.flash_attention)
    counts = read_counts()
    plain = grads(fa.flash_attention_plain)
    n_norms = norm_calls(cfg, [1])
    if counts != launches(fwd=2, dq=2, dkv=2, rms_norm=n_norms, rms_norm_bwd=n_norms):
        raise AssertionError(f"block gradients: launches {counts}, expected 2 of each "
                             f"attention kernel and {n_norms} of each norm kernel")
    rel = {n: float((kernel[n] - plain[n]).norm() / plain[n].norm()) for n in plain}
    res = dict(config="f_lite_7b block 1", batch=batch, tokens=tokens,
               text_len=text_len, launches=counts, max_rel=max(rel.values()),
               rel=rel)
    log("block_grads", json.dumps(res))
    bad = {n: r for n, r in rel.items() if not r <= 2e-2}
    if bad:
        raise AssertionError(f"block gradients off by more than 2e-2: {bad}")
    del block, kernel, plain
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 6a: the int8 kernels against their plain versions
# ---------------------------------------------------------------------------

# (label, M, N, K): every projection of the int8 serving paths. 7B at 1024
# px: M = 2 x 4112 tokens (CFG batch), context_kv over 2 x 128 text rows;
# the fixture: M = 48 x 1040, context_kv over 48 x 32 rows.
INT8_SHAPES = [
    ("7b_qkv", 8224, 7680, 2560),
    ("7b_proj_q", 8224, 2560, 2560),
    ("7b_gate_up", 8224, 10240, 2560),
    ("7b_down", 8224, 2560, 10240),
    ("7b_context_kv", 256, 5120, 2560),
    ("fixture_qkv", 49920, 768, 256),
    ("fixture_proj_q", 49920, 256, 256),
    ("fixture_gate_up", 49920, 1024, 256),
    ("fixture_down", 49920, 256, 1024),
    ("fixture_context_kv", 1536, 512, 256),
]


def int8_bounds_ms(m, n, k, item) -> dict:
    """The least times on an H100 SXM: the quantize pass by bytes (x read
    once in `item` bytes a value, x8 and sx written once), the product by
    the larger of its int8 operations and its bytes (x8, w8, sx, scale read
    once, the output written once in `item` bytes)."""
    q_bytes = m * k * item + m * k + 4 * m
    g_ops = 2.0 * m * n * k
    g_bytes = m * k + n * k + 4 * (m + n) + m * n * item
    t_ops = g_ops / PEAK_FLOPS["int8"] * 1e3
    t_bytes = g_bytes / PEAK_BYTES * 1e3
    return dict(quantize=(q_bytes / PEAK_BYTES * 1e3, "bytes"),
                gemm=(max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"))


def library_int8_ms(x8, sx, w8, scale, out_dtype):
    """`torch._int_mm` (int32 out) plus the dequant as separate passes, a
    yardstick the port never calls; (that, _int_mm alone), or Nones where
    _int_mm refuses the shape."""
    import torch

    def lib():
        acc = torch._int_mm(x8, w8.T)
        return ((acc.float() * sx[:, None]) * scale).to(out_dtype)

    try:
        return time_ms(lib), time_ms(lambda: torch._int_mm(x8, w8.T))
    except RuntimeError as err:
        log(f"  _int_mm: none ({str(err).splitlines()[0][:120]})")
        return None, None


# K of the in-script fit of each of the product's designs: three at which
# the wrapper picks it (`int8_gemm.gemm_design`)
INT8_FIT_K = {"pingpong": (1024, 2048, 3072), "cooperative": (4096, 6144, 10240)}


def int8_k_fit(m=8224, n=7680) -> dict:
    """{design: fit}: each design's fixed cost a tile and cost a k-tile in
    its own tiles, with the fit's residual (`int8_tiles.fit_k_sweep`),
    fitted to its times through the wrapper at (m, n) and each K of
    INT8_FIT_K (where the tiles, not the output's bytes, set the time),
    random int8 operands."""
    import torch

    from f_lite_tpu_torch.ops.cuda import int8_gemm as ig
    from f_lite_tpu_torch.tools.int8_tiles import DESIGNS, fit_k_sweep

    gen = torch.Generator("cuda").manual_seed(16)
    fits = {}
    for design, ks in INT8_FIT_K.items():
        points = []
        for k in ks:
            if ig.gemm_design(k) != DESIGNS[design]:
                raise AssertionError(f"int8 fit: the wrapper does not pick {design} at K {k}")
            x8, w8 = (torch.randint(-127, 128, (rows, k), generator=gen, device="cuda",
                                    dtype=torch.int8) for rows in (m, n))
            sx = torch.rand((m,), generator=gen, device="cuda") + 0.5
            scale = torch.rand((n,), generator=gen, device="cuda") * 1e-3
            points.append((k, time_ms(lambda: ig.int8_gemm_dequant(x8, sx, w8, scale))))
            del x8, w8
        fits[design] = dict(fit_k_sweep(points, m, n, ig.num_sms(0),
                                        ig.BLOCK_N[DESIGNS[design]]),
                            m=m, n=n, ms_by_k={k: ms for k, ms in points})
        log("int8_k_fit", json.dumps(dict(design=design, **fits[design])))
    return fits


def check_int8() -> tuple[list[dict], list[dict], dict]:
    """Both int8 kernels against their plain versions, bit for bit, at
    every shape of INT8_SHAPES and of the product's grid edges
    (`int8_tiles.edge_shapes`): bf16 input (the serving path's) with and
    without bias, fp32 input, the int32 accumulators; a zero activation row
    and two zero weight rows in each. The INT8_SHAPES timed in bf16 beside
    the plain versions, `_int_mm` + dequant, bf16 F.linear and the bounds;
    then `int8_k_fit`. First, ptxas' lines (no spill, no C7512). Returns
    (timed rows, edge rows, fit)."""
    import torch
    import torch.nn.functional as F

    from f_lite_tpu_torch.ops.cuda import int8_gemm as ig
    from f_lite_tpu_torch.quant import quantize_weight
    from f_lite_tpu_torch.tools.int8_tiles import DESIGNS, edge_shapes

    ptxas_check(("int8_gemm",), ("int8_gemm_kernel", "quantize_rows_kernel"), "int8")
    rows, edge_rows = [], []
    edges = edge_shapes(ig.num_sms(0))
    gen = torch.Generator("cuda").manual_seed(15)
    for label, m, n, k in INT8_SHAPES + edges:
        w = torch.randn((n, k), generator=gen, device="cuda") * k**-0.5
        w[3] = 0.0
        w[-1] = 0.0
        w8, scale = quantize_weight(w.to(torch.bfloat16))
        bias = torch.randn((n,), generator=gen, device="cuda") * 0.1
        x32 = torch.randn((m, k), generator=gen, device="cuda") * 3
        x32[m // 2] = 0.0
        mismatches, max_err = [], 0.0
        for dtype in (torch.bfloat16, torch.float32):
            x = x32.to(dtype)
            x8, sx = ig.quantize_rows(x)
            acc = ig.int8_gemm_int32(x8, w8)
            ys = {b: ig.int8_gemm_dequant(x8, sx, w8, scale, bias if b else None, dtype)
                  for b in (False, True)}
            torch.cuda.synchronize()
            x8_want, sx_want = ig.quantize_rows_plain(x)
            checks = {"x8": (x8, x8_want), "sx": (sx, sx_want),
                      "acc": (acc, ig.int8_matmul_plain(x8, w8))}
            for b, y in ys.items():
                checks[f"y{'+bias' if b else ''}"] = (
                    y, ig.int8_linear_plain(x8, sx, w8, scale, bias if b else None, dtype))
            for what, (got, want) in checks.items():
                err = float((got.double() - want.double()).abs().max())
                max_err = max(max_err, err)
                if not torch.equal(got, want):
                    mismatches.append(f"{what} {dtype}: max abs diff {err}")
            del acc, ys, checks
        if mismatches:
            raise AssertionError(f"int8 {label}: kernels differ from plain: {mismatches}")
        if (label, m, n, k) in edges:  # checked, not timed
            edge_rows.append(dict(shape=label, m=m, n=n, k=k, max_abs_err=max_err))
            log("int8_edge", json.dumps(edge_rows[-1]))
            del w, w8, scale, bias, x32
            continue
        x = x32.to(torch.bfloat16)
        del x32
        x8, sx = ig.quantize_rows(x)
        w_bf16 = w.to(torch.bfloat16)
        lib_ms, int_mm_ms = library_int8_ms(x8, sx, w8, scale, torch.bfloat16)
        bounds = int8_bounds_ms(m, n, k, 2)
        row = dict(
            shape=label, m=m, n=n, k=k, max_abs_err=max_err,
            quantize_ms=time_ms(lambda: ig.quantize_rows(x)),
            quantize_plain_ms=time_ms(lambda: ig.quantize_rows_plain(x)),
            gemm_design=next(d for d, code in DESIGNS.items() if code == ig.gemm_design(k)),
            gemm_ms=time_ms(lambda: ig.int8_gemm_dequant(x8, sx, w8, scale)),
            gemm_plain_ms=time_ms(lambda: ig.int8_linear_plain(x8, sx, w8, scale)),
            library_ms=lib_ms, int_mm_ms=int_mm_ms,
            bf16_linear_ms=time_ms(lambda: F.linear(x, w_bf16)),
            quantize_bound_ms=bounds["quantize"][0], quantize_bound_by=bounds["quantize"][1],
            gemm_bound_ms=bounds["gemm"][0], gemm_bound_by=bounds["gemm"][1])
        log("int8", json.dumps(row))
        rows.append(row)
        del w, w8, scale, bias, x, x8, sx, w_bf16
    torch.cuda.empty_cache()
    fit = int8_k_fit()
    torch.cuda.empty_cache()
    return rows, edge_rows, fit


# ---------------------------------------------------------------------------
# phase 6b: the quantize kernel's entries for a row-parallel layer under tp
# ---------------------------------------------------------------------------

# (label, M, K): the row-parallel layers' K at tp 2 on the int8 serving
# paths (the 7B at 1024 px: proj 2560 / 2, down 10240 / 2; the fixture)
INT8_TP_SHAPES = [("7b_proj_tp2", 8224, 1280), ("7b_down_tp2", 8224, 5120),
                  ("fixture_proj_tp2", 49920, 128), ("fixture_down_tp2", 49920, 512)]


def check_int8_given() -> list[dict]:
    """Phase 6b: `row_amax` and `quantize_rows_given` against their plain
    versions bit for bit at INT8_TP_SHAPES (bf16 and fp32, a zero row, and
    for half the rows a given amax 1.5 times the row's own: another rank's
    larger one), the given entry fed the row's own amax bit-equal to the
    fused `quantize_rows`; bf16 timed beside the plain versions, the fused
    entry and the bounds (bytes: x read, x8 written, amax and sx read or
    written once)."""
    import torch

    from f_lite_tpu_torch.ops.cuda import int8_gemm as ig

    rows = []
    gen = torch.Generator("cuda").manual_seed(17)
    for label, m, k in INT8_TP_SHAPES:
        x32 = torch.randn((m, k), generator=gen, device="cuda") * 3
        x32[m // 2] = 0.0
        larger = torch.where(torch.arange(m, device="cuda") % 2 == 1, 1.5, 1.0)
        mismatches = []
        for dtype in (torch.bfloat16, torch.float32):
            x = x32.to(dtype)
            amax = ig.row_amax(x)
            given = ig.quantize_rows_given(x, amax)
            other = ig.quantize_rows_given(x, amax * larger)
            fused = ig.quantize_rows(x)
            torch.cuda.synchronize()
            checks = {"amax": (amax, ig.row_amax_plain(x))}
            for what, got, want in (
                    ("given", given, ig.quantize_rows_given_plain(x, amax)),
                    ("given_larger", other, ig.quantize_rows_given_plain(x, amax * larger)),
                    ("given_vs_fused", given, fused)):
                checks[f"{what}_x8"] = (got[0], want[0])
                checks[f"{what}_sx"] = (got[1], want[1])
            for what, (got, want) in checks.items():
                if not torch.equal(got, want):
                    err = float((got.double() - want.double()).abs().max())
                    mismatches.append(f"{what} {dtype}: max abs diff {err}")
        if mismatches:
            raise AssertionError(f"int8 given {label}: {mismatches}")
        x = x32.to(torch.bfloat16)
        del x32
        amax = ig.row_amax(x)
        row = dict(
            shape=label, m=m, k=k, max_abs_err=0.0,
            given_ms=time_ms(lambda: ig.quantize_rows_given(x, amax)),
            given_plain_ms=time_ms(lambda: ig.quantize_rows_given_plain(x, amax)),
            given_bound_ms=(m * k * 2 + m * k + 8 * m) / PEAK_BYTES * 1e3,
            amax_ms=time_ms(lambda: ig.row_amax(x)),
            amax_plain_ms=time_ms(lambda: ig.row_amax_plain(x)),
            amax_bound_ms=(m * k * 2 + 4 * m) / PEAK_BYTES * 1e3,
            fused_ms=time_ms(lambda: ig.quantize_rows(x)),
            fused_bound_ms=int8_bounds_ms(m, 8, k, 2)["quantize"][0], bound_by="bytes")
        log("int8_given", json.dumps(row))
        rows.append(row)
        del x, amax
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 6c: the RMSNorm kernel against its plain twins
# ---------------------------------------------------------------------------

# (label, rows, D, x dtype, weight dtype or None, layout): the 7B's and the
# 10B's pre-norms over the CFG pair at 1024 px (2 x 4112 rows), the 7B's
# QK-norm (2 x 10 heads x 4112 rows of 256), the training cell's pre-norms
# (batch 4 at 512 px, under fp32 weights), the T5-XXL tower's fp32 rows;
# then the layouts the DiT hands over at 1024 px: the cross-attention's q,
# a (B, L, H, D) product seen as (B, H, L, D), and its k, a slice of the
# (B, L, 2, H, D) key-value product over 128 text rows
NORM_SHAPES = [
    ("7b_norm", 8224, 2560, "bfloat16", "bfloat16", "dense"),
    ("10b_norm", 8224, 3072, "bfloat16", "bfloat16", "dense"),
    ("7b_qk", 82240, 256, "bfloat16", None, "dense"),
    ("train_norm", 4160, 2560, "bfloat16", "float32", "dense"),
    ("t5_tower", 128, 4096, "float32", "float32", "dense"),
    ("7b_cross_q", 82240, 256, "bfloat16", None, "transposed"),
    ("7b_cross_k", 2560, 256, "bfloat16", None, "kv_slice"),
]
NORM_REPS = 20
L2_BYTES = 50 * 2**20


def norm_input(rows, d, dtype, layout, gen):
    """x (3 N(0, 1)) of `rows` rows of `d` in `layout`: dense (rows, d); the
    cross-attention's q, (2, 10, rows / 20, d) transposed from (2, rows /
    20, 10, d); its k, head 0..9 of the key-value product's first half."""
    import torch

    if layout == "dense":
        shape = (rows, d)
    else:
        shape = (2, rows // 20, 2, 10, d) if layout == "kv_slice" else (2, rows // 20, 10, d)
    x = (3 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
    if layout == "transposed":
        return x.transpose(1, 2)
    return x.permute(2, 0, 3, 1, 4)[0] if layout == "kv_slice" else x


def graph_ms(run, copies: int) -> float:
    """Device ms of one `run(i)`: NORM_REPS calls over i = 0, 1, ... (mod
    `copies`, copies of the inputs that together exceed twice the L2, so
    each call reads its input from device memory) captured in a CUDA
    graph, its replay timed with CUDA events."""
    import torch

    for i in range(copies):
        run(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(NORM_REPS):
            run(i % copies)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / NORM_REPS


def check_rms_norm() -> list[dict]:
    """Phase 6c: `rms_norm` on the card (the kernel, forward and backward
    through its autograd Function) against `rms_norm_plain` and
    `rms_norm_bwd_plain` at NORM_SHAPES: y, dx and dw within
    `rms_norm.excess` (the card tests' bounds), y in the plain path's
    layout where x is dense and contiguous where the wrapper copies x, one
    launch of each kernel a call, dw bit-equal over two backward calls.
    The dense shapes timed (`graph_ms`): the kernel's forward and backward
    (dx, and dw where there is a weight), the plain path's (its backward:
    autograd's, the forward taken off) and `F.rms_norm`'s, the port's
    yardstick only, beside the byte bound: 2 N sizeof(x) a forward, 3 N
    sizeof(x) a backward, plus the weight."""
    import torch

    from f_lite_tpu_torch.ops import norms
    from f_lite_tpu_torch.ops.cuda import rms_norm as crn

    rows_out = []
    gen = torch.Generator("cuda").manual_seed(23)
    for label, n, d, dname, wname, layout in NORM_SHAPES:
        dtype = getattr(torch, dname)
        wdtype = None if wname is None else getattr(torch, wname)
        x = norm_input(n, d, dtype, layout, gen)
        w = None if wdtype is None else (1 + 0.1 * torch.randn(d, generator=gen,
                                                               device="cuda")).to(wdtype)
        g = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
        xa = x.detach().requires_grad_(True)
        wa = None if w is None else w.detach().requires_grad_(True)
        reset_counts()
        y = norms.rms_norm(xa, wa)
        y.backward(g)
        torch.cuda.synchronize()
        counts = read_counts()
        want = norms.rms_norm_plain(x, w)
        dx, dw = norms.rms_norm_bwd_plain(x, w, g)
        scale, dw_scale = crn.bwd_scales(x, w, g)
        excess = {"y": crn.excess(y, want, want.float().abs()),
                  "dx": crn.excess(xa.grad, dx, scale)}
        if w is not None:
            excess["dw"] = crn.excess(wa.grad, dw, dw_scale)
        dense = crn.dense_rows(x)
        layout_ok = (y.stride() == want.stride()) if dense else y.is_contiguous()
        _, r = crn.rms_norm_fwd(x, w, with_rstd=True)
        first, second = crn.rms_norm_bwd(x, w, r, g), crn.rms_norm_bwd(x, w, r, g)
        repeats = torch.equal(first[0], second[0]) and (
            w is None or torch.equal(first[1], second[1]))
        row = dict(shape=label, rows=n, D=d, dtype=dname, weight=wname, layout=layout,
                   x_strides=list(x.stride()), y_strides=list(y.stride()),
                   plain_y_strides=list(want.stride()), copied=not dense,
                   launches=counts, excess=excess,
                   max_abs_err=float((y.float() - want.float()).abs().max()),
                   dx_max_abs_err=float((xa.grad.float() - dx.float()).abs().max()),
                   bit_repeatable=repeats)
        del xa, wa, y, want, dx, dw, scale, dw_scale, first, second
        if layout == "dense":
            row.update(norm_times(x, w, g))
        log("rms_norm", json.dumps(row))
        rows_out.append(row)
        bad = [k for k, v in excess.items() if not v <= 0]
        if bad or not layout_ok or not repeats or counts != launches(rms_norm=1,
                                                                     rms_norm_bwd=1):
            raise AssertionError(f"rms_norm {label}: beyond the bound in {bad}, layout "
                                 f"{layout_ok}, repeats {repeats}, launches {counts}")
        del x, w, g, r
    torch.cuda.empty_cache()
    return rows_out


def norm_times(x, w, g) -> dict:
    """`check_rms_norm`'s times of one dense shape (`graph_ms`)."""
    import torch

    from f_lite_tpu_torch.ops.norms import rms_norm_plain
    from f_lite_tpu_torch.ops.cuda import rms_norm as crn

    d = x.shape[-1]
    nbytes = x.numel() * x.element_size()
    copies = max(2, -(-2 * L2_BYTES // nbytes))
    xs = [x] + [x.clone() for _ in range(copies - 1)]
    gs = [g] + [g.clone() for _ in range(copies - 1)]
    rs = [crn.rms_norm_fwd(xi, w, with_rstd=True)[1] for xi in xs]
    wbytes = 0 if w is None else d * w.element_size()

    def fwd_bwd(fn):
        xr = [xi.detach().requires_grad_(True) for xi in xs]
        wr = None if w is None else w.detach().requires_grad_(True)

        def run(i):
            y = fn(xr[i], wr)
            torch.autograd.grad(y, [xr[i]] + ([wr] if wr is not None else []), gs[i])
        return run

    def library(xi, wi):
        return torch.nn.functional.rms_norm(xi, (d,), wi, 1e-6)

    ms = dict(
        ms=graph_ms(lambda i: crn.rms_norm_fwd(xs[i], w), copies),
        bwd_ms=graph_ms(lambda i: crn.rms_norm_bwd(xs[i], w, rs[i], gs[i]), copies),
        plain_ms=graph_ms(lambda i: rms_norm_plain(xs[i], w), copies),
        plain_fwd_bwd_ms=graph_ms(fwd_bwd(rms_norm_plain), copies),
        library_ms=graph_ms(lambda i: library(xs[i], w), copies),
        library_fwd_bwd_ms=graph_ms(fwd_bwd(library), copies))
    ms["plain_bwd_ms"] = ms.pop("plain_fwd_bwd_ms") - ms["plain_ms"]
    ms["library_bwd_ms"] = ms.pop("library_fwd_bwd_ms") - ms["library_ms"]
    bound = (2 * nbytes + wbytes) / PEAK_BYTES * 1e3
    bwd_bound = (3 * nbytes + 2 * wbytes) / PEAK_BYTES * 1e3
    return dict(ms, bound_ms=bound, bwd_bound_ms=bwd_bound, bound_by="bytes",
                share_of_bound=bound / ms["ms"], bwd_share_of_bound=bwd_bound / ms["bwd_ms"],
                copies=copies)


# ---------------------------------------------------------------------------
# phase 12: the fixture's training recipe through the port's trainer
# ---------------------------------------------------------------------------

def draw_shape(size, rgb, shape, rng):
    """(size, size, 3) uint8: one shape on the gray background, drawn like
    tools/make_shapes_dataset.py (radius 30-45% of the image, jittered
    centre) with a pixel-centre rasteriser of its own."""
    import numpy as np

    r = size * rng.uniform(0.30, 0.45)
    margin = r + 1
    cx = rng.uniform(margin, size - margin)
    cy = rng.uniform(margin, size - margin)
    y, x = np.mgrid[0:size, 0:size] + 0.5
    if shape == "circle":
        inside = (x - cx) ** 2 + (y - cy) ** 2 <= r * r
    elif shape == "square":
        inside = (np.abs(x - cx) <= r) & (np.abs(y - cy) <= r)
    else:  # triangle, apex up
        inside = (y >= cy - r) & (y <= cy + r) & (np.abs(x - cx) <= (y - (cy - r)) / 2)
    img = np.empty((size, size, 3), np.uint8)
    img[:] = BACKGROUND
    img[inside] = rgb
    return img


def shapes_images(per_class=128, size=64, seed=0):
    """(item id, caption, uint8 image) of the shapes dataset, class by
    class, each image drawn from one RandomState(seed) in turn."""
    import numpy as np

    rng = np.random.RandomState(seed)
    for color, rgb in COLORS.items():
        for shape in SHAPES:
            for i in range(per_class):
                yield (f"{color}/{shape}/{i}", f"a {color} {shape}",
                       draw_shape(size, rgb, shape, rng))


def write_shapes_cache(root: Path, per_class=128, size=64, seed=0) -> int:
    """The shapes dataset as a precomputed cache: pixels in [-1, 1] NHWC as
    the latents, and each caption's ZeroTextEncoder(64, seq_len=32)
    embedding (all 32 rows real, as on the online path)."""
    import numpy as np

    from f_lite_tpu_torch.data.precomputed import PrecomputedCacheWriter
    from f_lite_tpu_torch.text.encoder import ZeroTextEncoder

    enc = ZeroTextEncoder(64, seq_len=32)
    writer = PrecomputedCacheWriter(root)
    embeds = {}
    for item_id, caption, img in shapes_images(per_class, size, seed):
        if caption not in embeds:
            emb, mask = enc.encode([caption])
            embeds[caption] = emb[0][mask[0]]
        writer.add(item_id, caption, img.astype(np.float32) / 127.5 - 1.0,
                   embeds[caption])
    writer.finalize()
    return len(writer.entries)


class StepLog(logging.Handler):
    """Prints the trainer's log lines and keeps the `step N loss X` ones."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.losses = {}

    def emit(self, record):
        msg = record.getMessage()
        log(f"  train: {msg}")
        parts = msg.split()
        if parts[:1] == ["step"] and parts[2:3] == ["loss"]:
            self.losses[int(parts[1])] = float(parts[3])


def run_training(argv, on_step) -> tuple:
    """`f_lite_tpu_torch.train` with `argv`, its log lines printed: (result
    dict, {step: logged loss})."""
    from f_lite_tpu_torch.train.trainer import parse_args, train

    handler = StepLog()
    train_log = logging.getLogger("f_lite_tpu_torch.train")
    train_log.setLevel(logging.INFO)
    train_log.addHandler(handler)
    try:
        result = train(parse_args(argv), on_step=on_step)
    finally:
        train_log.removeHandler(handler)
    return result, handler.losses


class StepWatch:
    """An `on_step` callback: per-step host time after a synchronise, the
    launch counts of each step, and a torch.profiler window over steps
    (start, stop]."""

    def __init__(self, profile_window=None, check=None):
        self.times, self.per_step = [], []
        self.window = profile_window
        self.check = check
        self.prof = None
        self.profile = None
        self.state = None
        self._last = None
        self._t = None

    def begin(self):
        """Call just before the run: the counts and the clock start here."""
        import torch

        torch.cuda.synchronize()
        self._last = read_counts()
        self._t = time.perf_counter()

    def __call__(self, state, metrics):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        now = time.perf_counter()
        self.times.append(now - self._t)
        self._t = now
        counts = read_counts()
        self.per_step.append({k: counts[k] - self._last[k] for k in counts})
        self._last = counts
        self.state = state
        if self.check is not None:
            self.check(state.step, metrics)
        if self.window and state.step == self.window[0]:
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
            self._t_prof = time.perf_counter()
        elif self.window and state.step == self.window[1]:
            self.prof.__exit__(None, None, None)
            self.profile = profile_summary(
                self.prof, (now - self._t_prof) * 1e3,
                label=f"step_profile (steps {self.window[0] + 1}-{self.window[1]})")
            self.prof = None
            self._t = time.perf_counter()  # the profiler's own teardown


def fixture_argv(cache: Path, out: Path, steps: int) -> list:
    """The recipe of artifacts/fixture_run/train.log on the shapes cache."""
    cfg = json.loads((FIXTURE / "dit" / "config.json").read_text())
    return ["--device", "cuda", "--use_precomputed_data",
            "--precomputed_data_dir", str(cache), "--pixel_space",
            "--model_width", str(cfg["hidden_size"]),
            "--model_depth", str(cfg["depth"]),
            "--model_head_dim", str(cfg["hidden_size"] // cfg["num_heads"]),
            "--cross_attn_input_size", str(cfg["cross_attn_input_size"]),
            "--residual_v", "--train_batch_size", "32",
            "--learning_rate", "8e-4", "--num_warmup_steps", "200",
            "--lr_scheduler", "constant", "--max_steps", str(steps),
            "--num_epochs", "100", "--mixed_precision", "bf16",
            "--log_every", "10", "--seed", "0", "--output_dir", str(out),
            # what these options gave before they were ported: the card
            # has no tensorboardX, and the cache no sample prompts
            "--report_to", "none", "--sample_every", "0", "--eval_every", "0"]


def run_fixture_training(tmp: Path, steps=300) -> dict:
    """The fixture recipe of artifacts/fixture_run/train.log from scratch."""
    import torch

    from f_lite_tpu_torch.models.dit import DiT
    from f_lite_tpu_torch.pipeline import FLitePipeline

    cfg = json.loads((FIXTURE / "dit" / "config.json").read_text())
    cache = tmp / "shapes_cache"
    t0 = time.perf_counter()
    n_items = write_shapes_cache(cache)
    cache_s = time.perf_counter() - t0
    out = tmp / "fixture_train"
    argv = fixture_argv(cache, out, steps) + ["--export_pipeline"]
    per_step = launches(**train_step_launches(fixture_config()))
    watch = StepWatch(profile_window=(100, 103))
    reset_counts()
    watch.begin()
    result, losses = run_training(argv, watch)
    counts = read_counts()
    late = [losses[s] for s in range(260, steps + 1, 10)]
    step_s = statistics.median(watch.times[2:])
    res = dict(items=n_items, cache_write_s=cache_s, steps=result["global_step"],
               logged_losses=losses, mean_loss_260_300=statistics.mean(late),
               jax_mean_loss_260_300=0.073, s_per_step=step_s,
               wall_s=result["wall_s"], launches=counts,
               per_step_expected=per_step,
               idle_share=watch.profile["idle_share"])
    log("fixture_train", json.dumps(res))
    if result["global_step"] != steps:
        raise AssertionError(f"fixture training ran {result['global_step']} steps")
    bad = [i + 1 for i, c in enumerate(watch.per_step) if c != per_step]
    if bad:
        raise AssertionError(f"fixture training: launch counts off at steps {bad[:5]}")
    if not res["mean_loss_260_300"] <= 0.15:
        raise AssertionError(f"fixture training: mean loss {res['mean_loss_260_300']} > 0.15")

    # the export reloads with the same DiT (both in fp32 on one batch)
    trained = watch.state.model
    trained.config = dataclasses.replace(trained.config, dtype=None)
    trained.eval()
    pipe = FLitePipeline.from_pretrained(out / "pipeline", dtype=torch.float32)
    g = torch.Generator("cuda").manual_seed(9)
    x = torch.randn((4, 64, 64, 3), generator=g, device="cuda")
    ctx = torch.randn((4, 32, cfg["cross_attn_input_size"]), generator=g, device="cuda") * 0.02
    t = torch.rand(4, generator=g, device="cuda")
    with torch.no_grad():
        want = trained(x, ctx, None, t)
        got = pipe.dit(x, ctx, None, t)
    diff = float((got - want).abs().max())
    res["export_max_abs_diff"] = diff
    log("fixture_export", json.dumps(dict(max_abs_diff=diff,
                                          out_abs_max=float(want.abs().max()))))
    if not isinstance(pipe.dit, DiT) or diff > 1e-5:
        raise AssertionError(f"exported DiT differs from the trained one by {diff}")
    del pipe, trained, watch
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 12b-12c: resume and preemption; fine-tuning the fixture
# ---------------------------------------------------------------------------

def run_counted(argv, check=None) -> tuple:
    """`run_training` with a `StepWatch`: (result, logged losses, watch,
    every step's loss as a float)."""
    losses = []

    def record(step, metrics):
        losses.append(float(metrics["loss"]))
        if check is not None:
            check(step, metrics)

    watch = StepWatch(check=record)
    watch.begin()
    result, logged = run_training(argv, watch)
    return result, logged, watch, losses


def checkpoint_tensors(out: Path, step: int) -> dict:
    from f_lite_tpu_torch.train.checkpoint import Checkpointer

    return Checkpointer(out).load(step)[1]


def run_fixture_resume(tmp: Path, steps=40) -> dict:
    """Phase 12b: the fixture recipe (phase 12's cache), `steps` straight
    against `steps` / 2, then `--resume_from_checkpoint latest` to `steps`,
    both with `--async_checkpoint` saves at `steps` / 2: every step's loss
    and the final checkpoint's tensors bit-equal, exactly 12 launches of
    each kernel a step. Then SIGTERM to a trainer subprocess (started
    first, training beside the runs here) once it has logged a step: exit
    0, the stop logged (`preempted_at`) with a checkpoint at its step, and
    a resume 10 steps on."""
    import signal

    cache = tmp / "shapes_cache"
    out = tmp / "sigterm"
    log_path = tmp / "sigterm.log"
    t0 = time.perf_counter()
    with open(log_path, "w") as lf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "f_lite_tpu_torch.train",
             *fixture_argv(cache, out, 100000), "--checkpointing_steps", "0",
             "--log_every", "5"], stdout=lf, stderr=subprocess.STDOUT, cwd=ROOT)
    try:
        expected = launches(**train_step_launches(fixture_config()))
        half = steps // 2
        extra = ["--checkpointing_steps", str(half), "--async_checkpoint"]
        reset_counts()
        _, _, straight_watch, straight = run_counted(
            fixture_argv(cache, tmp / "resume_a", steps) + extra)
        straight_counts = read_counts()
        reset_counts()
        _, _, w1, first = run_counted(fixture_argv(cache, tmp / "resume_b", half) + extra)
        _, _, w2, rest = run_counted(fixture_argv(cache, tmp / "resume_b", steps) + extra
                                     + ["--resume_from_checkpoint", "latest"])
        resumed_counts = read_counts()
        want = checkpoint_tensors(tmp / "resume_a", steps)
        got = checkpoint_tensors(tmp / "resume_b", steps)
        unequal = [k for k in want if not torch_equal(want[k], got.get(k))]
        per_step = straight_watch.per_step + w1.per_step + w2.per_step
        res = dict(steps=steps, resumed_at=half, losses_equal=straight == first + rest,
                   tensors=len(want), tensors_unequal=unequal[:5],
                   launches_straight=straight_counts, launches_resumed=resumed_counts,
                   s_per_step=statistics.median(straight_watch.times[2:]))
        log("fixture_resume", json.dumps(res))
        res["straight_losses"] = straight
        if not res["losses_equal"] or len(straight) != steps:
            raise AssertionError(f"fixture resume: losses {straight} against {first + rest}")
        if unequal or set(want) != set(got):
            raise AssertionError(f"fixture resume: checkpoint tensors differ: {unequal[:5]}")
        if any(c != expected for c in per_step):
            raise AssertionError(f"fixture resume: launch counts off: {per_step[:3]}")

        # preemption: SIGTERM once the subprocess has logged a step
        while " loss " not in log_path.read_text():
            if proc.poll() is not None or time.perf_counter() - t0 > 300:
                raise AssertionError("sigterm: no step logged:\n" + log_path.read_text())
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=300)
        text = log_path.read_text()
        if rc != 0 or "stopping on signal" not in text:
            raise AssertionError(f"sigterm: exit {rc}\n{text[-3000:]}")
        stopped = int(text.split("stopping on signal")[1].split("at step")[1].split(";")[0])
        from f_lite_tpu_torch.train.checkpoint import Checkpointer

        latest = Checkpointer(out).latest
        reset_counts()
        result, _, watch, _ = run_counted(fixture_argv(cache, out, stopped + 10)
                                          + ["--resume_from_checkpoint", "latest"])
        res["sigterm"] = dict(exit_code=rc, preempted_at=stopped, latest_checkpoint=latest,
                              resumed_to=result["global_step"], launches=read_counts(),
                              subprocess_s=time.perf_counter() - t0)
        log("fixture_sigterm", json.dumps(res["sigterm"]))
        if latest != stopped or result["global_step"] != stopped + 10 \
                or "preempted_at" in result:
            raise AssertionError(f"sigterm: {res['sigterm']}")
        if any(c != expected for c in watch.per_step):
            raise AssertionError(f"sigterm resume: launch counts off: {watch.per_step[:3]}")
        return res
    finally:
        stop_process(proc)


def torch_equal(a, b) -> bool:
    import torch

    return b is not None and a.dtype == b.dtype and torch.equal(a, b)


def run_fixture_finetune(tmp: Path, steps=60, n_requests=4) -> dict:
    """Phase 12c: fine-tune the committed fixture (`--pretrained_model_path`)
    with a rank-4 LoRA, EMA 0.99, accumulation 2, bs_rampup 20 and sequence
    dropout 0.5 (528 self-attention tokens) on phase 12's cache, `steps`
    micro-steps: finite losses, exactly 12 launches of each kernel a
    micro-step; the exported pipeline (EMA factors merged) scores phase
    7's requests at both_acc >= 0.95."""
    import torch

    out = tmp / "finetune"
    finite = []
    argv = fixture_argv(tmp / "shapes_cache", out, steps) + [
        "--pretrained_model_path", str(FIXTURE), "--use_lora", "--lora_rank", "4",
        "--lora_alpha", "4", "--ema_decay", "0.99", "--gradient_accumulation_steps", "2",
        "--bs_rampup", "20", "--sequence_dropout", "0.5", "--learning_rate", "1e-4",
        "--num_warmup_steps", "5", "--export_pipeline"]
    reset_counts()
    result, logged, watch, losses = run_counted(
        argv, check=lambda step, m: finite.append(math.isfinite(float(m["loss"]))))
    counts = read_counts()
    expected = launches(**train_step_launches(fixture_config(), lora=True))
    pipe, embeds, mask, classes = load_fixture(path=out / "pipeline")
    reset_counts()
    images, _ = fixture_requests(pipe, len(embeds), n_requests, prompt_embeds=embeds,
                                 context_mask=mask, num_inference_steps=30,
                                 guidance_scale=6.0)
    serve_counts = read_counts()
    res = dict(micro_steps=result["global_step"], updates=watch.state.optimizer.count,
               logged_losses=logged, all_finite=all(finite), launches=counts,
               per_micro_step=watch.per_step[0], per_micro_step_expected=expected,
               s_per_micro_step=statistics.median(watch.times[2:]),
               both_acc=both_acc(images, classes), serving_launches=serve_counts,
               checkpoints=result["checkpoints"])
    log("fixture_finetune", json.dumps(res))
    if result["global_step"] != steps or not all(finite) or len(finite) != steps:
        raise AssertionError(f"fixture fine-tune: {result['global_step']} steps, finite {finite}")
    if any(c != expected for c in watch.per_step):
        raise AssertionError(f"fixture fine-tune: launch counts off: {watch.per_step[:3]}")
    if serve_counts != dit_launches(fixture_config(), n_requests * 30):
        raise AssertionError(f"fixture fine-tune export: launches {serve_counts}")
    if res["both_acc"] < 0.95:
        raise AssertionError(f"fixture fine-tune: both_acc {res['both_acc']} < 0.95")
    del pipe, watch
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 12d-12f: the fixture's recipe on the online image path
# ---------------------------------------------------------------------------

SAMPLE_CAPTIONS = ("a red circle", "a green square", "a blue triangle",
                   "a yellow circle")


def write_shapes_table(root: Path, per_class=128, size=64, seed=0, holdout=64) -> dict:
    """The shapes images of phase 12's cache as PNG files (the port's
    writer) with a JSON table (`media_path`, `captions`, `width`,
    `height`), its rows class-interleaved so the first 2048 (the
    dataset's length, a multiple of 2048) hold every class; `holdout`
    more images (seed + 1) in a validation table; a prompts file of 4
    captions. {"train", "val", "prompts": paths, "items": n, "write_s"}."""
    from f_lite_tpu_torch.utils.image import png_bytes_with_metadata

    t0 = time.perf_counter()
    (root / "images").mkdir(parents=True, exist_ok=True)

    def rows_of(n, draw_seed, prefix):
        rows = []
        for k, (item_id, caption, img) in enumerate(shapes_images(n, size, draw_seed)):
            f = root / "images" / f"{prefix}{item_id.replace('/', '_')}.png"
            f.write_bytes(png_bytes_with_metadata(img))
            rows.append((k % n, k // n, {"media_path": str(f), "captions": [caption],
                                         "width": size, "height": size}))
        return [r for _, _, r in sorted(rows, key=lambda r: r[:2])]

    train = rows_of(per_class, seed, "")
    n_classes = len(COLORS) * len(SHAPES)
    val = rows_of(-(-holdout // n_classes), seed + 1, "val_")[:holdout]
    out = {"train": root / "train.json", "val": root / "val.json",
           "prompts": root / "prompts.txt"}
    out["train"].write_text(json.dumps(train))
    out["val"].write_text(json.dumps(val))
    out["prompts"].write_text("\n".join(SAMPLE_CAPTIONS) + "\n")
    return {**out, "items": len(train), "val_items": len(val),
            "write_s": time.perf_counter() - t0}


def online_argv(argv: list, table: Path, *, base_url="file://", resolution=64,
                center_crop=True) -> list:
    """`argv` (a precomputed recipe) moved to the online path over `table`."""
    i = argv.index("--use_precomputed_data")
    argv = argv[:i] + argv[i + 3:]  # with --precomputed_data_dir <dir>
    return argv + ["--train_data_path", str(table), "--root_dir_type", "json",
                   "--base_url", base_url, "--resolution", str(resolution),
                   "--text_encoder_type", "zero", "--num_workers", "4",
                   *(["--center_crop"] if center_crop else [])]


def fixture_online_argv(table: Path, out: Path, steps: int) -> list:
    """Phase 12's recipe on the online path: the PNG table, ZeroTextEncoder
    (64, 32) (the cache's context), caption dropout 0.01 (the precomputed
    path's), 4 loader threads."""
    return online_argv(fixture_argv(Path("unused"), out, steps), table) + [
        "--uncond_prob", "0.01"]


class CountedCall:
    """Wraps a trainer function: the launch counts of each call, taken out
    of the StepWatch's next step (they run between two steps)."""

    def __init__(self, module, name, watch):
        self.module, self.name, self.watch = module, name, watch
        self.fn = getattr(module, name)
        self.calls = []

    def __enter__(self):
        def counted(*args, **kwargs):
            before = read_counts()
            out = self.fn(*args, **kwargs)
            after = read_counts()
            delta = {k: after[k] - before[k] for k in after}
            self.calls.append(delta)
            self.watch._last = {k: self.watch._last[k] + delta[k] for k in delta}
            return out

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def trace_summary(path: Path) -> dict:
    """The flash kernels named in a Chrome trace, and the device's busy
    share between its first and last kernel."""
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    names = " ".join(e.get("name", "") for e in kernels).lower()
    span = (max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)
            if kernels else 0.0)
    busy = sum(e["dur"] for e in kernels)
    return dict(kernels=len(kernels),
                names={k: k in names for k in ("flash_fwd", "flash_bwd_dq",
                                               "flash_bwd_dkv")},
                span_ms=span / 1e3, busy_ms=busy / 1e3,
                idle_share=(1.0 - busy / span) if span else None)


def grid_tiles(grid, n, size=64, nrow=3, padding=2):
    """The n tiles of `make_image_grid`'s grid, as float images in [-1, 1]."""
    tiles = []
    for i in range(n):
        r, c = divmod(i, nrow)
        y, x = r * (size + padding), c * (size + padding)
        tiles.append(grid[y:y + size, x:x + size].astype("float32") / 127.5 - 1.0)
    return tiles


def run_fixture_online(tmp: Path, phase12: dict, steps=300, profile=(10, 12)) -> dict:
    """Phase 12d: the fixture's recipe from scratch on the online path
    (PNG files, thread workers), with validation every 100 steps (2
    held-out batches), the sample grid at the last step and a profile of
    steps 11-12: mean logged loss over steps 260-300 <= 0.15; exactly 12
    launches of each kernel a step, 12 forward and no backward launches an
    eval batch, 50 * 12 forward launches a grid; val/loss finite; the
    grid read back (its tiles' both_acc printed); the trace names the
    flash kernels; loader wait ms a step and s/step beside phase 12's."""
    import torch

    from f_lite_tpu_torch.train import trainer
    from f_lite_tpu_torch.utils.image import read_png

    tables = write_shapes_table(tmp / "shapes_png")
    out = tmp / "fixture_online"
    eval_batch = 32
    argv = fixture_online_argv(tables["train"], out, steps) + [
        "--val_data_path", str(tables["val"]), "--eval_every", "100",
        "--eval_batch_size", str(eval_batch), "--sample_every", str(steps),
        "--sample_prompts_file", str(tables["prompts"]),
        "--profile_steps", f"{profile[0]},{profile[1]}"]
    cfg = fixture_config()
    per_step = launches(**train_step_launches(cfg))
    n_eval_batches = tables["val_items"] // eval_batch
    watch = StepWatch()
    reset_counts()
    watch.begin()
    with CountedCall(trainer, "evaluate", watch) as ev, \
            CountedCall(trainer, "sample_images", watch) as smp:
        result, losses = run_training(argv, watch)
    counts = read_counts()
    vals = result.get("val/loss")
    grid = read_png((out / "samples" / f"step_{steps}.png").read_bytes())
    tiles = grid_tiles(grid, len(SAMPLE_CAPTIONS))
    hits = [classify(t) == tuple(c.split()[1:]) for t, c in zip(tiles, SAMPLE_CAPTIONS)]
    trace = trace_summary(out / "profile" / f"steps_{profile[0]}_{profile[1]}.json")
    late = [losses[s] for s in range(260, steps + 1, 10)]
    res = dict(items=tables["items"], table_write_s=tables["write_s"],
               steps=result["global_step"], logged_losses=losses,
               mean_loss_260_300=statistics.mean(late),
               phase_12_mean_loss_260_300=phase12["mean_loss_260_300"],
               s_per_step=statistics.median(watch.times[2:]),
               phase_12_s_per_step=phase12["s_per_step"],
               loader_wait_ms_per_step=result["loader_wait_s"] / steps * 1e3,
               val_loss=vals, evals=ev.calls, sample_grids=smp.calls,
               sample_both_acc=sum(hits) / len(hits), grid_shape=list(grid.shape),
               trace=trace, launches=counts, per_step=watch.per_step[0])
    log("fixture_online", json.dumps(res))
    if result["global_step"] != steps:
        raise AssertionError(f"fixture online: {result['global_step']} steps")
    bad = [i + 1 for i, c in enumerate(watch.per_step) if c != per_step]
    if bad:
        raise AssertionError(f"fixture online: launch counts off at steps {bad[:5]}: "
                             f"{watch.per_step[bad[0] - 1]}")
    if not res["mean_loss_260_300"] <= 0.15:
        raise AssertionError(f"fixture online: mean loss {res['mean_loss_260_300']} > 0.15")
    if len(ev.calls) != steps // 100 or any(
            c != dit_launches(cfg, n_eval_batches) for c in ev.calls):
        raise AssertionError(f"fixture online eval: launches {ev.calls}")
    if vals is None or not math.isfinite(vals):
        raise AssertionError(f"fixture online: val/loss {vals}")
    if smp.calls != [dit_launches(cfg, 50)]:
        raise AssertionError(f"fixture online sample grid: launches {smp.calls}")
    if grid.shape != (2 * 64 + 2, 3 * 64 + 4, 3):
        raise AssertionError(f"fixture online sample grid: shape {grid.shape}")
    if not all(trace["names"].values()):
        raise AssertionError(f"fixture online: the trace lacks a kernel: {trace}")
    del watch
    torch.cuda.empty_cache()
    res["tables"] = {k: str(v) for k, v in tables.items() if isinstance(v, Path)}
    return res


def run_fixture_online_resume(tmp: Path, tables: dict, steps=40, nan_steps=5) -> dict:
    """Phase 12e: phase 12d's recipe with `--random_flip` (the PNG table:
    the dummy backend's pixels change from process to process), `steps`
    straight against `steps` / 2 + `--resume_from_checkpoint latest`: every
    loss and the final checkpoint's tensors bit-equal, exactly 12
    launches of each kernel a step. Then `nan_steps` with `--debug_nans`
    against the same steps without: losses bit-equal."""
    import torch

    table = Path(tables["train"])
    expected = launches(**train_step_launches(fixture_config()))
    half = steps // 2
    extra = ["--random_flip", "--checkpointing_steps", str(half)]
    reset_counts()
    _, _, w0, straight = run_counted(
        fixture_online_argv(table, tmp / "online_resume_a", steps) + extra)
    _, _, w1, first = run_counted(
        fixture_online_argv(table, tmp / "online_resume_b", half) + extra)
    _, _, w2, rest = run_counted(
        fixture_online_argv(table, tmp / "online_resume_b", steps) + extra
        + ["--resume_from_checkpoint", "latest"])
    want = checkpoint_tensors(tmp / "online_resume_a", steps)
    got = checkpoint_tensors(tmp / "online_resume_b", steps)
    unequal = [k for k in want if not torch_equal(want[k], got.get(k))]
    _, _, w3, plain = run_counted(
        fixture_online_argv(table, tmp / "online_nan_a", nan_steps))
    _, _, w4, checked = run_counted(
        fixture_online_argv(table, tmp / "online_nan_b", nan_steps) + ["--debug_nans"])
    per_step = w0.per_step + w1.per_step + w2.per_step + w3.per_step + w4.per_step
    res = dict(steps=steps, resumed_at=half, losses_equal=straight == first + rest,
               tensors=len(want), tensors_unequal=unequal[:5],
               debug_nans_losses_equal=plain == checked, debug_nans_losses=checked,
               s_per_step=statistics.median(w0.times[2:]),
               s_per_step_debug_nans=statistics.median(w4.times[1:]),
               launches=read_counts())
    log("fixture_online_resume", json.dumps(res))
    if not res["losses_equal"] or len(straight) != steps:
        raise AssertionError(f"online resume: losses {straight} against {first + rest}")
    if unequal or set(want) != set(got):
        raise AssertionError(f"online resume: checkpoint tensors differ: {unequal[:5]}")
    if not res["debug_nans_losses_equal"] or len(plain) != nan_steps:
        raise AssertionError(f"--debug_nans: losses {checked} against {plain}")
    if any(c != expected for c in per_step):
        raise AssertionError(f"online resume: launch counts off: {per_step[:3]}")
    return res


def run_fixture_buckets(tmp: Path, steps=20, batch=8) -> dict:
    """Phase 12f: the fixture's width from scratch on a dummy-backed table
    of three declared aspects (64x128, 80x112, 96x96 px at resolution 64
    without --center_crop), `--use_resolution_buckets`, batch 8: every
    batch of one shape before collation, the forward kernel seeing 2064,
    2256 and 2320 self tokens (self: L queries and keys; cross: L queries,
    32 keys), one L a step, and exactly 12 launches of each kernel a
    step."""
    import torch

    from f_lite_tpu_torch.data.dataset import ImageDataset
    from f_lite_tpu_torch.ops.cuda import flash_attention as fa

    aspects = [(64, 128), (80, 112), (96, 96)]
    rows = [{"media_path": f"dummy://shapes/{i}.png",
             "captions": [f"a {list(COLORS)[i % 8]} {SHAPES[i % 3]}"],
             "width": aspects[i % 3][0], "height": aspects[i % 3][1]}
            for i in range(3 * 8 * batch)]
    table = tmp / "buckets.json"
    table.write_text(json.dumps(rows))
    argv = online_argv(fixture_argv(Path("unused"), tmp / "buckets", steps), table,
                       base_url="dummy://", center_crop=False) + [
        "--use_resolution_buckets", "--train_batch_size", str(batch)]
    expected = launches(**train_step_launches(fixture_config()))
    seen, step_lengths, mixed = [], [], []
    fwd_kernel, collate = fa._forward_kernel, ImageDataset.collate_fn

    def recording_kernel(q, k, *args, **kwargs):
        seen.append((int(q.shape[2]), int(k.shape[2])))
        return fwd_kernel(q, k, *args, **kwargs)

    def recording_collate(self, items):
        mixed.append(len({it["image"].shape for it in items}) > 1)
        return collate(self, items)

    def check(step, metrics):
        step_lengths.append(sorted(set(seen)))
        seen.clear()

    fa._forward_kernel, ImageDataset.collate_fn = recording_kernel, recording_collate
    try:
        reset_counts()
        result, _, watch, losses = run_counted(argv, check=check)
    finally:
        fa._forward_kernel, ImageDataset.collate_fn = fwd_kernel, collate
    self_lengths = sorted({ls[-1][0] for ls in step_lengths})
    res = dict(steps=result["global_step"], batches_mixed=sum(mixed),
               batches_collated=len(mixed), self_lengths=self_lengths,
               lengths_per_step=step_lengths, all_finite=all(map(math.isfinite, losses)),
               s_per_step=statistics.median(watch.times[2:]), launches=read_counts(),
               per_step=watch.per_step[0])
    log("fixture_buckets", json.dumps(res))
    if result["global_step"] != steps or not res["all_finite"]:
        raise AssertionError(f"buckets: {res}")
    if any(mixed):
        raise AssertionError(f"buckets: {sum(mixed)} batches of mixed shapes")
    if self_lengths != [2064, 2256, 2320] or any(
            ls != [(ls[0][0], 32), (ls[0][0], ls[0][0])] for ls in step_lengths):
        raise AssertionError(f"buckets: the kernels saw {step_lengths}")
    if any(c != expected for c in watch.per_step):
        raise AssertionError(f"buckets: launch counts off: {watch.per_step[:3]}")
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 13: f_lite_7b_width_d20_train512
# ---------------------------------------------------------------------------

def write_7b_cache(tmp: Path, batch=4):
    """512 px latents (64x64x16) and text embeddings of 77 and 128 real rows
    (padded to 128), seeded; the cache dir."""
    import numpy as np

    from f_lite_tpu_torch.data.precomputed import PrecomputedCacheWriter
    from f_lite_tpu_torch.models.dit import DiTConfig

    cfg = DiTConfig.f_lite_7b()
    cache = tmp / "7b_cache"
    if not cache.exists():
        writer = PrecomputedCacheWriter(cache)
        rs = np.random.RandomState(10)
        for i, n_text in enumerate((77, 128, 77, 128)[:batch]):
            writer.add(f"item{i}", f"prompt {i}",
                       rs.randn(64, 64, cfg.in_channels).astype(np.float32),
                       (rs.randn(n_text, cfg.cross_attn_input_size) * 0.02).astype(np.float32))
        writer.finalize()
    return cache


def argv_7b(tmp: Path, out: Path, steps: int, batch=4, depth=20, cache=None) -> list:
    """The trainer's arguments of `f_lite_7b_width_d20_train512` at `depth`,
    from `write_7b_cache` or another precomputed `cache`."""
    from f_lite_tpu_torch.models.dit import DiTConfig

    cfg = DiTConfig.f_lite_7b(depth=depth)
    return ["--device", "cuda", "--use_precomputed_data",
            "--precomputed_data_dir", str(cache or write_7b_cache(tmp, batch)),
            "--model_width", str(cfg.hidden_size), "--model_depth", str(depth),
            "--model_head_dim", str(cfg.head_dim),
            "--in_channels", str(cfg.in_channels),
            "--cross_attn_input_size", str(cfg.cross_attn_input_size),
            "--residual_v", "--train_batch_size", str(batch),
            "--num_epochs", str(steps), "--max_steps", str(steps),
            "--learning_rate", "1e-4", "--lr_scheduler", "constant",
            "--num_warmup_steps", "2", "--max_grad_norm", "1.0",
            "--mixed_precision", "bf16", "--gradient_checkpointing",
            "--log_every", "1", "--seed", "0", "--output_dir", str(out),
            "--report_to", "none", "--sample_every", "0", "--eval_every", "0"]


def train_7b_launches(depth: int, lora=False) -> dict:
    """Launches of the attention and norm kernels in one 7B-width training
    step at `depth`, checkpointing from block 8 (`train_step_launches`)."""
    from f_lite_tpu_torch.models.dit import DiTConfig

    cfg = DiTConfig.f_lite_7b(depth=depth, gradient_checkpoint=True,
                              gradient_checkpoint_from=8)
    return train_step_launches(cfg, lora=lora)


# depths cut to keep the script inside its time (PERF.md §4): 13c's two
# full-state saves (an async one, then the final one beside it) stay on the
# card machine's disk, the one phase whose files do; 13b's options, 13f's
# run from the tool's cache, and 13d, 13e and 13g beside 13f's run, are
# measured at a shallower depth than 13's 20. 13f's depth is the least from
# 10 up whose blocks 13g's scan-stacked layout takes: (depth - 8) % 4 == 0
CHECKPOINT_7B_DEPTH = 6
OPTIONS_7B_DEPTH = 10
TOOL_CACHE_7B_DEPTH = 12


def checkpoint_7b_gb(depth: int) -> float:
    """GB of a full-state checkpoint of the 7B width at `depth`: fp32
    parameters, mu and nu."""
    import torch

    from f_lite_tpu_torch.models.dit import DiT, DiTConfig

    with torch.device("meta"):
        n_params = sum(p.numel() for p in DiT(DiTConfig.f_lite_7b(depth=depth)).parameters())
    return n_params * 12 / 1e9


def disk_gb(path: Path) -> float:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file()) / 1e9


def run_7b_training(tmp: Path, steps=10, batch=4, depth=20, extra=(),
                    label="7b_train", cache=None, out_root=None) -> dict:
    """The 7B's widths at depth 20, 512 px (64x64x16 latents), batch 4, text
    embeddings of 77 and 128 real rows (padded to 128), bf16 compute over
    fp32 master weights, checkpointing from block 8, AdamW, `steps` steps,
    with `extra` options: finite loss and grad norm, exactly 46 forward, 31
    dq and 31 dkv launches a step, peak memory under 80 GB, a profile of
    one step, and the final checkpoint's seconds and GB (its dir removed
    after). `cache`: another precomputed cache to train from; `out_root`:
    where the run's files go (`in_memory`), else `tmp`."""
    import shutil

    import torch

    out = (out_root or tmp) / label
    argv = argv_7b(tmp, out, steps, batch, depth, cache) + list(extra)
    expected = launches(**train_7b_launches(depth, lora="--use_lora" in extra))
    finite, losses = [], []

    def check(step, metrics):
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        finite.append(math.isfinite(loss) and math.isfinite(gnorm))
        losses.append(loss)
        log(f"  {label} step {step}: loss {loss} grad_norm {gnorm}")

    watch = StepWatch(profile_window=(steps - 2, steps - 1), check=check)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    watch.begin()
    result, _ = run_training(argv, watch)
    counts = read_counts()
    n_params = sum(p.numel() for p in watch.state.model.parameters())
    n_trained = sum(p.numel() for p in watch.state.optimizer.params)
    final = out / "checkpoints" / str(result["global_step"])
    res = dict(config=f"f_lite_7b_width_d{depth}_train512", options=list(extra),
               params=n_params, trained_params=n_trained,
               batch=batch, tokens=1040, steps=result["global_step"],
               s_per_step=statistics.median(watch.times[2:]),
               s_per_step_pr5=0.409, step_s=watch.times,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=counts, per_step=watch.per_step[0],
               per_step_expected=expected, all_finite=all(finite),
               checkpoints=result["checkpoints"], final_checkpoint_gb=disk_gb(final),
               step_profile=watch.profile, losses=losses)
    log(label, json.dumps(res))
    shutil.rmtree(out, ignore_errors=True)
    if result["global_step"] != steps or not all(finite) or len(finite) != steps:
        raise AssertionError(f"{label}: {result['global_step']} steps, finite {finite}")
    bad = [i + 1 for i, c in enumerate(watch.per_step) if c != expected]
    if bad:
        raise AssertionError(
            f"{label}: launch counts {watch.per_step[bad[0] - 1]} at step "
            f"{bad[0]}, expected {expected}")
    if not res["max_memory_allocated_gb"] < 80:
        raise AssertionError(f"{label} peak {res['max_memory_allocated_gb']} GB")
    del watch
    torch.cuda.empty_cache()
    return res


def run_7b_checkpoint(tmp: Path, depth=20) -> dict:
    """Phase 13c's full-state checkpoint at the 7B's widths: 3 steps with an
    `--async_checkpoint` save at step 2 and the trainer's final (sync)
    save at step 3, `--checkpoints_total_limit 1`: each save's seconds
    blocked and writing, the bytes on disk against n_params x 12 (fp32
    parameters, mu and nu). Free disk is checked first, for two of them."""
    import shutil

    import torch

    from f_lite_tpu_torch.models.dit import DiT, DiTConfig

    with torch.device("meta"):
        n_params = sum(p.numel() for p in DiT(DiTConfig.f_lite_7b(depth=depth)).parameters())
    need_gb = 2 * n_params * 12 / 1e9
    free_gb = shutil.disk_usage(tmp).free / 1e9
    log("7b_checkpoint_disk", json.dumps(dict(params=n_params, need_gb=need_gb,
                                              free_gb=free_gb, dir=str(tmp))))
    if free_gb < need_gb * 1.1:
        raise AssertionError(f"7B checkpoint: {free_gb:.1f} GB free, {need_gb:.1f} needed")
    out = tmp / "7b_checkpoint"
    argv = argv_7b(tmp, out, 3, depth=depth) + [
        "--checkpointing_steps", "2", "--async_checkpoint", "--checkpoints_total_limit", "1"]
    watch = StepWatch()
    torch.cuda.empty_cache()
    reset_counts()
    watch.begin()
    result, _ = run_training(argv, watch)
    steps = sorted(int(d.name) for d in (out / "checkpoints").iterdir())
    res = dict(params=n_params, expected_gb=n_params * 12 / 1e9,
               disk_gb=disk_gb(out / "checkpoints" / "3"), kept_steps=steps,
               saves=result["checkpoints"], step_s=watch.times)
    log("7b_checkpoint", json.dumps(res))
    shutil.rmtree(out, ignore_errors=True)
    if steps != [3] or not res["disk_gb"] > 0.9 * res["expected_gb"]:
        raise AssertionError(f"7B checkpoint: {res}")
    del watch
    torch.cuda.empty_cache()
    return res


def write_flux_vae(root: Path, seed=3, device="cuda") -> Path:
    """A Flux VAE at full width with seeded weights (flax's default
    initializers), written once as a native `vae/` dir (config.json +
    flax_params.safetensors); the dir."""
    import torch

    from f_lite_tpu_torch.convert.to_jax import vae_state_dict_to_jax
    from f_lite_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from f_lite_tpu_torch.utils.safetensors import save_file

    if not (root / "config.json").exists():
        root.mkdir(parents=True, exist_ok=True)
        with torch.device(device):
            vae = AutoencoderKL(VAEConfig.flux())
        vae.init_weights(torch.Generator(device).manual_seed(seed))
        (root / "config.json").write_text(json.dumps(vae.config.to_json_dict()))
        save_file(vae_state_dict_to_jax(vae.state_dict(), vae.config),
                  root / "flax_params.safetensors")
        del vae
        torch.cuda.empty_cache()
    return root


class EncodeTimer:
    """Times every `AutoencoderKL.encode` with CUDA events (read after the
    run)."""

    def __enter__(self):
        import torch

        from f_lite_tpu_torch.models.vae import AutoencoderKL

        self.cls, self.fn, self.events = AutoencoderKL, AutoencoderKL.encode, []
        fn, events = self.fn, self.events

        def timed(vae, *args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(vae, *args, **kwargs)
            end.record()
            events.append((start, end))
            return out

        AutoencoderKL.encode = timed
        return self

    def __exit__(self, *exc):
        self.cls.encode = self.fn

    def ms(self) -> list:
        import torch

        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def write_7b_online_table(tmp: Path, batch=4) -> Path:
    """The dummy-backed JSON table of 512x512 rows (16 batches) that 13f
    caches and 13d trains from."""
    table = tmp / "7b_online.json"
    table.write_text(json.dumps([
        {"media_path": f"dummy://photos/{i}.jpg", "captions": [f"prompt {i}"],
         "width": 512, "height": 512} for i in range(16 * batch)]))
    return table


def run_7b_online(tmp: Path, phase13f: dict, steps=10, batch=4, out_root=None) -> dict:
    """Phase 13d (after 13f): 13f's run (the 7B width at its depth) on the
    online path: 13f's dummy-backed JSON table of 512x512 rows with
    --center_crop, the Flux VAE at full width (seeded, `--vae_path`)
    encoding each batch in fp32, ZeroTextEncoder(4096, 32), batch 4, bf16,
    full remat from block 8, 10 steps: finite loss and grad norm, the
    launches a step of phase 13 at that depth, peak under 80 GB; s/step,
    the VAE encode's ms a step (CUDA events), the loader's wait ms a step,
    idle share and peak GB, each beside 13f's run from the same images'
    cache."""
    import shutil

    import torch

    reference, depth = phase13f["train"], phase13f["depth"]
    table = write_7b_online_table(tmp, batch)
    vae_dir = write_flux_vae(tmp / "flux_vae")
    out = (out_root or tmp) / "7b_online"
    argv = online_argv(argv_7b(tmp, out, steps, batch, depth), table,
                       base_url="dummy://", resolution=512) + [
        "--vae_path", str(vae_dir)]
    expected = launches(**train_7b_launches(depth))
    finite = []

    def check(step, metrics):
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        finite.append(math.isfinite(loss) and math.isfinite(gnorm))
        log(f"  7b_online step {step}: loss {loss} grad_norm {gnorm}")

    watch = StepWatch(profile_window=(steps - 2, steps - 1), check=check)
    # what earlier phases leave allocated counts in the peak: collect
    # their cycles first and report the rest beside the peak
    gc.collect()
    torch.cuda.empty_cache()
    start_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    watch.begin()
    with EncodeTimer() as enc:
        result, _ = run_training(argv, watch)
    encode_ms = enc.ms()
    res = dict(config=f"f_lite_7b_width_d{depth}_train512 (online)", batch=batch,
               tokens=1040, cross_tokens=32, steps=result["global_step"],
               s_per_step=statistics.median(watch.times[2:]),
               reference_s_per_step=reference["s_per_step"], step_s=watch.times,
               vae_encode_ms_per_step=statistics.median(encode_ms[2:]),
               vae_encode_ms=encode_ms,
               loader_wait_ms_per_step=result["loader_wait_s"] / steps * 1e3,
               idle_share=watch.profile["idle_share"],
               reference_idle_share=reference["step_profile"]["idle_share"],
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               allocated_at_start_gb=start_gb,
               reference_max_memory_allocated_gb=reference["max_memory_allocated_gb"],
               launches=read_counts(), per_step=watch.per_step[0],
               per_step_expected=expected, all_finite=all(finite),
               step_profile=watch.profile)
    log("7b_online", json.dumps(res))
    shutil.rmtree(out, ignore_errors=True)
    if result["global_step"] != steps or not all(finite) or len(finite) != steps:
        raise AssertionError(f"7b_online: {result['global_step']} steps, finite {finite}")
    bad = [i + 1 for i, c in enumerate(watch.per_step) if c != expected]
    if bad:
        raise AssertionError(f"7b_online: launch counts {watch.per_step[bad[0] - 1]} at "
                             f"step {bad[0]}, expected {expected}")
    if len(encode_ms) != steps:
        raise AssertionError(f"7b_online: {len(encode_ms)} VAE encodes in {steps} steps")
    if not res["max_memory_allocated_gb"] < 80:
        raise AssertionError(f"7b_online peak {res['max_memory_allocated_gb']} GB")
    del watch
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 12g and 13e: the trainer under torchrun, the DiT under FSDP2
# ---------------------------------------------------------------------------

def start_torchrun(argv: list, log_path: Path,
                   target=("-m", "f_lite_tpu_torch.train")) -> dict:
    """Start `torchrun --standalone --nproc_per_node 1 -m
    f_lite_tpu_torch.train` (or another `target`) with `argv` as a
    subprocess (a real NCCL process group of one rank, the DiT under
    `fully_shard`), its output in `log_path`; a thread notes when it ends.
    The job for `finish_torchrun`."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    log("torchrun_parent_reserved_gb", torch.cuda.memory_reserved() / 1e9)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", *target, *argv]
    job = dict(log_path=log_path, log_file=open(log_path, "w"), t0=time.perf_counter(),
               started=time.time())
    job["proc"] = subprocess.Popen(cmd, stdout=job["log_file"], stderr=subprocess.STDOUT,
                                   cwd=ROOT)

    def wait():
        job["proc"].wait()
        job["wall"] = time.perf_counter() - job["t0"]

    job["waiter"] = threading.Thread(target=wait, daemon=True)
    job["waiter"].start()
    return job


def stop_process(proc, grace=30) -> None:
    """SIGTERM (torchrun passes it to its workers), then SIGKILL after
    `grace` seconds, if `proc` still runs."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=grace)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def wait_torchrun(job: dict, timeout=900) -> None:
    """Wait for a `start_torchrun` job to end (stopped past `timeout`
    seconds from its start); the first wait notes this process' launch
    counts then (`parent_launches`: none may happen beside a subprocess)."""
    job["waiter"].join(max(1.0, timeout - (time.perf_counter() - job["t0"])))
    if job["waiter"].is_alive():
        stop_process(job["proc"])
        raise AssertionError(f"torchrun {job['log_path'].name}: over {timeout} s")
    job["log_file"].close()
    job.setdefault("parent_launches", read_counts())


def finish_torchrun(job: dict, out: Path, timeout=900) -> tuple:
    """(the step lines of a `start_torchrun` job's `metrics.jsonl`, its
    result line, the subprocess' seconds), once it has ended."""
    wait_torchrun(job, timeout)
    wall, started, log_path = job["wall"], job["started"], job["log_path"]
    text = log_path.read_text()
    if job["proc"].returncode != 0 or "mesh: dp=1 fsdp=1 world=1 nodes=1" not in text:
        raise AssertionError(f"torchrun exit {job['proc'].returncode}:\n{text[-4000:]}")
    lines = [json.loads(x) for x in (out / "logs" / "metrics.jsonl").read_text().splitlines()]
    steps = [x for x in lines if "train/loss" in x]
    # where a subprocess' seconds go: to its first logged step (start-up and
    # that step), the steps, after its last (the final save and the exit)
    log("torchrun_seconds", json.dumps(dict(
        log=log_path.name, wall_s=wall, to_first_step_s=steps[0]["time"] - started,
        steps_s=steps[-1]["time"] - steps[0]["time"],
        after_last_step_s=started + wall - steps[-1]["time"])))
    return steps, lines[-1]["result"], wall


def run_torchrun(argv: list, out: Path, log_path: Path, timeout=900,
                 target=("-m", "f_lite_tpu_torch.train")) -> tuple:
    """`start_torchrun`, then `finish_torchrun`."""
    return finish_torchrun(start_torchrun(argv, log_path, target), out, timeout)


def per_step_launches(records: list) -> list:
    """Each logged step's launches, from the cumulative counts of
    `metrics.jsonl` (`--log_every 1`)."""
    out, last = [], dict(fwd=0, dq=0, dkv=0, rms_norm=0, rms_norm_bwd=0)
    for r in records:
        out.append({k: r["launches"][k] - last[k] for k in last})
        last = r["launches"]
    return out


def step_seconds(records: list) -> float:
    """The median of the logged steps' wall-clock gaps, the first two
    left out."""
    times = [r["time"] for r in records]
    return statistics.median(b - a for a, b in zip(times[2:], times[3:]))


def run_fixture_fsdp(tmp: Path, phase12: dict, phase12b: dict, beside=None) -> dict:
    """Phase 12g: phase 12b's straight run (the fixture recipe on phase 12's
    cache, `--checkpointing_steps` half-way, `--async_checkpoint`) under
    torchrun with `--fsdp 0`: every step's loss bit-equal to 12b's
    unwrapped run (or within 1e-6 relative, the gap printed), exactly 12
    launches of each kernel a step; the step-`steps` / 2 checkpoint
    resumed in an unwrapped run gives 12b's losses after it; s/step beside
    phase 12's. `beside`: a `start_torchrun` job running beside this one
    (12h's), waited for before the resume launches kernels here."""
    import shutil

    cache = tmp / "shapes_cache"
    steps, half = phase12b["steps"], phase12b["resumed_at"]
    straight = phase12b["straight_losses"]
    out = tmp / "fsdp_fixture"
    argv = fixture_argv(cache, out, steps) + [
        "--checkpointing_steps", str(half), "--async_checkpoint", "--fsdp", "0",
        "--log_every", "1"]
    reset_counts()
    records, result, wall = run_torchrun(argv, out, tmp / "fsdp_fixture.log")
    parent = read_counts()
    losses = [r["train/loss"] for r in records]
    expected = train_step_launches(fixture_config())
    per_step = per_step_launches(records)

    def rel_gap(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b, strict=True))

    if beside is not None:
        wait_torchrun(beside)
    resume = tmp / "fsdp_fixture_resume"
    shutil.copytree(out / "checkpoints" / str(half), resume / "checkpoints" / str(half))
    reset_counts()
    _, _, watch, resumed = run_counted(fixture_argv(cache, resume, steps)
                                       + ["--resume_from_checkpoint", "latest"])
    res = dict(steps=len(losses), losses_bit_equal=losses == straight,
               max_rel_gap=rel_gap(losses, straight),
               resumed_unwrapped_bit_equal=resumed == straight[half:],
               resumed_max_rel_gap=rel_gap(resumed, straight[half:]),
               per_step_launches=per_step[0], s_per_step=step_seconds(records),
               phase_12_s_per_step=phase12["s_per_step"], subprocess_s=wall,
               checkpoints=result["checkpoints"], parent_launches=parent,
               resumed_launches=read_counts())
    log("fixture_fsdp", json.dumps(res))
    shutil.rmtree(out, ignore_errors=True)
    shutil.rmtree(resume, ignore_errors=True)
    if len(losses) != steps or res["max_rel_gap"] > 1e-6 \
            or res["resumed_max_rel_gap"] > 1e-6:
        raise AssertionError(f"fixture fsdp: losses {losses} against {straight}, "
                             f"resumed {resumed}")
    if any(c != expected for c in per_step) or any(parent.values()):
        raise AssertionError(f"fixture fsdp: launch counts {per_step[:3]}, parent {parent}")
    if any(c != launches(**expected) for c in watch.per_step):
        raise AssertionError(f"fixture fsdp resume: launch counts {watch.per_step[:3]}")
    return res


SP_WORKER = "--sequence-parallel-train-worker"


def sequence_parallel_train_worker(argv: list) -> int:
    """The trainer on `argv`, its `parallelize_dit` applied with
    `sequence_parallel=True` (the trainer's flag needs --tp > 1, as in
    JAX); run under torchrun by phase 12h."""
    from f_lite_tpu_torch.parallel import tensor
    from f_lite_tpu_torch.train import trainer

    plain = tensor.parallelize_dit

    def with_sp(model, mesh, sequence_parallel=False):
        print(f"sequence parallelism applied on a tp mesh of {mesh.size()}", flush=True)
        return plain(model, mesh, sequence_parallel=True)

    tensor.parallelize_dit = with_sp
    trainer.main(argv)
    return 0


def start_fixture_sp(tmp: Path, phase12b: dict) -> dict:
    """Phase 12h (a): its torchrun subprocess, started beside 12g's."""
    out = tmp / "sp_fixture"
    argv = fixture_argv(tmp / "shapes_cache", out, phase12b["steps"]) + [
        "--fsdp", "0", "--log_every", "1"]
    reset_counts()
    return dict(out=out, job=start_torchrun(argv, tmp / "sp_fixture.log",
                                            target=(str(ROOT / "chip_smoke.py"), SP_WORKER)))


def run_fixture_sp(started: dict, phase12b: dict, phase12g: dict) -> dict:
    """Phase 12h: phase 12b's straight run under torchrun (a subprocess of
    this script, `SP_WORKER`, beside 12g's) with `parallelize_dit(
    sequence_parallel=True)` on the one-rank tp mesh: every loss bit-equal
    to 12b's (or within 1e-6 relative, the gap printed), exactly 12
    launches of each kernel a step; s/step beside 12g's (the two taken
    side by side)."""
    import shutil

    steps = phase12b["steps"]
    straight = phase12b["straight_losses"]
    out, job = started["out"], started["job"]
    records, result, wall = finish_torchrun(job, out)
    parent = job["parent_launches"]  # noted when 12g waited for it
    losses = [r["train/loss"] for r in records]
    expected = train_step_launches(fixture_config())
    per_step = per_step_launches(records)
    applied = "sequence parallelism applied on a tp mesh of 1" in job["log_path"].read_text()
    res = dict(steps=len(losses), losses_bit_equal=losses == straight,
               max_rel_gap=max(abs(x - y) / abs(y) for x, y in zip(losses, straight,
                                                                    strict=True)),
               applied=applied, per_step_launches=per_step[0],
               s_per_step=step_seconds(records), phase_12g_s_per_step=phase12g["s_per_step"],
               beside="12g", subprocess_s=wall, parent_launches=parent)
    log("fixture_sp", json.dumps(res))
    shutil.rmtree(out, ignore_errors=True)
    if not applied or len(losses) != steps or res["max_rel_gap"] > 1e-6:
        raise AssertionError(f"fixture sp: applied {applied}, losses {losses} against "
                             f"{straight}")
    if any(c != expected for c in per_step) or any(parent.values()):
        raise AssertionError(f"fixture sp: launch counts {per_step[:3]}, parent {parent}")
    return res


def run_7b_fsdp(tmp: Path, phase13f: dict, phase13c: dict, steps=10,
                out_root=None) -> dict:
    """Phase 13e: phase 13f's run (the 7B width at its depth, from the
    tool's cache) under torchrun with `--fsdp 0`, `steps` steps and a
    profile of the last but one: finite loss and grad norm, the launches a
    step of phase 13 at that depth, peak under 80 GB; whether its losses
    equal 13f's bit for bit (printed), its s/step, peak GB and idle share
    beside 13f's, and the final full-state checkpoint's gather and write
    seconds beside 13c's sync save."""
    import shutil

    reference, depth = phase13f["train"], phase13f["depth"]
    out = (out_root or tmp) / "fsdp_7b"
    window = (steps - 2, steps - 1)
    argv = argv_7b(tmp, out, steps, depth=depth, cache=phase13f["cache"]) + [
        "--fsdp", "0", "--profile_steps", f"{window[0]},{window[1]}"]
    expected = train_7b_launches(depth)
    reset_counts()
    records, result, wall = run_torchrun(argv, out, tmp / "fsdp_7b.log")
    per_step = per_step_launches(records)
    trace = trace_summary(out / "profile" / f"steps_{window[0]}_{window[1]}.json")
    finite = all(math.isfinite(r["train/loss"]) and math.isfinite(r["train/grad_norm"])
                 for r in records)
    save = result["checkpoints"][-1]
    phase13c_sync = next(s for s in phase13c["saves"] if s["wait"])
    losses = [r["train/loss"] for r in records]
    res = dict(config=f"f_lite_7b_width_d{depth}_train512 (13f's cache)",
               steps=len(records), losses=losses,
               losses_equal_reference=losses == reference["losses"],
               grad_norms=[r["train/grad_norm"] for r in records], all_finite=finite,
               per_step_launches=per_step[0], per_step_expected=expected,
               s_per_step=step_seconds(records),
               reference_s_per_step=reference["s_per_step"],
               max_memory_allocated_gb=records[-1]["peak_gb"],
               reference_max_memory_allocated_gb=reference["max_memory_allocated_gb"],
               idle_share=trace["idle_share"],
               reference_idle_share=reference["step_profile"]["idle_share"],
               trace_kernels=trace["names"], final_save=save,
               final_checkpoint_gb=disk_gb(out / "checkpoints" / str(steps)),
               phase_13c_sync_save=phase13c_sync, subprocess_s=wall,
               parent_launches=read_counts())
    log("7b_fsdp", json.dumps(res))
    shutil.rmtree(out, ignore_errors=True)
    if len(records) != steps or not finite:
        raise AssertionError(f"7b fsdp: {len(records)} steps, finite {finite}")
    if any(c != expected for c in per_step) or any(res["parent_launches"].values()):
        raise AssertionError(f"7b fsdp: launch counts {per_step[:3]}, expected {expected}")
    if not res["max_memory_allocated_gb"] < 80:
        raise AssertionError(f"7b fsdp peak {res['max_memory_allocated_gb']} GB")
    return res


PP_WORKER = "--pipeline-train-worker"


def pipeline_train_worker(argv: list) -> int:
    """The trainer on `argv` with the GPipe schedule at 1 stage and 2
    microbatches (`trainer.pipeline_schedule`; the trainer's flags need
    --pp > 1 for microbatches, as in JAX); run under torchrun by phase
    13g."""
    from f_lite_tpu_torch.train import trainer

    def one_stage(args):
        print("pipeline schedule applied at 1 stage and 2 microbatches", flush=True)
        return 1, 2

    trainer.pipeline_schedule = one_stage
    trainer.main(argv)
    return 0


def run_7b_pipeline(tmp: Path, phase13f: dict, steps=10) -> dict:
    """Phase 13g: phase 13f's run (the 7B width at its depth, from the
    tool's cache) plus `--scan_layers --export_pipeline` under torchrun
    with the schedule at 1 stage and 2 microbatches (`PP_WORKER`), `steps`
    steps: finite losses, exactly twice 13f's launches a step, step 1's
    loss within 1e-3 relative of 13f's and every loss within 1e-2, peak
    under 80 GB; the export loaded back on the card bit-equal to the final
    checkpoint's weights (its files in memory where there is room)."""
    import torch

    from f_lite_tpu_torch.pipeline import FLitePipeline
    from f_lite_tpu_torch.train.checkpoint import Checkpointer

    reference, depth = phase13f["train"], phase13f["depth"]
    per = train_7b_launches(depth)
    expected = {k: 2 * v for k, v in per.items()}
    # the final checkpoint and the export (a third of its size)
    with memory_tmp(reference["final_checkpoint_gb"] * 4 / 3) as (root, where):
        out = root / "pipeline_7b"
        argv = argv_7b(tmp, out, steps, depth=depth, cache=phase13f["cache"]) + [
            "--scan_layers", "--export_pipeline", "--fsdp", "0"]
        reset_counts()
        log_path = tmp / "pipeline_7b.log"
        records, result, wall = run_torchrun(argv, out, log_path,
                                             target=(str(ROOT / "chip_smoke.py"), PP_WORKER))
        parent = read_counts()
        text = log_path.read_text()
        applied = ("pipeline schedule applied at 1 stage and 2 microbatches" in text
                   and f"stage 0 holds blocks 0-{depth - 1}" in text)
        losses = [r["train/loss"] for r in records]
        per_step = per_step_launches(records)
        finite = all(math.isfinite(r["train/loss"]) and math.isfinite(r["train/grad_norm"])
                     for r in records)
        gaps = [abs(a - b) / abs(b) for a, b in zip(losses, reference["losses"], strict=True)]
        export = out / "pipeline"
        config = json.loads((export / "dit" / "config.json").read_text())
        t0 = time.perf_counter()
        dit = FLitePipeline.from_pretrained(export, dtype=torch.float32, device="cuda",
                                            load_text_encoder=False).dit
        load_s = time.perf_counter() - t0
        ckpt = Checkpointer(out)
        _, trained = ckpt.load(ckpt.latest)
        loaded = dit.state_dict()
        mismatched = [k for k, v in loaded.items()
                      if not torch.equal(v.cpu(), trained[k])]
        res = dict(config=f"f_lite_7b_width_d{depth}_train512 (13f's cache)",
                   options=["--scan_layers", "--export_pipeline"],
                   stages=1, microbatches=2, applied=applied, steps=len(records),
                   losses=losses, reference_losses=reference["losses"], rel_gaps=gaps,
                   all_finite=finite, per_step_launches=per_step[0],
                   per_step_expected=expected, s_per_step=step_seconds(records),
                   reference_s_per_step=reference["s_per_step"],
                   max_memory_allocated_gb=records[-1]["peak_gb"],
                   reference_max_memory_allocated_gb=reference["max_memory_allocated_gb"],
                   final_save=result["checkpoints"][-1],
                   export_config={k: config[k] for k in ("scan_layers", "pipeline_stages")},
                   export_gb=disk_gb(export), export_load_s=load_s,
                   export_tensors=len(loaded), export_bit_equal=not mismatched,
                   files=where, subprocess_s=wall, parent_launches=parent)
        log("7b_pipeline", json.dumps(res))
        del dit, loaded, trained
        torch.cuda.empty_cache()
    if not applied or len(records) != steps or not finite:
        raise AssertionError(f"7b pipeline: applied {applied}, {len(records)} steps, "
                             f"finite {finite}")
    if any(c != expected for c in per_step) or any(parent.values()):
        raise AssertionError(f"7b pipeline: launch counts {per_step[:3]}, expected "
                             f"{expected}, parent {parent}")
    if gaps[0] > 1e-3 or max(gaps) > 1e-2:
        raise AssertionError(f"7b pipeline: losses {losses} against 13f's "
                             f"{reference['losses']} (gaps {gaps})")
    if not res["max_memory_allocated_gb"] < 80:
        raise AssertionError(f"7b pipeline peak {res['max_memory_allocated_gb']} GB")
    if mismatched or config["scan_layers"] is not True or config["pipeline_stages"] != 1:
        raise AssertionError(f"7b pipeline export: config {res['export_config']}, "
                             f"{len(mismatched)} tensors differ ({mismatched[:3]})")
    return res


# ---------------------------------------------------------------------------
# phase 13f: the cache builder (`python -m f_lite_tpu_torch.tools.precompute_embeddings`)
# ---------------------------------------------------------------------------

def write_tiny_vae(root: Path, seed=5) -> Path:
    """A tiny VAE (16 latent channels, scale 2) with seeded weights drawn
    on the CPU, written as a native `vae/` dir; the dir."""
    import torch

    from f_lite_tpu_torch.convert.to_jax import vae_state_dict_to_jax
    from f_lite_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from f_lite_tpu_torch.utils.safetensors import save_file

    root.mkdir(parents=True)
    vae = AutoencoderKL(VAEConfig.tiny(latent_channels=16))
    vae.init_weights(torch.Generator().manual_seed(seed))
    (root / "config.json").write_text(json.dumps(vae.config.to_json_dict()))
    save_file(vae_state_dict_to_jax(vae.state_dict(), vae.config),
              root / "flax_params.safetensors")
    return root


def exact_latents(table: Path, vae_dir: Path, batch_size=8, seed=0,
                  nudge=False) -> list:
    """The cache builder's latents for `table` (64 px, center crop) in
    float64 on the CPU: the same images, batches and posterior draws
    (`posterior_noise`), the VAE's weights widened. `nudge`: every input
    value moved one fp32 ulp up or down first (seeded signs), to measure
    how far the input's own rounding moves the encode."""
    import numpy as np
    import torch

    from f_lite_tpu_torch.data.dataset import ImageDataset
    from f_lite_tpu_torch.data.loader import DataLoader
    from f_lite_tpu_torch.tools import precompute_embeddings
    from f_lite_tpu_torch.train.trainer import build_vae

    vae = build_vae(argparse.Namespace(pixel_space=False, vae_path=str(vae_dir)),
                    "cpu").double()
    ds = ImageDataset(str(table), resolution=64, center_crop=True,
                      root_dir_type="json", base_url="file://")
    out, rs = [], np.random.RandomState(1)
    for index, batch in enumerate(DataLoader(ds, batch_size=batch_size, num_workers=4)):
        images = batch["image"]
        if nudge:
            images = np.nextafter(images, np.where(rs.rand(*images.shape) < 0.5,
                                                   -np.inf, np.inf).astype(np.float32))
        out += list(precompute_embeddings.encode_batch(
            vae, images, torch.device("cpu"), seed=seed, index=index))
    return out


def cache_builder_parity(tmp: Path, tables: dict) -> dict:
    """Phase 13f (a): the first 256 rows of phase 12d's PNG table (64 px,
    `--center_crop`), a seeded tiny VAE (`--vae_path`), the zero encoder:
    the cache built on the card and with `--device cpu`. The indexes equal,
    the embeddings bit-equal, no kernel launched; every latent within 1e-5
    x max |CPU| of the CPU's. Where that bar is missed, the error is
    printed with its cause: each cache's distance to the same encode in
    float64, beside how far that encode moves when every input value
    moves one fp32 ulp (its conditioning); the card must be within 10
    times that move (a fault gives errors of order 1)."""
    import numpy as np

    from f_lite_tpu_torch.tools import precompute_embeddings

    table = tmp / "13f_table.json"
    table.write_text(json.dumps(json.loads(Path(tables["train"]).read_text())[:256]))
    vae_dir = write_tiny_vae(tmp / "13f_tiny_vae")
    argv = ["--train_data_path", str(table), "--root_dir_type", "json",
            "--base_url", "file://", "--resolution", "64", "--center_crop",
            "--vae_path", str(vae_dir), "--text_encoder_type", "zero",
            "--cross_attn_input_size", "64"]
    caches, seconds = {"cuda": tmp / "13f_cache_cuda", "cpu": tmp / "13f_cache_cpu"}, {}
    reset_counts()
    for device, cache in caches.items():
        n, seconds[device] = timed_main(precompute_embeddings.main, argv + [
            "--output_dir", str(cache), "--device", device])
        if n != 256:
            raise AssertionError(f"cache builder ({device}): {n} items, expected 256")
    counts = read_counts()
    index = {d: json.loads((c / "precomputed_mapping.json").read_text())
             for d, c in caches.items()}
    exact = exact_latents(table, vae_dir)
    nudged = exact_latents(table, vae_dir, nudge=True)
    err, to_exact, emb_equal = [], {d: [] for d in (*caches, "ulp_nudge")}, True
    for e, ref, moved in zip(index["cpu"]["entries"], exact, nudged):
        lat = {d: np.load(c / "vae_latents" / e["latent_file"]) for d, c in caches.items()}
        err.append(float(np.abs(lat["cuda"] - lat["cpu"]).max())
                   / float(np.abs(lat["cpu"]).max()))
        for d, z in (*lat.items(), ("ulp_nudge", moved)):
            to_exact[d].append(float(np.abs(z - ref).max()) / float(np.abs(ref).max()))
        emb_equal &= np.array_equal(
            np.load(caches["cuda"] / "text_embeddings" / e["embedding_file"]),
            np.load(caches["cpu"] / "text_embeddings" / e["embedding_file"]))
    worst = int(np.argmax(err))
    res = dict(items=256, index_equal=index["cuda"] == index["cpu"],
               embeddings_bit_equal=bool(emb_equal),
               max_latent_err_over_max_cpu=err[worst], within_1e_5=err[worst] <= 1e-5,
               latents_over_1e_5=sum(x > 1e-5 for x in err),
               median_latent_err_over_max_cpu=float(np.median(err)),
               max_dist_to_float64={d: max(v) for d, v in to_exact.items()},
               median_dist_to_float64={d: float(np.median(v)) for d, v in to_exact.items()},
               card_s=seconds["cuda"], cpu_s=seconds["cpu"], launches=counts)
    log("cache_builder_parity", json.dumps(res))
    if not (res["index_equal"] and res["embeddings_bit_equal"]):
        raise AssertionError(f"cache builder: the card's cache differs from the CPU's: {res}")
    if counts != launches():
        raise AssertionError(f"cache builder: launches {counts}")
    if not res["within_1e_5"]:
        dist = res["max_dist_to_float64"]
        med = res["median_dist_to_float64"]
        log(f"cache_builder_parity: the 1e-5 bar is missed: a card latent is "
            f"{err[worst]:.3g} x max |CPU| from the CPU's ({res['latents_over_1e_5']} "
            f"of 256 over it). Cause: the card's fp32 encode (cuDNN's convolutions "
            f"and the rest) lands farther from the float64 encode than the CPU's "
            f"(median {med['cuda']:.3g} "
            f"against {med['cpu']:.3g}, largest {dist['cuda']:.3g} against "
            f"{dist['cpu']:.3g} x max), and the encode amplifies rounding on these "
            f"images (flat colours through a seeded VAE): one ulp on every input "
            f"moves it by up to {dist['ulp_nudge']:.3g} x max")
        if not dist["cuda"] <= 10 * dist["ulp_nudge"]:
            raise AssertionError(
                f"cache builder: the card's latents are {dist['cuda']:.3g} x max from "
                "the float64 encode, more than 10 times what a one-ulp change of the "
                f"input moves it ({dist['ulp_nudge']:.3g}): the miss has another cause")
    return res


def run_cache_builder(tmp: Path, tables: dict, phase13: dict, steps=10, batch=4,
                      depth=20) -> dict:
    """Phase 13f: (a) `cache_builder_parity`; (b) phase 13d's dummy-backed
    512 px table (64 rows) through the Flux VAE at full width and
    `ZeroTextEncoder(4096, 32)`: s/image split into the VAE encode (CUDA
    events) and the text encode (host clock), the cache's GB on disk, peak
    GB; then `f_lite_7b_width_d20_train512` (phase 13's arguments) for 10
    steps from that cache with phase 13's checks (46/31/31 launches a
    step, under 80 GB), s/step beside phase 13's; its final checkpoint goes
    to memory where it has room (`memory_tmp`)."""
    import torch

    from f_lite_tpu_torch.models.dit import DiTConfig
    from f_lite_tpu_torch.text.encoder import ZeroTextEncoder
    from f_lite_tpu_torch.tools import precompute_embeddings

    parity = cache_builder_parity(tmp, tables)
    cache = tmp / "13f_cache_7b"
    table = write_7b_online_table(tmp, batch)
    n_rows = len(json.loads(table.read_text()))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    with EncodeTimer() as enc, Recorded(ZeroTextEncoder, "encode") as text:
        n, build_s = timed_main(precompute_embeddings.main, [
            "--train_data_path", str(table), "--root_dir_type", "json",
            "--base_url", "dummy://", "--resolution", "512", "--center_crop",
            "--vae_path", str(write_flux_vae(tmp / "flux_vae")),
            "--text_encoder_type", "zero", "--cross_attn_input_size",
            str(DiTConfig.f_lite_7b().cross_attn_input_size), "--output_dir", str(cache)])
        torch.cuda.synchronize()
    encode_ms = enc.ms()
    full = dict(items=n, batches=len(encode_ms), build_s=build_s,
                s_per_image=build_s / n,
                vae_encode_s_per_image=sum(encode_ms) / 1e3 / n,
                vae_encode_ms_per_batch=encode_ms,
                text_encode_s_per_image=sum(text.seconds) / n,
                cache_gb=disk_gb(cache),
                max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                launches=read_counts())
    log("cache_builder_7b", json.dumps(full))
    if n != n_rows or full["launches"] != launches():
        raise AssertionError(f"cache builder 7B: {n} of {n_rows} items, "
                             f"launches {full['launches']}")
    entry = json.loads((cache / "precomputed_mapping.json").read_text())["entries"][0]
    if entry["latent_shape"] != [64, 64, 16]:
        raise AssertionError(f"cache builder 7B: latent shape {entry['latent_shape']}")
    with memory_tmp(1.2 * phase13["final_checkpoint_gb"]) as (root, where):
        train = run_7b_training(root, steps, batch, depth, (), "7b_train_from_tool_cache",
                                cache=cache)
    return dict(parity=parity, full_width=full, train=train, checkpoint_in=where,
                phase_13_s_per_step=phase13["s_per_step"], cache=cache, depth=depth)


# ---------------------------------------------------------------------------
# phases 7-8: serving, the trained fixture
# ---------------------------------------------------------------------------

def fixture_requests(pipe, batch, n_requests, **kw):
    """The fixture's requests (one per seed, `batch` = 24 captions each,
    given as `kw`, numpy latents of that seed): (images (n*24, 64, 64, 3),
    host s per request)."""
    import numpy as np
    import torch

    images, seconds = [], []
    for seed in range(n_requests):
        latents = np.random.RandomState(seed).randn(
            batch, 64, 64, pipe.dit.config.in_channels).astype(np.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe(latents=latents, output_type="np", **kw)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        imgs = out.images
        if imgs.shape != (batch, 64, 64, 3) or not np.isfinite(imgs).all():
            raise AssertionError(f"fixture images: shape {imgs.shape} or non-finite")
        images.append(imgs)
    return np.concatenate(images), seconds


def both_acc(images, classes) -> float:
    hits = sum(classify(img) == cls
               for img, cls in zip(images, classes * (len(images) // len(classes))))
    return hits / len(images)


def fixture_captions(classes) -> list[str]:
    return [f"a {c} {s}" for c, s in classes]


def load_fixture(quantize=False, path=FIXTURE, **load_kw):
    """(pipeline in bf16, its 24 captions' embeddings and mask, the
    classes); `load_kw` go to `from_pretrained` (a LoRA)."""
    import torch

    from f_lite_tpu_torch.pipeline import FLitePipeline
    from f_lite_tpu_torch.text.encoder import ZeroTextEncoder

    pipe = FLitePipeline.from_pretrained(path, dtype=torch.bfloat16,
                                         quantize=quantize, **load_kw)
    cfg = pipe.dit.config
    classes = [(c, s) for c in COLORS for s in SHAPES]
    embeds, mask = ZeroTextEncoder(cfg.cross_attn_input_size, seq_len=32).encode(
        fixture_captions(classes))
    return pipe, embeds, mask, classes


def run_fixture(n_requests=4, steps=30, guidance=6.0) -> tuple:
    """Phase 7: full CFG Euler@30 (res, images)."""
    import torch

    pipe, embeds, mask, classes = load_fixture()
    expected = dit_launches(pipe.dit.config, n_requests * steps)
    reset_counts()
    images, seconds = fixture_requests(pipe, len(embeds), n_requests,
                                       prompt_embeds=embeds, context_mask=mask,
                                       num_inference_steps=steps,
                                       guidance_scale=guidance)
    counts = read_counts()
    acc = both_acc(images, classes)
    res = dict(requests=n_requests, images=len(images), both_acc=acc,
               s_per_request=seconds, launches=counts["fwd"],
               expected_launches=expected, counts=counts)
    log("fixture", json.dumps(res))
    if counts != expected:
        raise AssertionError(f"fixture: launches {counts}, expected {expected}")
    if acc < 0.95:
        raise AssertionError(f"fixture: both_acc {acc} < 0.95")
    del pipe
    torch.cuda.empty_cache()
    return res, images


def run_fixture_extras(full_images, n_requests=4, guidance=6.0) -> dict:
    """Phase 8: limited-interval guidance (0.1, 0.9) at 30 steps, both_acc
    >= 0.95 (JAX 0.990, QUALITY_FIXTURE.json); ab2 and Euler at 15 steps,
    each one's image MSE to Euler@30 (JAX 0.0146 and 0.0129)."""
    import numpy as np
    import torch

    pipe, embeds, mask, classes = load_fixture()
    runs = {"gi0.1-0.9@30": dict(num_inference_steps=30, guidance_interval=(0.1, 0.9)),
            "euler@15": dict(num_inference_steps=15),
            "ab2@15": dict(num_inference_steps=15, sampler="ab2")}
    expected = dit_launches(pipe.dit.config, n_requests * sum(
        kw["num_inference_steps"] for kw in runs.values()))
    res = {}
    reset_counts()
    for name, kw in runs.items():
        images, seconds = fixture_requests(pipe, len(embeds), n_requests,
                                           prompt_embeds=embeds, context_mask=mask,
                                           guidance_scale=guidance, **kw)
        res[name] = dict(both_acc=both_acc(images, classes), s_per_request=seconds,
                         mse_vs_euler30=float(np.mean((images - full_images) ** 2)))
    counts = read_counts()
    res.update(launches=counts, expected_launches=expected,
               jax=dict(gi_both_acc=0.9896, ab2_15_mse=0.014558, euler_15_mse=0.012942))
    log("fixture_extras", json.dumps(res))
    if counts != expected:
        raise AssertionError(f"fixture extras: launches {counts}, expected {expected}")
    if res["gi0.1-0.9@30"]["both_acc"] < 0.95:
        raise AssertionError(f"fixture gi: both_acc {res['gi0.1-0.9@30']['both_acc']} < 0.95")
    del pipe
    torch.cuda.empty_cache()
    return res


def run_fixture_int8(full_images, n_requests=4, steps=30, guidance=6.0) -> dict:
    """Phase 8a: the requests of phase 7 on the fixture loaded with
    quantize=True: both_acc >= 0.95 (JAX int8 1.000, QUALITY_FIXTURE.json)
    and PSNR >= 30 dB against phase 7's bf16 images (JAX 34.62 dB against
    its full CFG run); exact launch counts."""
    import numpy as np
    import torch

    pipe, embeds, mask, classes = load_fixture(quantize=True)
    per_forward = int8_layers(pipe.dit)
    expected = dit_launches(pipe.dit.config, n_requests * steps,
                            quantize=n_requests * steps * per_forward,
                            gemm=n_requests * steps * per_forward)
    reset_counts()
    images, seconds = fixture_requests(pipe, len(embeds), n_requests,
                                       prompt_embeds=embeds, context_mask=mask,
                                       num_inference_steps=steps,
                                       guidance_scale=guidance)
    counts = read_counts()
    mse = float(np.mean((images - full_images) ** 2))
    psnr = 10 * math.log10(4.0 / mse) if mse > 0 else math.inf
    res = dict(requests=n_requests, images=len(images),
               both_acc=both_acc(images, classes), psnr_vs_bf16_db=psnr,
               mse_vs_bf16=mse, s_per_request=seconds, launches=counts,
               expected_launches=expected, int8_layers=per_forward,
               jax=dict(both_acc=1.0, psnr_db=34.62))
    log("fixture_int8", json.dumps(res))
    if counts != expected:
        raise AssertionError(f"fixture int8: launches {counts}, expected {expected}")
    if res["both_acc"] < 0.95:
        raise AssertionError(f"fixture int8: both_acc {res['both_acc']} < 0.95")
    if not psnr >= 30:
        raise AssertionError(f"fixture int8: PSNR {psnr} dB < 30 against bf16")
    res["images"] = images  # phase 8h's reference (not logged)
    del pipe
    torch.cuda.empty_cache()
    return res


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_fixture_int8_tp1(fixture_int8, n_requests=2, steps=30, guidance=6.0) -> dict:
    """Phase 8h: phase 8a's pipeline under `parallelize_dit` on a one-rank
    tp mesh of an NCCL group of one (formed here, destroyed after):
    phase 8a's images bit for bit, exact launch counts (each row-parallel
    layer: `row_amax` and `quantize_rows_given` in place of the fused
    quantize)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from f_lite_tpu_torch.models.dit import QuantDense
    from f_lite_tpu_torch.parallel.tensor import parallelize_dit

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0, device_id=torch.device("cuda", 0))
    try:
        pipe, embeds, mask, classes = load_fixture(quantize=True)
        per_forward = int8_layers(pipe.dit)
        parallelize_dit(pipe.dit, init_device_mesh("cuda", (1,), mesh_dim_names=("tp",)))
        row_layers = sum(isinstance(m, QuantDense) and m.tp_amax is not None
                         for m in pipe.dit.modules())
        expected = dit_launches(pipe.dit.config, n_requests * steps,
                                quantize=n_requests * steps * (per_forward + row_layers),
                                gemm=n_requests * steps * per_forward)
        reset_counts()
        images, seconds = fixture_requests(pipe, len(embeds), n_requests,
                                           prompt_embeds=embeds, context_mask=mask,
                                           num_inference_steps=steps,
                                           guidance_scale=guidance)
        counts = read_counts()
        del pipe
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    res = dict(requests=n_requests, bit_equal_to_phase_8a=bool(
                   np.array_equal(images, fixture_int8["images"][:len(images)])),
               s_per_request=seconds, phase_8a_s_per_request=fixture_int8["s_per_request"],
               launches=counts, expected_launches=expected, int8_layers=per_forward,
               row_parallel_layers=row_layers)
    log("fixture_int8_tp1", json.dumps(res))
    if counts != expected:
        raise AssertionError(f"fixture int8 tp1: launches {counts}, expected {expected}")
    if not res["bit_equal_to_phase_8a"]:
        raise AssertionError("fixture int8 tp1: images differ from phase 8a's")
    return res


def run_fixture_prompts(full_images, n_requests=4, steps=30, guidance=6.0) -> dict:
    """Phase 8b: the requests of phase 7 from prompts, `pipe(prompt=
    captions)` with the port's ZeroTextEncoder attached: the same
    embeddings and all-ones masks on both sides, so the images equal phase
    7's bit for bit; exactly 4 * 30 * 12 forward launches."""
    import numpy as np
    import torch

    from f_lite_tpu_torch.text.encoder import ZeroTextEncoder

    pipe, _, _, classes = load_fixture()
    pipe.text_encoder = ZeroTextEncoder(pipe.dit.config.cross_attn_input_size,
                                        seq_len=32)
    captions = fixture_captions(classes)
    expected = dit_launches(pipe.dit.config, n_requests * steps)
    reset_counts()
    images, seconds = fixture_requests(pipe, len(captions), n_requests,
                                       prompt=captions, num_inference_steps=steps,
                                       guidance_scale=guidance)
    counts = read_counts()
    res = dict(requests=n_requests, images=len(images),
               both_acc=both_acc(images, classes),
               equal_to_phase_7=bool(np.array_equal(images, full_images)),
               max_abs_diff_to_phase_7=float(np.abs(images - full_images).max()),
               s_per_request=seconds, launches=counts, expected_launches=expected)
    log("fixture_prompts", json.dumps(res))
    if counts != expected:
        raise AssertionError(f"fixture prompts: launches {counts}, expected {expected}")
    if not res["equal_to_phase_7"]:
        raise AssertionError("fixture prompts: images differ from phase 7's")
    if res["both_acc"] < 0.95:
        raise AssertionError(f"fixture prompts: both_acc {res['both_acc']} < 0.95")
    del pipe
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 8c-8d: the fixture with a LoRA merged at load; saved, reloaded and
# ingested from a diffusers-layout snapshot
# ---------------------------------------------------------------------------

def seeded_lora(cfg, rank, seed, device) -> dict:
    """Seeded factors on every qkv, q, context_kv and proj of a DiT of
    config `cfg` (the framework's tree, fp32 on `device`): a ~ N(0, 1/in),
    b ~ N(0, 0.01/rank), so a delta is about a fifth of a seeded weight."""
    import torch

    g = torch.Generator(device).manual_seed(seed)
    d = cfg.hidden_size
    out = {"qkv": 3 * d, "q": d, "context_kv": 2 * d, "proj": d}
    tree = {}
    for i in range(cfg.depth):
        attns = {"self_attn": ("qkv", "proj")}
        if cfg.block_has_cross_attn(i):
            attns["cross_attn"] = ("q", "context_kv", "proj")
        tree[f"blocks_{i}"] = {attn: {t: {
            "lora_a": torch.randn(d, rank, generator=g, device=device) / math.sqrt(d),
            "lora_b": torch.randn(rank, out[t], generator=g, device=device)
            * (0.1 / math.sqrt(rank))} for t in targets}
            for attn, targets in attns.items()}
    return tree


def lora_targets(tree) -> int:
    return sum(len(targets) for blk in tree.values() for targets in blk.values())


def write_lora(tree, root: Path) -> tuple[Path, Path]:
    """The adapter in the framework's safetensors form (the port's writer)
    and in the peft `.pt` form (`torch.save`): (st dir, pt file)."""
    import torch

    from f_lite_tpu_torch.convert.lora_torch import lora_to_peft_state_dict
    from f_lite_tpu_torch.utils.safetensors import save_file

    (root / "st").mkdir(parents=True)
    save_file({f"{b}.{attn}.{t}.{k}": v.cpu() for b, blk in tree.items()
               for attn, targets in blk.items() for t, f in targets.items()
               for k, v in f.items()}, root / "st" / "lora_weights.safetensors")
    cpu = {b: {attn: {t: {k: v.cpu().numpy() for k, v in f.items()}
                      for t, f in targets.items()} for attn, targets in blk.items()}
           for b, blk in tree.items()}
    torch.save({k: torch.from_numpy(v) for k, v in lora_to_peft_state_dict(cpu).items()},
               root / "lora_weights.pt")
    return root / "st", root / "lora_weights.pt"


def fixture_config():
    from f_lite_tpu_torch.models.dit import DiTConfig

    return DiTConfig.from_json_dict(json.loads((FIXTURE / "dit" / "config.json").read_text()))


def run_fixture_lora(full_images, tmp: Path, n_requests=4, steps=30,
                     guidance=6.0) -> dict:
    """Phase 8c: the requests of phase 7 on the fixture with a seeded rank-4
    LoRA on every target merged at load: at lora_scale 0 phase 7's images
    bit for bit; at scale 1 the safetensors and the peft forms give equal
    images, finite and not phase 7's (both_acc printed, no bar: the
    factors are random); then with quantize=True. Exact launch counts in
    each run."""
    import numpy as np
    import torch

    tree = seeded_lora(fixture_config(), rank=4, seed=5, device="cpu")
    st, pt = write_lora(tree, tmp / "fixture_lora")
    runs = {"scale_0": dict(lora_path=st, lora_scale=0.0),
            "safetensors": dict(lora_path=st), "peft_pt": dict(lora_path=pt),
            "int8": dict(lora_path=st, quantize=True)}
    res, images = {}, {}
    for name, kw in runs.items():
        pipe, embeds, mask, classes = load_fixture(**kw)
        per_forward = int8_layers(pipe.dit)
        expected = dit_launches(pipe.dit.config, n_requests * steps,
                                quantize=n_requests * steps * per_forward,
                                gemm=n_requests * steps * per_forward)
        reset_counts()
        images[name], seconds = fixture_requests(
            pipe, len(embeds), n_requests, prompt_embeds=embeds, context_mask=mask,
            num_inference_steps=steps, guidance_scale=guidance)
        counts = read_counts()
        res[name] = dict(both_acc=both_acc(images[name], classes),
                         mse_vs_phase_7=float(np.mean((images[name] - full_images) ** 2)),
                         s_per_request=seconds, launches=counts,
                         expected_launches=expected)
        if counts != expected:
            raise AssertionError(f"fixture lora {name}: launches {counts}, "
                                 f"expected {expected}")
        del pipe
        torch.cuda.empty_cache()
    res.update(rank=4, targets=lora_targets(tree),
               scale_0_equal_to_phase_7=bool(np.array_equal(images["scale_0"], full_images)),
               forms_equal=bool(np.array_equal(images["safetensors"], images["peft_pt"])))
    log("fixture_lora", json.dumps(res))
    if not res["scale_0_equal_to_phase_7"]:
        raise AssertionError("fixture lora: lora_scale=0 differs from phase 7")
    if not res["forms_equal"]:
        raise AssertionError("fixture lora: the peft and safetensors forms differ")
    if res["safetensors"]["mse_vs_phase_7"] == 0:
        raise AssertionError("fixture lora: the merged LoRA changed no image")
    return res


def write_diffusers_snapshot(dit, root: Path) -> Path:
    """A diffusers-layout snapshot of `dit` as the reference lays it out:
    `dit_model/diffusion_pytorch_model.safetensors` under the reference
    key names (the port's own, fp32) and the reference's `config.json`
    fields."""
    from f_lite_tpu_torch.utils.safetensors import save_file

    cfg = dit.config
    (root / "dit_model").mkdir(parents=True)
    save_file({k: v.float().cpu() for k, v in dit.state_dict().items()},
              root / "dit_model" / "diffusion_pytorch_model.safetensors")
    fields = ("in_channels", "patch_size", "hidden_size", "depth", "num_heads",
              "mlp_ratio", "cross_attn_input_size", "train_bias_and_rms", "use_rope",
              "rope_base", "dynamic_softmax_temperature", "residual_v",
              "adaln_mode", "cross_attn_all", "cross_attn_first_n", "cross_attn_period")
    (root / "dit_model" / "config.json").write_text(json.dumps(
        {"_class_name": "DiT", **{f: getattr(cfg, f) for f in fields}}, indent=2))
    (root / "model_index.json").write_text(json.dumps(
        {"_class_name": "FLitePipeline", "dit_model": ["f_lite.model", "DiT"]}, indent=2))
    return root


def run_fixture_save_ingest(full_images, tmp: Path, n_requests=4, steps=30,
                            guidance=6.0) -> dict:
    """Phase 8d: `save_pretrained` of the bf16 fixture, then
    `from_pretrained` of it; a diffusers-layout snapshot of the fixture
    (reference key names under `dit_model/`) through `from_pretrained`
    twice, the first load converting and caching, the second taking the
    cache. Each gives phase 7's images bit for bit, with exact launch
    counts; the convert and cached-load seconds are printed."""
    import numpy as np
    import torch

    from f_lite_tpu_torch.pipeline import FLitePipeline

    pipe = load_fixture()[0]
    t0 = time.perf_counter()
    pipe.save_pretrained(tmp / "saved")
    save_s = time.perf_counter() - t0
    del pipe
    snapshot = write_diffusers_snapshot(
        FLitePipeline.from_pretrained(FIXTURE, dtype=torch.float32, device="cpu").dit,
        tmp / "snapshot")
    cache = snapshot / "f_lite_tpu_converted" / "dit" / "flax_params.safetensors"
    res = dict(save_s=save_s)
    stamps = []
    for name, path in (("saved", tmp / "saved"), ("snapshot_convert", snapshot),
                       ("snapshot_cached", snapshot)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe, embeds, mask, classes = load_fixture(path=path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if path == snapshot:
            stamps.append(cache.stat().st_mtime_ns)
        expected = dit_launches(pipe.dit.config, n_requests * steps)
        reset_counts()
        images, _ = fixture_requests(pipe, len(embeds), n_requests, prompt_embeds=embeds,
                                     context_mask=mask, num_inference_steps=steps,
                                     guidance_scale=guidance)
        counts = read_counts()
        res[name] = dict(load_s=load_s, launches=counts, expected_launches=expected,
                         both_acc=both_acc(images, classes),
                         equal_to_phase_7=bool(np.array_equal(images, full_images)))
        if counts != expected:
            raise AssertionError(f"fixture {name}: launches {counts}, expected {expected}")
        if not res[name]["equal_to_phase_7"]:
            raise AssertionError(f"fixture {name}: images differ from phase 7's")
        del pipe
        torch.cuda.empty_cache()
    res["cache_taken"] = stamps[0] == stamps[1]
    log("fixture_save_ingest", json.dumps(res))
    if not res["cache_taken"]:
        raise AssertionError("fixture snapshot: the second load converted again")
    return res


# ---------------------------------------------------------------------------
# phases 8e-8f: the fixture through the front-ends (`generate`, `serve`)
# ---------------------------------------------------------------------------

def u8_to_signed(images):
    """uint8 images -> float [-1, 1], what `classify` reads."""
    import numpy as np

    return np.asarray(images, np.float32) / 127.5 - 1.0


def class_hits(images, classes) -> int:
    return sum(classify(img) == cls for img, cls in zip(u8_to_signed(images), classes))


def fixture_prompt_pipe(quantize=False):
    """The fixture in bf16 with what `--no_text_encoder` attaches."""
    from f_lite_tpu_torch.pipeline import FLitePipeline
    from f_lite_tpu_torch.text.encoder import PSEUDO_TEXT_LEN, ZeroTextEncoder

    pipe = FLitePipeline.from_pretrained(FIXTURE, quantize=quantize)
    pipe.text_encoder = ZeroTextEncoder(pipe.dit.config.cross_attn_input_size,
                                        seq_len=PSEUDO_TEXT_LEN)
    return pipe


def run_fixture_generate(tmp: Path, steps=30, guidance=6.0) -> dict:
    """Phase 8e: `python -m f_lite_tpu_torch.generate` on the fixture
    (`--no_text_encoder`, 64 px, 30 steps, g=6). In-process through
    `generate.main`: captions 0 and 23 at `--num_images 2` (exactly 2 * 30 *
    12 forward launches), their PNGs read back with `read_png` equal to
    `pipe(prompt=..., generator=...)` bit for bit, both_acc >= 0.95;
    `--from_png` of each caption's first file regenerates both files'
    pixels; the 24 captions' both_acc with 32 pseudo tokens (the trainer's,
    what `--no_text_encoder` attaches) and with JAX's front-ends' 128,
    printed; `--quantize` at `--num_images 1`: exactly 30 * 12 forward and
    30 * 48 launches of each int8 kernel, pixels equal to the direct int8
    call. Then once as a subprocess (started first, running beside the
    rest), bit-equal to the in-process files."""
    import numpy as np
    import torch

    from f_lite_tpu_torch import generate
    from f_lite_tpu_torch.utils.image import read_metadata, read_png

    classes = [(c, s) for c in COLORS for s in SHAPES]
    picked = [0, len(classes) - 1]
    captions = fixture_captions([classes[i] for i in picked])
    base = ["--model", str(FIXTURE), "--no_text_encoder", "--width", "64", "--height", "64",
            "--num_inference_steps", str(steps), "--guidance_scale", str(guidance)]
    t_sub = time.perf_counter()
    sub_log = open(tmp / "generate_subprocess.log", "w")
    sub_proc = subprocess.Popen(
        [sys.executable, "-m", "f_lite_tpu_torch.generate", *base, "--prompt", captions[0],
         "--num_images", "2", "--seed", "0", "--output_file", str(tmp / "sub.png")],
        cwd=ROOT, stdout=sub_log, stderr=subprocess.STDOUT)
    try:
        pipe = fixture_prompt_pipe()
        cfg = pipe.dit.config
        res = {}
        files, seconds = [], []
        reset_counts()
        for i, cap in enumerate(captions):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            files.append(generate.main(base + ["--prompt", cap, "--num_images", "2",
                                               "--seed", str(i),
                                               "--output_file", str(tmp / f"gen{i}.png")]))
            seconds.append(time.perf_counter() - t0)
        counts = read_counts()
        expected = dit_launches(cfg, len(captions) * steps)
        images = [read_png(f.read_bytes()) for fs in files for f in fs]
        direct = np.concatenate([
            pipe(prompt=cap, height=64, width=64, num_inference_steps=steps,
                 guidance_scale=guidance, num_images_per_prompt=2,
                 generator=torch.Generator("cuda").manual_seed(i)).images
            for i, cap in enumerate(captions)])
        per_image = [classes[i] for i in picked for _ in range(2)]
        res["bf16"] = dict(files=[f.name for fs in files for f in fs], s_per_call=seconds,
                           launches=counts, expected_launches=expected,
                           equal_to_direct=bool(np.array_equal(np.stack(images), direct)),
                           both_acc=class_hits(images, per_image) / len(images),
                           stamp=read_metadata(files[0][1]))
        if counts != expected:
            raise AssertionError(f"fixture generate: launches {counts}, expected {expected}")

        again = []
        for i, fs in enumerate(files):
            again += generate.main(["--from_png", str(fs[0]), "--no_text_encoder",
                                    "--output_file", str(tmp / f"re{i}.png")])
        res["from_png_equal"] = bool(np.array_equal(
            np.stack([read_png(f.read_bytes()) for f in again]), direct))
        # why `--no_text_encoder` draws the trainer's 32 pseudo tokens: the 24
        # captions with JAX's front-end length (128) beside them
        from f_lite_tpu_torch.text.encoder import PSEUDO_TEXT_LEN, ZeroTextEncoder

        res["both_acc_24_captions_by_pseudo_len"] = {}
        for seq_len in (PSEUDO_TEXT_LEN, 128):
            pipe.text_encoder = ZeroTextEncoder(cfg.cross_attn_input_size, seq_len=seq_len)
            out = pipe(prompt=fixture_captions(classes), height=64, width=64,
                       num_inference_steps=steps, guidance_scale=guidance,
                       generator=torch.Generator("cuda").manual_seed(0), output_type="np")
            res["both_acc_24_captions_by_pseudo_len"][seq_len] = both_acc(out.images, classes)
        del pipe
        torch.cuda.empty_cache()

        qpipe = fixture_prompt_pipe(quantize=True)
        per_forward = int8_layers(qpipe.dit)
        reset_counts()
        (qfile,) = generate.main(base + ["--prompt", captions[0], "--seed", "0", "--quantize",
                                         "--output_file", str(tmp / "int8.png")])
        counts = read_counts()
        expected = dit_launches(cfg, steps, quantize=steps * per_forward,
                                gemm=steps * per_forward)
        qimg = read_png(qfile.read_bytes())
        qdirect = qpipe(prompt=captions[0], height=64, width=64, num_inference_steps=steps,
                        guidance_scale=guidance,
                        generator=torch.Generator("cuda").manual_seed(0)).images[0]
        res["int8"] = dict(launches=counts, expected_launches=expected,
                           equal_to_direct=bool(np.array_equal(qimg, qdirect)),
                           both_acc=class_hits([qimg], [classes[picked[0]]]))
        del qpipe
        torch.cuda.empty_cache()
        if counts != expected:
            raise AssertionError(f"fixture generate int8: launches {counts}, expected {expected}")

        rc = sub_proc.wait(timeout=600)
        res["subprocess_s"] = time.perf_counter() - t_sub
        if rc != 0:
            raise AssertionError("generate subprocess failed: "
                                 + (tmp / "generate_subprocess.log").read_text()[-2000:])
        sub = [read_png((tmp / f"sub_{j}.png").read_bytes()) for j in (1, 2)]
        res["subprocess_equal"] = bool(np.array_equal(np.stack(sub), direct[:2]))
        log("fixture_generate", json.dumps(res))
        for key, what in (("equal_to_direct", "bf16 files differ from the direct call"),):
            if not res["bf16"][key]:
                raise AssertionError(f"fixture generate: {what}")
        if not res["int8"]["equal_to_direct"]:
            raise AssertionError("fixture generate: the int8 file differs from the direct call")
        if not res["from_png_equal"]:
            raise AssertionError("fixture generate: --from_png differs from the first run")
        if not res["subprocess_equal"]:
            raise AssertionError("fixture generate: the subprocess's files differ")
        if res["bf16"]["both_acc"] < 0.95:
            raise AssertionError(f"fixture generate: both_acc {res['bf16']['both_acc']} < 0.95")
        return res
    finally:
        stop_process(sub_proc)
        sub_log.close()


class Client:
    """urllib against a server on an ephemeral port: (status, headers,
    body) of a request, HTTP errors included."""

    def __init__(self, server):
        host, port = server.server_address[:2]
        self.base = f"http://{host}:{port}"

    def post(self, body, path="/generate"):
        import urllib.error
        import urllib.request

        req = urllib.request.Request(self.base + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                return resp.status, dict(resp.headers), resp.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()

    def get(self, path):
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(self.base + path, timeout=60) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def oversized(self) -> int:
        """A POST declaring 2 GiB and sending none of it."""
        import http.client

        host, port = self.base.rsplit("/", 1)[1].split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=60)
        conn.putrequest("POST", "/generate")
        conn.putheader("Content-Length", str(1 << 31))
        conn.endheaders()
        status = conn.getresponse().status
        conn.close()
        return status


def start_server(pipe, args):
    import threading

    from f_lite_tpu_torch import serve

    server = serve.make_http_server(pipe, args, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def stop_server(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(timeout=60)


def metric_values(text: str) -> dict:
    return dict(line.rsplit(" ", 1) for line in text.splitlines() if not line.startswith("#"))


def run_fixture_serve(tmp: Path, steps=30, guidance=6.0) -> dict:
    """Phase 8f: `python -m f_lite_tpu_torch.serve` on the fixture
    (`--no_text_encoder`, 64 px, 30 steps, g=6). Batch mode from a `.jsonl`
    of 4 captions with seeds at batch 2: exactly 2 * 30 * 12 forward
    launches, each PNG equal to the solo request with its seed bit for bit,
    the manifest's images/min printed. HTTP mode: `make_http_server` on an
    ephemeral port after `warm_up`, driven by urllib: /healthz; 4 requests,
    each PNG equal to the direct call with its seed, exactly 4 * 30 * 12
    forward launches; a 400 and a 413; /metrics counters equal to what was
    sent; a drain that finishes the request in flight and answers 503 to a
    new one."""
    import threading

    import numpy as np
    import torch

    from f_lite_tpu_torch import serve
    from f_lite_tpu_torch.utils.image import read_metadata, read_png

    classes = [(c, s) for c in COLORS for s in SHAPES]
    picked = [3, 8, 13, 18]
    rows = [dict(prompt=cap, seed=100 + j) for j, cap in
            enumerate(fixture_captions([classes[i] for i in picked]))]
    jsonl = tmp / "requests.jsonl"
    jsonl.write_text("".join(json.dumps(r) + "\n" for r in rows))
    common = ["--model", str(FIXTURE), "--no_text_encoder", "--width", "64", "--height", "64",
              "--steps", str(steps), "--guidance_scale", str(guidance)]
    pipe = fixture_prompt_pipe()
    cfg = pipe.dit.config

    def solo(r):
        return pipe(prompt=r["prompt"], height=64, width=64, num_inference_steps=steps,
                    guidance_scale=guidance, pad_context_to=128,
                    generator=torch.Generator("cuda").manual_seed(r["seed"])).images[0]

    res = {}
    reset_counts()
    manifest = serve.main(common + ["--prompts", str(jsonl), "--batch_size", "2",
                                    "--output_dir", str(tmp / "batch")])
    counts = read_counts()
    expected = dit_launches(cfg, 2 * steps)
    batch = [read_png(Path(e["file"]).read_bytes()) for e in manifest["images"]]
    want = [solo(r) for r in rows]
    res["batch"] = dict(images=len(batch), images_per_min=manifest["images_per_min"],
                        wall_s=manifest["wall_s"], launches=counts,
                        expected_launches=expected,
                        equal_to_solo=[bool(np.array_equal(a, b)) for a, b in zip(batch, want)],
                        max_abs_diff_to_solo=[int(np.abs(a.astype(int) - b).max())
                                              for a, b in zip(batch, want)],
                        both_acc=class_hits(batch, [classes[i] for i in picked]) / len(batch))
    if counts != expected:
        raise AssertionError(f"fixture serve batch: launches {counts}, expected {expected}")

    args = serve.parse_args(common + ["--http_port", "0"])
    res["warm_up_s"] = serve.warm_up(pipe, args)
    server, thread = start_server(pipe, args)
    client = Client(server)
    try:
        status, body = client.get("/healthz")
        res["healthz"] = [status, json.loads(body)]
        reset_counts()
        http_images, seconds = [], []
        for r in rows:
            t0 = time.perf_counter()
            status, headers, body = client.post(r)
            seconds.append(time.perf_counter() - t0)
            if status != 200:
                raise AssertionError(f"fixture http: {status} {body[:500]}")
            http_images.append(read_png(body))
            stamp = read_metadata(body)
        counts = read_counts()
        expected = dit_launches(cfg, len(rows) * steps)
        bad = client.post({"prompt": ""})[0]
        too_big = client.oversized()
        _, text = client.get("/metrics")
        values = metric_values(text.decode())

        # drain: a request in flight (its first forward seen) finishes,
        # a new one gets 503
        in_flight = threading.Event()
        hook = pipe.dit.register_forward_pre_hook(lambda *_: in_flight.set())
        slow = {}
        worker = threading.Thread(target=lambda: slow.update(
            zip(("status", "headers", "body"), client.post(rows[0]))))
        worker.start()
        if not in_flight.wait(120):
            raise AssertionError("fixture http: the drain's request never ran")
        hook.remove()
        server.begin_drain()
        drained = dict(new=client.post(rows[1])[0], healthz=client.get("/healthz")[0],
                       waited=server.drain_wait(120.0))
        worker.join(timeout=120)
        drained["in_flight"] = slow.get("status")
        drained["in_flight_equal"] = bool(slow.get("status") == 200 and np.array_equal(
            read_png(slow["body"]), want[0]))
    finally:
        stop_server(server, thread)
    sent = {'f_lite_requests_total{endpoint="generate",status="200"}': str(len(rows)),
            'f_lite_requests_total{endpoint="generate",status="400"}': "1",
            'f_lite_requests_total{endpoint="generate",status="413"}': "1",
            "f_lite_images_total": str(len(rows)),
            "f_lite_dispatches_total": str(len(rows))}
    res["http"] = dict(s_per_request=seconds, launches=counts, expected_launches=expected,
                       equal_to_direct=[bool(np.array_equal(a, b))
                                        for a, b in zip(http_images, want)],
                       stamp=stamp, status_400=bad, status_413=too_big,
                       metrics={k: values.get(k) for k in sent}, drain=drained)
    log("fixture_serve", json.dumps(res))
    del pipe
    torch.cuda.empty_cache()
    if not all(res["batch"]["equal_to_solo"]):
        raise AssertionError("fixture serve: a batched row differs from its solo request")
    if counts != expected:
        raise AssertionError(f"fixture http: launches {counts}, expected {expected}")
    if not all(res["http"]["equal_to_direct"]):
        raise AssertionError("fixture http: a PNG differs from the direct call")
    if res["healthz"][0] != 200 or (bad, too_big) != (400, 413):
        raise AssertionError(f"fixture http: healthz/400/413 gave {res['healthz'][0]}, "
                             f"{bad}, {too_big}")
    if res["http"]["metrics"] != sent:
        raise AssertionError(f"fixture http: metrics {res['http']['metrics']}, sent {sent}")
    if drained != dict(new=503, healthz=503, waited=True, in_flight=200,
                       in_flight_equal=True):
        raise AssertionError(f"fixture http: drain gave {drained}")
    return res


# ---------------------------------------------------------------------------
# phase 8g: the converter CLI (`python -m f_lite_tpu_torch.tools.convert_checkpoint`)
# ---------------------------------------------------------------------------

def timed_main(main, argv) -> tuple:
    """(main(argv), host seconds)."""
    t0 = time.perf_counter()
    out = main(argv)
    return out, time.perf_counter() - t0


class Recorded:
    """Keeps what each call of `owner.name` returns inside the block, and
    its host seconds."""

    def __init__(self, owner, name):
        self.owner, self.name = owner, name
        self.fn = getattr(owner, name)
        self.values, self.seconds = [], []

    def __enter__(self):
        fn = self.fn

        def recorded(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.seconds.append(time.perf_counter() - t0)
            self.values.append(out)
            return out

        setattr(self.owner, self.name, recorded)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.fn)


def available_memory_gb() -> float:
    """GB of host memory new pages can take (`MemAvailable`: free pages and
    the reclaimable cache; a tmpfs file's pages are not reclaimable)."""
    import os

    try:
        for line in Path("/proc/meminfo").read_text().splitlines():
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    except OSError:
        pass
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") / 1e9


def fs_free_gb(path: Path) -> float:
    """GB free on `path`'s file system."""
    import shutil

    return shutil.disk_usage(path).free / 1e9


def memory_tmp(need_gb: float):
    """A temporary directory in /dev/shm where it holds `need_gb` with room
    to spare in memory, else in the default temporary directory: the
    card's machine limits what a run may write to its disk (about 45 GiB,
    deleted files included), and the 7B training phases' checkpoints
    already write most of it.
    Yields (path, "tmpfs" or "disk")."""
    import contextlib
    import os

    shm = Path("/dev/shm")
    in_memory = (shm.is_dir() and os.access(shm, os.W_OK)
                 and min(fs_free_gb(shm), available_memory_gb()) > 1.5 * need_gb)

    @contextlib.contextmanager
    def scope():
        with tempfile.TemporaryDirectory(dir=shm if in_memory else None) as d:
            yield Path(d), "tmpfs" if in_memory else "disk"

    return scope()


def run_fixture_convert(full_images, tmp: Path, n_requests=4, steps=30,
                        guidance=6.0) -> dict:
    """Phase 8g (a): the fixture through the converter CLI: `--export_torch
    --pt_file`, then `--pt` of the `.pt` (`--width 256 --head_dim 64`, with
    `--test_image`) and `--hf_dir` of the export. Each ingested dir gives
    phase 7's images bit for bit with phase 7's launch counts; the
    conversions launch no kernel; `--test_image` (pixel space: latents, 4
    steps) is finite with 4 * 12 forward launches. Host seconds printed."""
    import numpy as np
    import torch

    from f_lite_tpu_torch.pipeline import FLitePipeline
    from f_lite_tpu_torch.tools import convert_checkpoint

    pt = tmp / "fixture_export.pt"
    reset_counts()
    export, export_s = timed_main(convert_checkpoint.main, [
        "--export_torch", str(FIXTURE), "--output_dir", str(tmp / "fixture_export"),
        "--pt_file", str(pt)])
    res = dict(export_s=export_s, export_launches=read_counts())
    cfg = fixture_config()
    with Recorded(FLitePipeline, "__call__") as rendered:
        reset_counts()
        from_pt, pt_s = timed_main(convert_checkpoint.main, [
            "--pt", str(pt), "--width", "256", "--head_dim", "64",
            "--output_dir", str(tmp / "fixture_from_pt"), "--test_image"])
        torch.cuda.synchronize()
        test_counts = read_counts()
    latents = rendered.values[0].images
    res["test_image"] = dict(shape=list(latents.shape),
                             finite=bool(torch.isfinite(latents.float()).all()),
                             launches=test_counts,
                             expected_launches=dit_launches(cfg, 4),
                             pt_ingest_and_render_s=pt_s)
    reset_counts()
    from_hf, hf_s = timed_main(convert_checkpoint.main, [
        "--hf_dir", str(export), "--output_dir", str(tmp / "fixture_from_hf")])
    res["hf_dir_ingest_s"] = hf_s
    res["hf_dir_ingest_launches"] = read_counts()
    for name, path in (("pt", from_pt), ("hf_dir", from_hf)):
        pipe, embeds, mask, classes = load_fixture(path=path)
        expected = dit_launches(pipe.dit.config, n_requests * steps)
        reset_counts()
        images, _ = fixture_requests(pipe, len(embeds), n_requests, prompt_embeds=embeds,
                                     context_mask=mask, num_inference_steps=steps,
                                     guidance_scale=guidance)
        counts = read_counts()
        res[name] = dict(launches=counts, expected_launches=expected,
                         both_acc=both_acc(images, classes),
                         equal_to_phase_7=bool(np.array_equal(images, full_images)))
        del pipe
        torch.cuda.empty_cache()
    log("fixture_convert", json.dumps(res))
    for name in ("export_launches", "hf_dir_ingest_launches"):
        if res[name] != launches():
            raise AssertionError(f"fixture convert: {name} {res[name]}")
    test = res["test_image"]
    if test["launches"] != test["expected_launches"] or not test["finite"] \
            or test["shape"] != [1, 256, 256, 3]:
        raise AssertionError(f"fixture convert --test_image: {test}")
    for name in ("pt", "hf_dir"):
        if res[name]["launches"] != res[name]["expected_launches"]:
            raise AssertionError(f"fixture convert {name}: launches {res[name]['launches']}")
        if not res[name]["equal_to_phase_7"]:
            raise AssertionError(f"fixture convert {name}: images differ from phase 7's")
    return res


def run_7b_convert(tmp: Path, depth=4, device="cuda") -> dict:
    """Phase 8g (b): `DiTConfig.f_lite_7b()` at `depth` (full width, the
    depth cut to fit the script's time), seeded weights saved natively,
    then `--export_torch --pt_file` and `--pt` of the `.pt` back: each
    direction's host seconds, GB written and GB/s; the re-ingested DiT's
    tensors bit-equal to the saved ones; no kernel launched. The files go
    to memory where it has room (`memory_tmp`; where they went is
    printed), else to `tmp`'s disk, whose free space is checked first.
    The weights are drawn on `device`."""
    import shutil

    import torch

    from f_lite_tpu_torch.models.dit import DiT, DiTConfig

    cfg = DiTConfig.f_lite_7b(depth=depth)
    with torch.device("meta"):
        n_params = sum(p.numel() for p in DiT(cfg).parameters())
    need_gb = 4 * n_params * 4 / 1e9  # native, export, .pt, re-ingested
    with memory_tmp(need_gb) as (root, where):
        free_gb = shutil.disk_usage(root).free / 1e9
        log("7b_convert_disk", json.dumps(dict(params=n_params, need_gb=need_gb,
                                               free_gb=free_gb, where=where)))
        if where == "disk" and free_gb < need_gb * 1.1:
            raise AssertionError(f"7B convert: {free_gb:.1f} GB free, {need_gb:.1f} needed")
        return convert_7b_in(root, where, cfg, device)


def convert_7b_in(root: Path, where: str, cfg, device) -> dict:
    """`run_7b_convert`'s DiT and conversions, its files under `root`."""
    import torch

    from f_lite_tpu_torch.models.dit import DiT
    from f_lite_tpu_torch.pipeline import FLitePipeline
    from f_lite_tpu_torch.tools import convert_checkpoint
    from f_lite_tpu_torch.utils.random_weights import randomize_
    from f_lite_tpu_torch.utils.safetensors import load_file

    with torch.device(device):
        dit = DiT(cfg)
    randomize_(dit, seed=6)
    n_params = sum(p.numel() for p in dit.parameters())
    src, pt = root / "7b_d8", root / "7b_d8.pt"
    t0 = time.perf_counter()
    FLitePipeline(dit).save_pretrained(src)
    save_s = time.perf_counter() - t0
    del dit
    torch.cuda.empty_cache()
    reset_counts()
    export, export_s = timed_main(convert_checkpoint.main, [
        "--export_torch", str(src), "--output_dir", str(root / "7b_d8_hf"),
        "--pt_file", str(pt)])
    export_gb = disk_gb(export) + pt.stat().st_size / 1e9
    back, ingest_s = timed_main(convert_checkpoint.main, [
        "--pt", str(pt), "--width", str(cfg.hidden_size), "--head_dim",
        str(cfg.head_dim), "--output_dir", str(root / "7b_d8_back")])
    ingest_gb = disk_gb(back)
    counts = read_counts()
    a = load_file(src / "dit" / "flax_params.safetensors")
    b = load_file(back / "dit" / "flax_params.safetensors")
    equal = a.keys() == b.keys() and all(a[k].dtype == b[k].dtype
                                         and a[k].tobytes() == b[k].tobytes() for k in a)
    res = dict(config=f"f_lite_7b at depth {cfg.depth} (full width; depth cut from 40)",
               params=n_params, files_in=where, save_native_s=save_s,
               export=dict(s=export_s, gb_written=export_gb, gb_per_s=export_gb / export_s),
               ingest=dict(s=ingest_s, gb_written=ingest_gb, gb_per_s=ingest_gb / ingest_s),
               tensors=len(a), bit_equal=equal, launches=counts)
    del a, b
    log("7b_convert", json.dumps(res))
    if not equal:
        raise AssertionError("7B convert: the re-ingested DiT differs from the saved one")
    if counts != launches():
        raise AssertionError(f"7B convert: launches {counts}")
    return res


# ---------------------------------------------------------------------------
# phase 8i: the fabricated 7B release (`python -m
# f_lite_tpu_torch.tools.fabricated_release_dryrun`), the pipeline of phases
# 9-11
# ---------------------------------------------------------------------------

RELEASE_MANIFEST = "freepik-f-lite-7b"
RELEASE_KEYS = 399
RELEASE_PARAMS = 4_749_401_703


def release_files_gb() -> float:
    """GB of the release's fp32 files: the snapshot (the DiT and the Flux
    VAE) and its conversion."""
    import torch

    from f_lite_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    with torch.device("meta"):
        vae = sum(p.numel() for p in AutoencoderKL(VAEConfig.flux()).parameters())
    return 2 * 4 * (RELEASE_PARAMS + vae) / 1e9


def start_release_ingest(stack) -> dict:
    """Phase 8i (a): the tool's `--convert_only` run as a subprocess on the
    card, its work dir in memory (`memory_tmp`, closed by `stack`): the
    full 7B manifest fabricated there (depth 40) and ingested with strict
    key coverage. A thread of this process waits for it and then loads the
    pipeline of phases 9-11: `from_pretrained` in bf16 of the tool's strict
    `resolve_pretrained` of the snapshot, which takes the cache. Both run
    beside phases 7-12c. The files (about 39 GB) must fit in memory: on
    the disk they would use up the run's write limit, so the phase fails
    with the figures instead."""
    import os

    import torch

    from f_lite_tpu_torch.pipeline import FLitePipeline
    from f_lite_tpu_torch.tools import fabricated_release_dryrun as release

    need_gb = release_files_gb()
    root, where = stack.enter_context(memory_tmp(need_gb))
    figures = dict(need_gb=need_gb, available_gb=available_memory_gb(),
                   shm_free_gb=fs_free_gb(Path("/dev/shm")), where=where)
    log("release_7b_files", json.dumps(figures))
    if where != "tmpfs":
        raise AssertionError(f"8i: the release's files do not fit in memory: {figures}")
    job = dict(snapshot=root / "release" / "snapshot", out=root / "release_report.json",
               log=root / "release_convert.log", files=figures,
               strict_before=os.environ.get("F_LITE_STRICT_INGEST"))
    cmd = [sys.executable, "-m", "f_lite_tpu_torch.tools.fabricated_release_dryrun",
           "--manifest", RELEASE_MANIFEST, "--workdir", str(root / "release"),
           "--out", str(job["out"]), "--convert_only", "--device", "cuda"]
    log_file = stack.enter_context(open(job["log"], "w"))
    job["t0"] = time.perf_counter()
    job["proc"] = subprocess.Popen(cmd, stdout=log_file, stderr=subprocess.STDOUT, cwd=ROOT)

    def chain():
        try:
            rc = job["proc"].wait()
            job["subprocess_s"] = time.perf_counter() - job["t0"]
            if rc != 0:
                raise AssertionError(f"8i: the tool's --convert_only run exit {rc}:\n"
                                     f"{job['log'].read_text()[-4000:]}")
            job["report"] = json.loads(job["out"].read_text())
            job["fingerprint"] = (job["snapshot"] / "f_lite_tpu_converted"
                                  / "source_fingerprint.json")
            job["stamp"] = job["fingerprint"].stat().st_mtime_ns
            t0 = time.perf_counter()
            native, resolve_s = release.convert(job["snapshot"])
            pipe = FLitePipeline.from_pretrained(native, dtype=torch.bfloat16)
            torch.cuda.synchronize()
            job.update(pipe=pipe, native=native, resolve_s=resolve_s,
                       load_s=time.perf_counter() - t0,
                       loaded_at_s=time.perf_counter() - job["t0"])
        except BaseException as e:  # raised again where the thread is joined
            job["error"] = e

    def stop():
        if job["proc"].poll() is None:
            job["proc"].kill()
            job["proc"].wait()

    job["loader"] = threading.Thread(target=chain, daemon=True)
    job["loader"].start()
    stack.callback(job["loader"].join)
    stack.callback(stop)  # runs first on a failure, so the join is short
    return job


def finish_release_ingest(job: dict) -> tuple:
    """Phase 8i (b): the loading thread joined; the tool's report (strict
    ingest of 399 keys, 4,749,401,703 parameters; fabricate and convert
    seconds), the cache taken (its fingerprint file untouched),
    F_LITE_STRICT_INGEST given back, the DiT's 399 tensors bf16 and finite,
    peak under 80 GB. The load ran beside phases that launch kernels, so
    it is not launch-counted. Returns (the pipeline, the figures)."""
    import os

    import torch

    t = time.perf_counter()
    job["loader"].join()
    if "error" in job:
        raise job["error"]
    report, pipe = job["report"], job.pop("pipe")
    res = dict(files=job["files"], waited_s=time.perf_counter() - t,
               subprocess_s=job["subprocess_s"], tool=report,
               cached_load_s=job["load_s"], cached_resolve_s=job["resolve_s"],
               loaded_at_s=job["loaded_at_s"], beside="phases 7-12c")
    sd = pipe.dit.state_dict()
    res.update(keys=len(sd), params=sum(v.numel() for v in sd.values()),
               dtypes=sorted({str(v.dtype) for v in sd.values()}),
               finite=all(bool(torch.isfinite(v).all()) for v in sd.values()),
               converted_gb=disk_gb(job["native"]), cache_taken=(
                   job["native"] == job["fingerprint"].parent
                   and job["fingerprint"].stat().st_mtime_ns == job["stamp"]),
               strict_env_restored=(os.environ.get("F_LITE_STRICT_INGEST")
                                    == job["strict_before"]),
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    del sd
    log("release_7b_ingest", json.dumps(res))
    if report.get("strict_ingest") != "error" or not report["status"].startswith("converted"):
        raise AssertionError(f"8i: the tool's report {report}")
    if (report["dit_keys"], report["dit_params"]) != (RELEASE_KEYS, RELEASE_PARAMS) \
            or (res["keys"], res["params"]) != (RELEASE_KEYS, RELEASE_PARAMS):
        raise AssertionError(f"8i: {report['dit_keys']} keys / {report['dit_params']} "
                             f"parameters fabricated, {res['keys']} / {res['params']} loaded")
    if not (res["cache_taken"] and res["strict_env_restored"] and res["finite"]):
        raise AssertionError(f"8i: cache taken {res['cache_taken']}, F_LITE_STRICT_INGEST "
                             f"restored {res['strict_env_restored']}, finite {res['finite']}")
    if res["dtypes"] != ["torch.bfloat16"]:
        raise AssertionError(f"8i: dtypes {res['dtypes']}")
    if not res["max_memory_allocated_gb"] < 80:
        raise AssertionError(f"8i: peak {res['max_memory_allocated_gb']} GB")
    return pipe, res


def run_release_serve(pipe, tmp: Path, size=1024, steps=30, repeats=2) -> dict:
    """Phase 8i (c), after phase 11a: the tool's serve step
    (`fabricated_release_dryrun.serve`) on phase 11a's int8 pipeline, the
    JAX tool's embeddings (seed 0, 128 rows), `repeats` images of `size` px
    in `steps` steps: finite, exactly `repeats` x 30 x 56 forward and
    `repeats` x 30 x 248 launches of each int8 kernel, the sample PNG read
    back at its size, peak under 80 GB; p50 s/image."""
    import torch

    from f_lite_tpu_torch.tools import fabricated_release_dryrun as release
    from f_lite_tpu_torch.utils.image import read_png

    n_int8 = int8_layers(pipe.dit)
    expected = dit_launches(pipe.dit.config, repeats * steps,
                            quantize=repeats * steps * n_int8, gemm=repeats * steps * n_int8)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = release.serve(pipe, size=size, steps=steps, seed=0, repeats=repeats,
                        png=tmp / release.SAMPLE_PNG)
    res.update(launches=read_counts(), expected_launches=expected,
               png_shape=list(read_png(Path(res["sample_png"]).read_bytes()).shape),
               hbm=release.device_memory(torch.device("cuda")))
    log("release_7b_serve", json.dumps(res))
    if res["launches"] != expected or not res["finite"] \
            or res["png_shape"] != [size, size, 3]:
        raise AssertionError(f"8i serve: launches {res['launches']}, expected {expected}, "
                             f"finite {res['finite']}, png {res['png_shape']}")
    if not res["hbm"]["max_memory_allocated_gb"] < 80:
        raise AssertionError(f"8i serve: peak {res['hbm']['max_memory_allocated_gb']} GB")
    return res


# ---------------------------------------------------------------------------
# phases 9-11: serving at 7B width (the release of phase 8i: DiT f_lite_7b +
# the Flux VAE, seeded random weights through the released layout)
# ---------------------------------------------------------------------------

def text_7b(pipe, text_len=128, real_len=77):
    """128 text rows of which the first 77 are real, seeded."""
    import numpy as np

    rs = np.random.RandomState(3)
    embeds = (rs.randn(1, text_len, pipe.dit.config.cross_attn_input_size)
              * 0.02).astype(np.float32)
    return embeds, np.arange(text_len)[None, :] < real_len


def int8_layers(dit) -> int:
    """The DiT's QuantDense layers: launches of each int8 kernel a forward."""
    from f_lite_tpu_torch.models.dit import QuantDense

    return sum(isinstance(m, QuantDense) for m in dit.modules())


def run_7b(pipe, steps=30, guidance=6.0, size=1024, label="7b", profile=True) -> dict:
    """Phase 9 (and 9d with a LoRA, 11a on the quantized pipeline): text to
    image at 1024 px, 30 steps, g=6; a step profile where `profile`."""
    import numpy as np
    import torch

    vae = pipe.vae
    embeds, mask = text_7b(pipe)
    expected = dit_launches(pipe.dit.config, steps,
                            quantize=steps * int8_layers(pipe.dit),
                            gemm=steps * int8_layers(pipe.dit))

    marks = {}
    finite = []

    def pre_decode(_m, inp):
        torch.cuda.synchronize()
        marks["decode_start"] = time.perf_counter()
        marks["final"] = inp[0].detach().float()  # the final latents, denormalized

    def post_decode(_m, _inp, out):
        finite.append(bool(torch.isfinite(out).all()))
        torch.cuda.synchronize()
        marks["decode_end"] = time.perf_counter()

    hooks = [vae.decoder.register_forward_pre_hook(pre_decode),
             vae.decoder.register_forward_hook(post_decode)]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = pipe(prompt_embeds=embeds, context_mask=mask, height=size, width=size,
               num_inference_steps=steps, guidance_scale=guidance,
               generator=torch.Generator("cuda").manual_seed(4),
               output_type="uint8")
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = read_counts()
    for hk in hooks:
        hk.remove()

    img = out.images
    denoise_s = marks["decode_start"] - t0
    # the int8 DiT holds its projections' weights as buffers (w8, scale)
    res = dict(params=sum(t.numel() for t in (*pipe.dit.parameters(),
                                               *pipe.dit.buffers())),
               image=list(img.shape), dtype=str(img.dtype),
               s_per_step=denoise_s / steps, decode_s=marks["decode_end"] - marks["decode_start"],
               s_per_image=total, max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=counts["fwd"], counts=counts, expected_launches=expected,
               decoded_finite=finite == [True])
    log(label, json.dumps(res))
    if img.shape != (1, size, size, 3) or img.dtype != np.uint8:
        raise AssertionError(f"{label} image {img.shape} {img.dtype}")
    if finite != [True]:
        raise AssertionError(f"{label} decoded image holds NaN or Inf")
    if counts != expected:
        raise AssertionError(f"{label}: launches {counts}, expected {expected}")
    if profile:
        res["step_profile"] = profile_step(
            lambda: pipe(prompt_embeds=embeds, context_mask=mask, height=size,
                         width=size, num_inference_steps=1,
                         guidance_scale=guidance, output_type="latent"),
            label=f"{label} step_profile")
    res["final"] = marks["final"]  # phase 9f's reference (not logged)
    torch.cuda.empty_cache()
    return res


def run_7b_lora(pipe, big, steps=30, guidance=6.0, size=1024, rank=64) -> dict:
    """Phase 9d: phase 9's request with a seeded rank-64 LoRA on every
    target, merged by `train.lora.apply_lora` (what `from_pretrained`
    merges with) into a copy of phase 9's DiT, the original parked on the
    host meanwhile so that the peak is this DiT's: finite, exactly 30 * 56
    forward launches; merge s, s/image and peak GB beside phase 9's; then
    `return_latents=True` equal to `output_type="latent"` bit for bit."""
    import copy

    import torch

    from f_lite_tpu_torch.pipeline import FLitePipeline
    from f_lite_tpu_torch.train.lora import apply_lora, lora_rank

    dit = copy.deepcopy(pipe.dit)
    pipe.dit.to("cpu")
    torch.cuda.empty_cache()
    tree = seeded_lora(dit.config, rank=rank, seed=6, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    merged = apply_lora(dit, tree, alpha=lora_rank(tree), rank=lora_rank(tree))
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    n_targets = lora_targets(tree)
    del tree
    lpipe = FLitePipeline(dit, pipe.vae)
    res = run_7b(lpipe, steps, guidance, size, label="7b_lora_request", profile=False)
    embeds, mask = text_7b(lpipe)
    kw = dict(prompt_embeds=embeds, context_mask=mask, height=size, width=size,
              num_inference_steps=2, guidance_scale=guidance)
    host = lpipe(**kw, generator=torch.Generator("cuda").manual_seed(7),
                 return_latents=True).images
    device = lpipe(**kw, generator=torch.Generator("cuda").manual_seed(7),
                   output_type="latent").images
    res.update(rank=rank, merged=merged, targets=n_targets, merge_s=merge_s,
               return_latents_equal=bool(host.device.type == "cpu"
                                         and torch.equal(host, device.cpu())),
               return_latents_dtype=str(host.dtype),
               phase_9=dict(s_per_image=big["s_per_image"], s_per_step=big["s_per_step"],
                            max_memory_allocated_gb=big["max_memory_allocated_gb"]))
    res.pop("final")
    log("7b_lora", json.dumps({k: v for k, v in res.items() if k != "counts"}))
    del lpipe, dit, host, device
    torch.cuda.empty_cache()
    pipe.dit.to("cuda")
    if merged != n_targets:
        raise AssertionError(f"7b lora: {merged} weights merged, expected {n_targets}")
    if not res["return_latents_equal"]:
        raise AssertionError("7b lora: return_latents differs from output_type='latent'")
    return res


def run_7b_padded(pipe, big) -> dict:
    """Phase 9f, first part: phase 9's DiT padded from 10 to 12 heads
    (`pad_dit_heads`, what `from_pretrained(pad_heads_to=12)` does) with
    the original parked on the host: phase 9's request, its final latents
    within the forward kernel's tolerance of phase 9's and 30 * 56
    forward launches as unpadded; then the padded DiT quantized in place
    and the request again (its final latents kept for the comparison with
    phase 11a). s/image and peak GB beside phase 9's."""
    import torch

    from f_lite_tpu_torch.convert.heads import pad_dit_heads
    from f_lite_tpu_torch.ops.cuda import flash_attention as fa
    from f_lite_tpu_torch.pipeline import FLitePipeline
    from f_lite_tpu_torch.quant import quantize_dit

    t0 = time.perf_counter()
    dit = pad_dit_heads(pipe.dit, 12)
    torch.cuda.synchronize()
    pad_s = time.perf_counter() - t0
    pipe.dit.to("cpu")  # the padded copy keeps what it shares on the card
    torch.cuda.empty_cache()
    ppipe = FLitePipeline(dit, pipe.vae)
    res = {"pad_s": pad_s, "heads": dit.config.compute_heads}
    for label in ("bf16", "int8"):
        if label == "int8":
            quantize_dit(dit)
        run = run_7b(ppipe, label=f"7b_padded_{label}", profile=False)
        res[label] = {k: run[k] for k in ("s_per_step", "s_per_image",
                                          "max_memory_allocated_gb", "counts",
                                          "expected_launches")}
        res[label]["final"] = run["final"]
    ref = big["final"]
    gap = float((res["bf16"]["final"] - ref).abs().max())
    res["bf16"].update(max_abs_err_vs_phase_9=gap,
                       tolerance=fa.tolerance(ref, torch.bfloat16),
                       phase_9=dict(s_per_image=big["s_per_image"],
                                    max_memory_allocated_gb=big["max_memory_allocated_gb"]))
    log("7b_padded", json.dumps({k: ({kk: vv for kk, vv in v.items() if kk != "final"}
                                     if isinstance(v, dict) else v) for k, v in res.items()}))
    del ppipe, dit
    torch.cuda.empty_cache()
    pipe.dit.to("cuda")
    if not gap <= res["bf16"]["tolerance"]:
        raise AssertionError(f"7b padded: final latents {gap} from phase 9's, "
                             f"tolerance {res['bf16']['tolerance']}")
    return res


def check_7b_padded_int8(padded, big_int8) -> dict:
    """Phase 9f's int8 comparison, after phase 11a: the padded int8 DiT's
    final latents against phase 11a's, within the forward kernel's
    tolerance (the gap and whether they are bit-equal printed)."""
    import torch

    from f_lite_tpu_torch.ops.cuda import flash_attention as fa

    got, ref = padded["int8"]["final"], big_int8["final"]
    res = dict(max_abs_err_vs_phase_11a=float((got - ref).abs().max()),
               tolerance=fa.tolerance(ref, torch.bfloat16),
               bit_equal_to_phase_11a=bool(torch.equal(got, ref)),
               s_per_image=padded["int8"]["s_per_image"],
               phase_11a_s_per_image=big_int8["s_per_image"])
    log("7b_padded_int8", json.dumps(res))
    if not res["max_abs_err_vs_phase_11a"] <= res["tolerance"]:
        raise AssertionError(f"7b padded int8: {res}")
    return res


class SavedServer:
    """Phase 9f, second part: phase 9's pipeline saved (in `tmp`), a
    precompute cache of PROMPT's embedding (the ZeroTextEncoder of phase
    9e, 77 tokens), and `torchrun --nproc_per_node 1 -m
    f_lite_tpu_torch.serve --dp 1 --tp 1 --http_port 0` on them (warmed at
    256 px, 2 steps; TF32 off, as in this process). `finish`: phase 9e's request (1024 px, 30 steps, seed 4)
    answers phase 9e's pixels bit for bit (the cache pads the 77 tokens to
    80, so the unconditional branch attends to 80 identical zero-context
    keys where phase 9e's attends to 77: the same average), with no launch
    in this process meanwhile; /healthz; SIGTERM drains it. The save, load,
    warm-up and request seconds are printed. `stop` ends the server and its
    worker wherever they are."""

    def __init__(self, pipe, tmp: Path, guidance=6.0):
        import os

        import numpy as np

        from f_lite_tpu_torch.data.precomputed import PrecomputedCacheWriter
        from f_lite_tpu_torch.pipeline import FLitePipeline
        from f_lite_tpu_torch.text.encoder import ZeroTextEncoder

        self.model, cache = tmp / "7b_pipeline", tmp / "7b_prompt_cache"
        t0 = time.perf_counter()
        FLitePipeline(pipe.dit, pipe.vae).save_pretrained(self.model)
        self.res = {"save_s": time.perf_counter() - t0}
        emb, _ = ZeroTextEncoder(pipe.dit.config.cross_attn_input_size,
                                 seq_len=77).encode([PROMPT])
        writer = PrecomputedCacheWriter(cache)
        writer.add("0", PROMPT, np.zeros((1, 1, 1), np.float32), emb[0])
        writer.finalize()
        self.log_path = tmp / "serve_tp1.log"
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", "-m", "f_lite_tpu_torch.serve",
               "--model", str(self.model), "--precomputed_dir", str(cache),
               "--http_port", "0", "--dp", "1", "--tp", "1", "--text_bucket", "128",
               "--width", "256", "--height", "256", "--steps", "2",
               "--guidance_scale", str(guidance)]
        # TF32 off in the server as in this process (cuDNN's default is on,
        # and the VAE's fp32 convolutions would round otherwise)
        env = {**os.environ, "NVIDIA_TF32_OVERRIDE": "0"}
        self.t0 = time.perf_counter()
        with open(self.log_path, "w") as lf:
            # its own process group: torchrun's worker is stopped with it
            self.proc = subprocess.Popen(cmd, stdout=lf, stderr=subprocess.STDOUT,
                                         cwd=ROOT, env=env, start_new_session=True)
        # the load and ready seconds, read off its log while other phases run
        self.marks = {"loaded_s": "DiT split over 1 ranks (dp=1, tp=1)",
                      "ready_s": "serving on http://"}
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self) -> None:
        while "ready_s" not in self.res and time.perf_counter() - self.t0 < 600 \
                and self.proc.poll() is None:
            text = self.log_path.read_text()
            for key, mark in self.marks.items():
                if key not in self.res and mark in text:
                    self.res[key] = time.perf_counter() - self.t0
            time.sleep(0.2)

    def stop(self, sig=None) -> None:
        import os
        import shutil
        import signal

        if self.proc.poll() is None:
            os.killpg(self.proc.pid, sig or signal.SIGKILL)
            try:
                self.proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                os.killpg(self.proc.pid, signal.SIGKILL)
                self.proc.wait()
        shutil.rmtree(self.model, ignore_errors=True)

    def finish(self, big_http, size=1024, steps=30) -> dict:
        import re
        import signal
        import types

        import numpy as np

        from f_lite_tpu_torch.utils.image import read_png

        res, proc, marks = self.res, self.proc, self.marks
        t_here = time.perf_counter()
        try:
            while "ready_s" not in res and time.perf_counter() - self.t0 < 600:
                if proc.poll() is not None:
                    raise AssertionError(f"serve tp1 exited {proc.returncode}")
                time.sleep(0.2)
            res["waited_here_s"] = time.perf_counter() - t_here
            text = self.log_path.read_text()
            found = re.search(r"serving on http://[\d.]+:(\d+)", text)
            if found is None:
                raise AssertionError("serve tp1: not serving after 600 s")
            warm = re.search(r"warm-up: ([\d.]+) s", text)
            res["warm_up_s"] = float(warm.group(1)) if warm else None
            client = Client(types.SimpleNamespace(server_address=("127.0.0.1",
                                                                   int(found.group(1)))))
            reset_counts()
            t1 = time.perf_counter()
            status, headers, body = client.post({"prompt": PROMPT, "seed": 4, "width": size,
                                                 "height": size, "steps": steps})
            res["s_per_request"] = time.perf_counter() - t1
            res["parent_launches"] = read_counts()
            if status != 200:
                raise AssertionError(f"serve tp1: {status} {body[:500]}")
            img = read_png(body)
            res.update(bit_equal_to_phase_9e=bool(np.array_equal(img, big_http["image"])),
                       max_abs_diff_to_phase_9e=int(np.abs(img.astype(np.int16)
                                                           - big_http["image"]).max()),
                       phase_9e_s_per_request=big_http["request"]["s_per_request"],
                       server_s=float(headers["X-F-Lite-Seconds"]))
            _, health = client.get("/healthz")
            res["healthz"] = json.loads(health)
            self.stop(signal.SIGTERM)  # torchrun and its worker drain and stop
        finally:
            self.stop()
            text = self.log_path.read_text()
            res.update(exit_code=proc.returncode, drained="drained; shutting down" in text,
                       split_over_tp=marks["loaded_s"] in text)
            log("7b_serve_tp1", json.dumps(res))
        if not (res.get("bit_equal_to_phase_9e") and res["drained"] and res["split_over_tp"]):
            raise AssertionError(f"serve tp1: {res}\n{text[-3000:]}")
        if res["healthz"].get("tp") != 1 or res["healthz"].get("dp") != 1:
            raise AssertionError(f"serve tp1: healthz {res['healthz']}")
        if any(res["parent_launches"].values()):
            raise AssertionError(f"serve tp1: launches in this process {res['parent_launches']}")
        return res


def start_7b_serve(pipe, tmp: Path) -> SavedServer:
    return SavedServer(pipe, tmp)


def finish_7b_serve(server: SavedServer, big_http) -> dict:
    return server.finish(big_http)


def expected_window_calls(steps: int, k: int) -> list:
    """The (e, n) calls of JAX's `make_denoise_fn` callback for one segment
    of `steps` rows in windows of k (`f_lite_tpu/sampling/euler.py:417-441`):
    own copy of the rule."""
    return [(min(e, steps), steps) for e in range(k, steps + k, k)]


def filtered_png(image, kind) -> bytes:
    """uint8 (H, W, 3) as a PNG whose rows all take filter `kind` (0-4), or
    with kind "adaptive" each row the filter whose bytes, read as signed,
    have the least absolute sum (the choice libpng and PIL make)."""
    import struct
    import zlib

    import numpy as np

    h, w, _ = image.shape
    x = image.reshape(h, w * 3).astype(np.int16)
    a = np.zeros_like(x)
    a[:, 3:] = x[:, :-3]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 3:] = x[:-1, :-3]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = [np.zeros_like(x), a, b, (a + b) >> 1, paeth]
    rows = np.stack([(x - pred) & 255 for pred in preds]).astype(np.uint8)  # (5, h, 3w)
    kinds = (np.abs(rows.view(np.int8).astype(np.int32)).sum(-1).argmin(0)
             if kind == "adaptive" else np.full(h, kind))
    out = np.empty((h, w * 3 + 1), np.uint8)
    out[:, 0] = kinds
    out[:, 1:] = rows[kinds, np.arange(h)]

    def chunk(t, d):
        return struct.pack(">I", len(d)) + t + d + struct.pack(">I", zlib.crc32(t + d))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(out.tobytes(), 6)) + chunk(b"IEND", b""))


def run_7b_http(pipe, big, size=1024, steps=30, guidance=6.0) -> dict:
    """Phase 9e: phase 9's pipeline behind `serve.make_http_server`, with the
    port's ZeroTextEncoder of the 7B's context width (77 tokens) and
    --text_bucket 128, warmed by `serve.warm_up` (run_http's path) first:
    one 1024 px, 30-step request, a finite image and exactly 30 * 56
    forward launches, the client's s/request beside phase 9's s/image, the
    PNG's encode and decode ms; an image-to-image request with a base64
    PNG (256 px, 4 steps, strength 0.5), equal to the direct call bit for
    bit with exactly 2 * 56 launches. Then `steps_per_dispatch=5` with a
    callback on 2- and 6-step trajectories, Euler and ab2: final latents
    bit-equal to one window and JAX's (e, n) calls; a callback that cancels
    after the first window: exactly 5 * 56 forward launches."""
    import base64

    import numpy as np
    import torch

    from f_lite_tpu_torch import serve
    from f_lite_tpu_torch.text.encoder import ZeroTextEncoder
    from f_lite_tpu_torch.utils.image import png_bytes_with_metadata, read_png

    pipe.text_encoder = ZeroTextEncoder(pipe.dit.config.cross_attn_input_size, seq_len=77)
    cfg = pipe.dit.config
    args = serve.parse_args(["--model", "seeded f_lite_7b + Flux VAE", "--http_port", "0",
                             "--text_bucket", "128", "--width", str(size), "--height",
                             str(size), "--steps", str(steps), "--guidance_scale",
                             str(guidance), "--device", "cuda"])
    finite = []
    hook = pipe.vae.decoder.register_forward_hook(
        lambda _m, _i, out: finite.append(bool(torch.isfinite(out).all())))
    res = {}
    try:
        res["warm_up_s"] = serve.warm_up(pipe, args)
        server, thread = start_server(pipe, args)
        client = Client(server)
        try:
            finite.clear()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            status, headers, body = client.post({"prompt": PROMPT, "seed": 4})
            s_request = time.perf_counter() - t0
            counts = read_counts()
            if status != 200:
                raise AssertionError(f"7b http: {status} {body[:500]}")
            t0 = time.perf_counter()
            img = read_png(body)
            decode_ms = 1e3 * (time.perf_counter() - t0)
            t0 = time.perf_counter()
            png_bytes_with_metadata(img, {"prompt": PROMPT, "seed": 4})
            encode_ms = 1e3 * (time.perf_counter() - t0)
            decode_by_filter = {}
            for kind, name in (("adaptive", "adaptive"), (3, "average"), (4, "paeth")):
                data = filtered_png(img, kind)
                t0 = time.perf_counter()
                again = read_png(data)
                decode_by_filter[name] = 1e3 * (time.perf_counter() - t0)
                if not np.array_equal(again, img):
                    raise AssertionError(f"7b http: read_png of the {name} file differs")
            expected = dit_launches(cfg, steps)
            res["request"] = dict(
                s_per_request=s_request, server_s=float(headers["X-F-Lite-Seconds"]),
                phase_9_s_per_image=big["s_per_image"], image=list(img.shape),
                png_bytes=len(body), png_encode_ms=encode_ms, png_decode_ms=decode_ms,
                png_decode_ms_by_filter=decode_by_filter,
                max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                launches=counts, expected_launches=expected, decoded_finite=finite == [True])
            if img.shape != (size, size, 3) or finite != [True]:
                raise AssertionError(f"7b http: image {img.shape}, finite {finite}")
            if counts != expected:
                raise AssertionError(f"7b http: launches {counts}, expected {expected}")
            res["image"] = img  # phase 9f's reference (not logged)

            small = 256
            source = np.random.RandomState(8).randint(0, 256, (small, small, 3)).astype(np.uint8)
            req = {"prompt": PROMPT, "seed": 5, "width": small, "height": small, "steps": 4,
                   "strength": 0.5, "image": base64.b64encode(png_bytes_with_metadata(source)).decode()}
            reset_counts()
            status, _, body = client.post(req)
            counts = read_counts()
            if status != 200:
                raise AssertionError(f"7b http img2img: {status} {body[:500]}")
            direct = pipe(prompt=PROMPT, height=small, width=small, num_inference_steps=4,
                          guidance_scale=guidance, pad_context_to=128, image=source,
                          strength=0.5, generator=torch.Generator("cuda").manual_seed(5))
            res["img2img"] = dict(launches=counts, expected_launches=dit_launches(cfg, 2),
                                  equal_to_direct=bool(np.array_equal(read_png(body),
                                                                      direct.images[0])))
            if counts != dit_launches(cfg, 2) or not res["img2img"]["equal_to_direct"]:
                raise AssertionError(f"7b http img2img: {res['img2img']}")
        finally:
            stop_server(server, thread)
    finally:
        hook.remove()

    embeds, mask = text_7b(pipe)
    kw = dict(prompt_embeds=embeds, context_mask=mask, height=size, width=size,
              guidance_scale=guidance, output_type="latent")
    windows = {}
    for n in (2, 6):
        for sampler in ("euler", "ab2"):
            calls = []
            got = pipe(**kw, num_inference_steps=n, sampler=sampler, steps_per_dispatch=5,
                       callback=lambda e, total: calls.append((e, total)),
                       generator=torch.Generator("cuda").manual_seed(9)).images
            one = pipe(**kw, num_inference_steps=n, sampler=sampler, steps_per_dispatch=0,
                       generator=torch.Generator("cuda").manual_seed(9)).images
            windows[f"{sampler}@{n}"] = dict(
                bitwise_equal=bool(torch.equal(got, one)), calls=calls,
                expected_calls=expected_window_calls(n, 5),
                finite=bool(torch.isfinite(got).all()))
    reset_counts()
    cancel_calls = []
    out = pipe(prompt_embeds=embeds, context_mask=mask, height=size, width=size,
               num_inference_steps=6, guidance_scale=guidance, steps_per_dispatch=5,
               callback=lambda e, total: cancel_calls.append((e, total)) or True,
               generator=torch.Generator("cuda").manual_seed(9))
    counts = read_counts()
    res["windows"] = windows
    res["cancel"] = dict(calls=cancel_calls, launches=counts,
                         expected_launches=dit_launches(cfg, 5),
                         image=list(out.images.shape))
    pipe.text_encoder = None
    log("7b_http", json.dumps({k: v for k, v in res.items() if k != "image"}))
    torch.cuda.empty_cache()
    for name, w in windows.items():
        if not (w["bitwise_equal"] and w["finite"]
                and [tuple(c) for c in w["calls"]] == w["expected_calls"]):
            raise AssertionError(f"7b windows {name}: {w}")
    if counts != dit_launches(cfg, 5) or cancel_calls != [(5, 6)]:
        raise AssertionError(f"7b cancel: {res['cancel']}")
    return res



# ---------------------------------------------------------------------------
# phases 9a-9c: the text towers at full width (seeded weights, token ids
# made here: the card's machine has no tokenizer), and a 7B-width request
# from a prompt
# ---------------------------------------------------------------------------

class WordTokenizer:
    """Whitespace words -> seeded ids in [2, vocab), then the end id 1,
    right-padded with 0: the subset of the HF tokenizer call the port's
    text encoders make (`padding="longest"`, `pad_to_multiple_of`,
    `max_length`, `truncation`, `return_tensors="np"`)."""

    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab_size, self.seed = vocab_size, seed

    def word_id(self, word: str) -> int:
        import hashlib

        h = int(hashlib.md5(f"{self.seed}:{word}".encode()).hexdigest()[:8], 16)
        return 2 + h % (self.vocab_size - 2)

    def __call__(self, texts, padding="longest", pad_to_multiple_of=None,
                 max_length=None, truncation=False, return_tensors=None):
        from f_lite_tpu_torch.text.encoder import _pad_to_multiple

        if padding not in ("longest", True) or return_tensors != "np":
            raise ValueError("WordTokenizer pads to the longest and returns numpy")
        seqs = [[self.word_id(w) for w in t.split()] + [1] for t in texts]
        if max_length is not None and not truncation and max(map(len, seqs)) > max_length:
            raise ValueError("a text is longer than max_length")
        ids, mask = _pad_to_multiple(seqs, 0, pad_to_multiple_of or 1,
                                     max_length or max(map(len, seqs)))
        return {"input_ids": ids.astype("int64"), "attention_mask": mask.astype("int64")}


def tower_bound_ms(stack, n_run, tokens) -> tuple:
    """(bound ms, what bounds it) of an encode that runs the first `n_run`
    blocks over `tokens` (B, S): their bf16 weights read once at 3.35 TB/s
    against their products at 989 TFLOP/s (2 flops a weight a token, and
    the score and value products, 4 S x inner a token a block)."""
    blocks = (stack.encoder.block if hasattr(stack, "encoder") else stack.layers)[:n_run]
    weights = sum(p.numel() for blk in blocks for p in blk.parameters() if p.dim() == 2)
    cfg = stack.config
    inner = (cfg.num_heads * cfg.d_kv if hasattr(cfg, "d_kv")
             else cfg.num_attention_heads * cfg.head_dim_)
    b, s = tokens
    flops = 2 * weights * b * s + n_run * 4 * b * s * s * inner
    t_bytes = 2 * weights / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def run_text_tower(kind, return_index=-8) -> tuple:
    """Phase 9a (kind "t5": T5-XXL, `T5Config()`) or 9b ("qwen2": the
    Qwen2.5-VL-7B language tower, `Qwen2Config()`): the tower with seeded
    bf16 weights on the card, and the same weights in fp32 (TF32 off;
    `text_precision.tower_pair`).
    On every input, at return_index -8: shape (B, S, width), finite, the
    bf16 weights' result within `flash_attention.tolerance` (5% of the fp32
    result's rms) of the fp32 one on the real rows; the single prompt's
    real rows within that bar of themselves padded further; of the port's
    kernels only the norm's launched, `tower_norms` a forward. Encode ms (CUDA events, median of 10) of the single
    prompt and of the batch beside the bound, and peak GB. Returns
    (result, the bf16 tower)."""
    import torch

    from f_lite_tpu_torch.ops.cuda import flash_attention as fa
    from f_lite_tpu_torch.text.layers import resolve_index
    from f_lite_tpu_torch.tools.text_precision import (
        SINGLE,
        median_ms,
        seeded_ids,
        tower_pair,
    )

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stack, ref = tower_pair(kind, "cuda")
    cfg = stack.config
    depth = cfg.num_layers if kind == "t5" else cfg.num_hidden_layers
    width, vocab = stack.embed_dim, cfg.vocab_size
    n_run = resolve_index(return_index, depth + 1)
    single = SINGLE[kind]
    longer = 128 if kind == "t5" else 192  # the single prompt padded further
    batch_lens = (5, 40, single, 300)
    inputs = {"single": seeded_ids([single], vocab, 8),
              "single_padded": seeded_ids([single], vocab, 8, multiple=longer),
              "batch": seeded_ids(list(batch_lens), vocab, 9)}
    inputs = {k: (torch.from_numpy(i).long().cuda(), torch.from_numpy(m).cuda())
              for k, (i, m) in inputs.items()}
    rows, outs = {}, {}
    reset_counts()
    with torch.no_grad():
        for label, (ids, mask) in inputs.items():
            got = stack(ids, mask, return_index=return_index)
            want = ref(ids, mask, return_index=return_index)
            if tuple(got.shape) != (*ids.shape, width) or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{kind} {label}: shape {tuple(got.shape)} or non-finite")
            err = float((got - want)[mask].abs().max())
            tol = fa.tolerance(want[mask], torch.bfloat16)
            rows[label] = dict(shape=list(got.shape), real_rows=int(mask.sum()),
                               max_abs_err=err, tolerance=tol, err_over_tol=err / tol)
            outs[label] = (got, tol)
        (a, tol), (b, _) = outs["single"], outs["single_padded"]
        pad_err = float((a[0, :single] - b[0, :single]).abs().max())
        rows["padding"] = dict(max_abs_diff=pad_err, tolerance=tol, err_over_tol=pad_err / tol,
                               padded_to=[a.shape[1], b.shape[1]])
        counts = read_counts()
        del ref, outs, a, b
        ms = {label: median_ms(lambda i=ids, m=mask: stack(i, m, return_index=return_index))
              for label, (ids, mask) in inputs.items() if label != "single_padded"}
    bounds = {label: tower_bound_ms(stack, n_run, tuple(inputs[label][0].shape))
              for label in ms}
    res = dict(tower=kind, depth=depth, blocks_run=n_run, width=width,
               params=sum(p.numel() for p in stack.parameters()), checks=rows,
               max_err_over_tol=max(r["err_over_tol"] for r in rows.values()),
               encode_ms=ms, bound_ms={k: v[0] for k, v in bounds.items()},
               bound_by={k: v[1] for k, v in bounds.items()},
               peak_gb_with_fp32_copy=torch.cuda.max_memory_allocated() / 1e9,
               bf16_weights_gb=sum(p.numel() * p.element_size()
                                   for p in stack.parameters()) / 1e9,
               launches=counts)
    log(f"text_tower_{kind}", json.dumps(res))
    expected = launches(rms_norm=2 * len(inputs) * tower_norms(stack, return_index))
    if counts != expected:
        raise AssertionError(f"{kind}: kernel launches {counts}, expected {expected}")
    if res["max_err_over_tol"] > 1.0:
        raise AssertionError(f"{kind}: err/tol {res['max_err_over_tol']} > 1")
    torch.cuda.empty_cache()
    return res, stack


class TimedEncoder:
    """A text encoder whose `encode` calls are timed (host clock around a
    synchronised call)."""

    def __init__(self, inner):
        self.inner, self.embed_dim, self.seconds = inner, inner.embed_dim, []

    def encode(self, prompts):
        import torch

        torch.cuda.synchronize()
        t = time.perf_counter()
        out = self.inner.encode(prompts)
        self.seconds.append(time.perf_counter() - t)
        return out


PROMPT = ("a red fox sitting in the snow at dawn, soft golden light, "
          "shallow depth of field, detailed fur, photograph")
NEGATIVE_PROMPT = "blurry, low quality, watermark"


def run_7b_prompt(pipe, t5_stack, steps=30, guidance=6.0, size=1024) -> dict:
    """Phase 9c: phase 9's pipeline with the phase-9a T5-XXL attached
    through `WordTokenizer`: `pipe(prompt=...)` without, then with, a
    negative prompt at 1024 px, 30 steps, g=6. Each: a finite image and
    exactly 30 * 56 forward launches; s/image with the encode's share, and
    peak GB with T5 resident."""
    import numpy as np
    import torch

    from f_lite_tpu_torch.text.encoder import T5TextEncoder

    te = TimedEncoder(T5TextEncoder.from_stack(
        t5_stack, WordTokenizer(t5_stack.config.vocab_size, seed=5)))
    encode_s = te.seconds
    pipe.text_encoder = te
    finite = []
    hook = pipe.vae.decoder.register_forward_hook(
        lambda _m, _i, out: finite.append(bool(torch.isfinite(out).all())))
    res = {}
    try:
        for label, negative in (("no_negative", None), ("negative", NEGATIVE_PROMPT)):
            # the DiT's steps, and a T5 encode of the prompt (and the negative)
            encodes = 1 if negative is None else 2
            expected = dit_launches(pipe.dit.config, steps)
            expected["rms_norm"] += encodes * tower_norms(t5_stack, te.inner.return_index)
            encode_s.clear()
            finite.clear()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            out = pipe(prompt=PROMPT, negative_prompt=negative, height=size, width=size,
                       num_inference_steps=steps, guidance_scale=guidance,
                       generator=torch.Generator("cuda").manual_seed(4),
                       output_type="uint8")
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            counts = read_counts()
            img = out.images
            res[label] = dict(image=list(img.shape), s_per_image=total,
                              encode_s=sum(encode_s), encodes=len(encode_s),
                              encode_share=sum(encode_s) / total,
                              max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                              launches=counts, expected_launches=expected,
                              decoded_finite=finite == [True])
            if img.shape != (1, size, size, 3) or img.dtype != np.uint8:
                raise AssertionError(f"7b prompt {label}: image {img.shape} {img.dtype}")
            if finite != [True]:
                raise AssertionError(f"7b prompt {label}: decoded image holds NaN or Inf")
            if counts != expected:
                raise AssertionError(f"7b prompt {label}: launches {counts}, expected {expected}")
    finally:
        hook.remove()
        pipe.text_encoder = None
    res["t5_resident_gb"] = sum(p.numel() * p.element_size()
                                for p in t5_stack.parameters()) / 1e9
    log("7b_prompt", json.dumps(res))
    return res


def run_img2img(pipe, steps=30, strength=0.5, guidance=6.0, size=1280) -> dict:
    """Phase 10: image to image with a mask at 1280 px (6416 tokens):
    strength 0.5 (15 of 30 steps), g=6, the left half repainted (mask at
    the latent grid); "auto" memory mode tiles the encode and the decode
    (3x3 tiles of 64 latents each). Finite output, exactly 15 * 56 forward
    launches and none of the others, and in the final latents the kept
    region equal to the encoded image's latents (the last step ends at
    t = 0)."""
    import numpy as np
    import torch

    from f_lite_tpu_torch.models.vae import normalize_latents

    embeds, mask = text_7b(pipe)
    lh = size // pipe.vae_scale_factor
    rs = np.random.RandomState(11)
    image = rs.randint(0, 256, (size, size, 3)).astype(np.uint8)
    repaint = np.zeros((lh, lh), np.uint8)
    repaint[:, : lh // 2] = 255
    n_run = max(1, min(steps, int(round(strength * steps))))  # rows run
    expected = dit_launches(pipe.dit.config, n_run)

    seen = {}
    tiles = {"encoder": 0, "decoder": 0}

    def timed(name, fn):
        def wrapper(x):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(x)
            torch.cuda.synchronize()
            seen[name] = (x, out, time.perf_counter() - t0)
            return out
        return wrapper

    def count(name):
        def hook(_m, _inp, _out):
            tiles[name] += 1
        return hook

    pipe._encode_image_latents = timed("encode", pipe._encode_image_latents)
    pipe._decode = timed("decode", pipe._decode)
    hooks = [pipe.vae.encoder.register_forward_hook(count("encoder")),
             pipe.vae.decoder.register_forward_hook(count("decoder"))]
    try:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = pipe(prompt_embeds=embeds, context_mask=mask, height=size, width=size,
                   num_inference_steps=steps, guidance_scale=guidance,
                   image=image, strength=strength, mask_image=repaint,
                   generator=torch.Generator("cuda").manual_seed(12),
                   output_type="uint8")
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = read_counts()
    finally:
        for hk in hooks:
            hk.remove()
        del pipe._encode_image_latents, pipe._decode

    img = out.images
    encoded = normalize_latents(seen["encode"][1].float(), pipe.vae.config)
    final = seen["decode"][0]
    keep = slice(lh // 2, None)
    # the final latents are in the DiT's dtype, rounded from fp32 at the end
    kept_equal = bool(torch.equal(final[:, :, keep],
                                  encoded[:, :, keep].to(final.dtype)))
    repaint_moved = float((final[:, :, : lh // 2].float()
                           - encoded[:, :, : lh // 2]).abs().mean())
    res = dict(size=size, tokens=16 + (lh // 2) ** 2, strength=strength,
               steps_run=n_run, image=list(img.shape),
               s_per_image=total, encode_s=seen["encode"][2], decode_s=seen["decode"][2],
               s_per_step=(total - seen["encode"][2] - seen["decode"][2]) / n_run,
               tiles=tiles, max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=counts, expected_launches=expected,
               kept_region_equals_encoded=kept_equal,
               repainted_mean_abs_change=repaint_moved)
    log("7b_img2img", json.dumps(res))
    if img.shape != (1, size, size, 3) or not bool(torch.isfinite(final).all()):
        raise AssertionError(f"img2img: image {img.shape} or non-finite latents")
    if counts != expected:
        raise AssertionError(f"img2img: launches {counts}, expected {expected}")
    if tiles != {"encoder": 9, "decoder": 9}:
        raise AssertionError(f"img2img: tiles {tiles}, expected 9 encode and 9 decode")
    if not kept_equal or not repaint_moved > 0:
        raise AssertionError("img2img: the kept region is not the encoded image, "
                             f"or the repainted one did not move ({repaint_moved})")
    torch.cuda.empty_cache()
    return res


def run_strength_one(pipe, size=256, steps=3, guidance=6.0) -> dict:
    """Phase 11: image to image at strength 1.0 (no mask) is text to image
    bit for bit: the encode is skipped and the start noise is the same
    draw."""
    import numpy as np
    import torch

    embeds, mask = text_7b(pipe)
    image = np.random.RandomState(13).randint(0, 256, (size, size, 3)).astype(np.uint8)
    kw = dict(prompt_embeds=embeds, context_mask=mask, height=size, width=size,
              num_inference_steps=steps, guidance_scale=guidance, output_type="np")
    reset_counts()
    a = pipe(**kw, image=image, strength=1.0,
             generator=torch.Generator("cuda").manual_seed(14)).images
    b = pipe(**kw, generator=torch.Generator("cuda").manual_seed(14)).images
    counts = read_counts()
    expected = dit_launches(pipe.dit.config, 2 * steps)
    res = dict(size=size, steps=steps, bitwise_equal=bool(np.array_equal(a, b)),
               finite=bool(np.isfinite(a).all()), launches=counts,
               expected_launches=expected)
    log("7b_strength_one", json.dumps(res))
    if not res["bitwise_equal"] or not res["finite"]:
        raise AssertionError("strength 1.0 differs from text to image")
    if counts != expected:
        raise AssertionError(f"strength 1.0: launches {counts}, expected {expected}")
    return res


def profile_step(run_one_step, label="step_profile") -> dict:
    """Device time of one denoise step by kernel class, from torch.profiler
    (launches here come after the counts were read)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run_one_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_one_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return profile_summary(prof, wall_ms, label)


def profile_summary(prof, wall_ms, label="step_profile") -> dict:
    """Device ms by kernel class, busy ms and idle share of a window of
    `wall_ms` traced by `prof`."""
    import torch

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    def dev_ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0)) / 1e3
    busy = sum(dev_ms(e) for e in kernels)
    classes = {"flash_attention_fwd": 0.0, "flash_attention_bwd_dq": 0.0,
               "flash_attention_bwd_dkv": 0.0, "int8_gemm": 0.0,
               "int8_quantize": 0.0, "matmul": 0.0, "other": 0.0}
    for e in kernels:
        n = e.key.lower()
        # the int8 kernels first: "gemm" would file them under matmul
        if "int8_gemm_kernel" in n:
            classes["int8_gemm"] += dev_ms(e)
        elif "quantize_rows_kernel" in n:
            classes["int8_quantize"] += dev_ms(e)
        elif "flash_fwd" in n:
            classes["flash_attention_fwd"] += dev_ms(e)
        elif "flash_bwd_dq" in n:
            classes["flash_attention_bwd_dq"] += dev_ms(e)
        elif "flash_bwd_dkv" in n:
            classes["flash_attention_bwd_dkv"] += dev_ms(e)
        elif any(w in n for w in ("gemm", "nvjet", "xmma", "cutlass", "sm90")):
            classes["matmul"] += dev_ms(e)
        else:
            classes["other"] += dev_ms(e)
    top = sorted(kernels, key=dev_ms, reverse=True)[:12]
    res = dict(wall_ms=wall_ms, device_busy_ms=busy,
               idle_share=(1.0 - busy / wall_ms) if busy else None,
               by_class_ms=classes,
               top=[dict(name=e.key[:90], ms=dev_ms(e), count=e.count) for e in top])
    log(label, json.dumps(res))
    return res


def bytecode_cache() -> None:
    """Keep this run's compiled Python: where PYTHONDONTWRITEBYTECODE is set
    and the package files sit on a slow file system (the card's machine),
    every subprocess would compile torch's modules again. This process
    writes the bytecode of what it imports from here on to a temporary
    prefix, in memory where it can, and the subprocesses it starts read it
    there (each torchrun's seconds to its first step are logged)."""
    import atexit
    import os
    import shutil

    shm = Path("/dev/shm")
    prefix = tempfile.mkdtemp(prefix="chip_smoke_pycache_",
                              dir=shm if shm.is_dir() and os.access(shm, os.W_OK) else None)
    atexit.register(shutil.rmtree, prefix, True)
    sys.pycache_prefix = prefix
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)


def main() -> int:
    bytecode_cache()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from f_lite_tpu_torch.ops.cuda.build import SOURCES, build, library_path

    t_total = time.perf_counter()
    card = card_line()
    log("card:", card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    build()
    log(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(SOURCES)})")
    for name in SOURCES:
        for line in library_path(name).with_suffix(".log").read_text().splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry",
                                       "warning", "nvcc seconds")):
                log(f"  ptxas {name}: {line.strip()}")

    t_start = time.perf_counter()

    def phase(fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        log(f"phase {fn.__name__}: {time.perf_counter() - t:.1f} s "
            f"(script {time.perf_counter() - t_start:.1f} s)")
        return out

    def in_memory(fn, *args):
        """A 7B training phase with its run's files (a 30 GB checkpoint) in
        memory where there is room: the card machine's disk takes about 45
        GiB of writes a call, freed blocks included."""
        with memory_tmp(1.1 * checkpoint_7b_gb(20)) as (root, where):
            log(f"{fn.__name__} files: {where}")
            return phase(fn, *args, out_root=root)

    rows = phase(check_attention)
    bwd_rows = phase(check_backward)
    variant_rows = phase(check_variants)
    lab = phase(run_lab)
    block = phase(check_block_grads)
    int8_rows, int8_edges, int8_fit = phase(check_int8)
    int8_given = phase(check_int8_given)
    norm_rows = phase(check_rms_norm)
    with contextlib.ExitStack() as run_files:
        # the training phases' files, from phase 12 on
        train_tmp = Path(run_files.enter_context(tempfile.TemporaryDirectory()))
        with contextlib.ExitStack() as release_files:
            # phase 8i: the tool fabricates and converts the release in a
            # subprocess, and a thread of this process then loads it, beside
            # phases 7-12c; its files stay in memory until the pipeline of
            # phases 9-11 is loaded from them
            release_job = phase(start_release_ingest, release_files)
            fixture, full_images = phase(run_fixture)
            fixture_extras = phase(run_fixture_extras, full_images)
            fixture_int8 = phase(run_fixture_int8, full_images)
            fixture_int8_tp1 = phase(run_fixture_int8_tp1, fixture_int8)
            fixture_prompts = phase(run_fixture_prompts, full_images)
            with tempfile.TemporaryDirectory() as tmp:
                fixture_lora = phase(run_fixture_lora, full_images, Path(tmp))
                fixture_saved = phase(run_fixture_save_ingest, full_images, Path(tmp))
                fixture_generate = phase(run_fixture_generate, Path(tmp))
                fixture_serve = phase(run_fixture_serve, Path(tmp))
                fixture_convert = phase(run_fixture_convert, full_images, Path(tmp))
                convert_7b = phase(run_7b_convert, Path(tmp), 1)
            qwen = phase(run_text_tower, "qwen2")[0]  # the tower is freed here
            t5_res, t5_stack = phase(run_text_tower, "t5")
            fixture_train = phase(run_fixture_training, train_tmp)
            fixture_resume = phase(run_fixture_resume, train_tmp)
            fixture_finetune = phase(run_fixture_finetune, train_tmp)
            pipe, release_ingest = phase(finish_release_ingest, release_job)
        card_state("before phase 9")
        prompt_7b = phase(run_7b_prompt, pipe, t5_stack)
        del t5_stack
        torch.cuda.empty_cache()
        big = phase(run_7b, pipe)
        with contextlib.ExitStack() as stack:
            # 9.5 GB of files, in memory where there is room, as phase 8g's; the
            # server loads them while phases 10-9f run here
            tmp, where = stack.enter_context(memory_tmp(12))
            log("7b_serve_tp1 files:", where)
            server_tp1 = phase(start_7b_serve, pipe, tmp)
            stack.callback(server_tp1.stop)
            img2img = phase(run_img2img, pipe)
            strength_one = phase(run_strength_one, pipe)
            big_lora = phase(run_7b_lora, pipe, big)
            big_http = phase(run_7b_http, pipe, big)
            padded_7b = phase(run_7b_padded, pipe, big)
            serve_tp1 = phase(finish_7b_serve, server_tp1, big_http)
        from f_lite_tpu_torch.quant import quantize_dit

        quantize_dit(pipe.dit)
        big_int8 = phase(run_7b, pipe, 30, 6.0, 1024, "7b_int8")
        padded_7b_int8 = phase(check_7b_padded_int8, padded_7b, big_int8)
        with tempfile.TemporaryDirectory() as tmp:
            release_serve = phase(run_release_serve, pipe, Path(tmp))
        log("7b_int8_vs_bf16", json.dumps({
            **{key: dict(bf16=big[key], int8=big_int8[key])
               for key in ("s_per_step", "s_per_image", "decode_s", "max_memory_allocated_gb")},
            "step_by_class_ms": dict(bf16=big["step_profile"]["by_class_ms"],
                                     int8=big_int8["step_profile"]["by_class_ms"])}))
        del pipe
        torch.cuda.empty_cache()
        fixture_online = phase(run_fixture_online, train_tmp, fixture_train)
        fixture_online_resume = phase(run_fixture_online_resume, train_tmp,
                                      fixture_online["tables"])
        fixture_buckets = phase(run_fixture_buckets, train_tmp)
        with contextlib.ExitStack() as beside:
            # 12h's subprocess runs beside 12g's: both fixture-sized
            sp_started = phase(start_fixture_sp, train_tmp, fixture_resume)
            beside.callback(stop_process, sp_started["job"]["proc"])
            fixture_fsdp = phase(run_fixture_fsdp, train_tmp, fixture_train, fixture_resume,
                                 sp_started["job"])
            fixture_sp = phase(run_fixture_sp, sp_started, fixture_resume, fixture_fsdp)
        train_7b = in_memory(run_7b_training, train_tmp)
        train_7b_dots = in_memory(run_7b_training, train_tmp, 10, 4, OPTIONS_7B_DEPTH,
                                  ("--remat_policy", "dots"), "7b_train_dots")
        train_7b_seqdrop = in_memory(run_7b_training, train_tmp, 10, 4, OPTIONS_7B_DEPTH,
                                     ("--sequence_dropout", "0.5"), "7b_train_seqdrop")
        train_7b_lora = phase(run_7b_training, train_tmp, 10, 4, OPTIONS_7B_DEPTH,
                              ("--use_lora", "--lora_rank", "64"), "7b_train_lora")
        checkpoint_7b = phase(run_7b_checkpoint, train_tmp, CHECKPOINT_7B_DEPTH)
        cache_builder = phase(run_cache_builder, train_tmp, fixture_online["tables"],
                              train_7b, 10, 4, TOOL_CACHE_7B_DEPTH)
        train_7b_online = in_memory(run_7b_online, train_tmp, cache_builder)
        fsdp_7b = in_memory(run_7b_fsdp, train_tmp, cache_builder, checkpoint_7b)
        pipeline_7b = phase(run_7b_pipeline, train_tmp, cache_builder)
    log("7b_train_options", json.dumps({
        r["options"] and " ".join(r["options"]) or "full": {k: r[k] for k in (
            "s_per_step", "max_memory_allocated_gb", "per_step", "trained_params",
            "final_checkpoint_gb")} | {"by_class_ms": r["step_profile"]["by_class_ms"],
                                       "idle_share": r["step_profile"]["idle_share"],
                                       "final_save": r["checkpoints"][-1]}
        for r in (train_7b, train_7b_dots, train_7b_seqdrop, train_7b_lora)}))

    main_row = next(r for r in rows if r["shape"] == "7b_self" and r["dtype"] == "bfloat16")
    forward = dict(
        name="flash_attention_fwd",
        route="cuda",
        source="f_lite_tpu_torch/csrc/flash_attention_fwd.cu",
        replaces="f_lite_tpu/ops/pallas/flash_attention.py:92",
        replaces_function="_fa_fwd_kernel",
        launches=train_7b["launches"]["fwd"],
        launches_per_train_step=train_7b["per_step"]["fwd"],
        launches_serving_7b_image=big["launches"],
        launches_serving_7b_release_tool_int8_2_images=release_serve["launches"]["fwd"],
        launches_serving_7b_img2img_1280=img2img["launches"]["fwd"],
        launches_serving_fixture=fixture["launches"],
        launches_serving_fixture_prompts=fixture_prompts["launches"]["fwd"],
        launches_serving_7b_prompt=[prompt_7b[k]["launches"]["fwd"]
                                    for k in ("no_negative", "negative")],
        launches_serving_fixture_extras=fixture_extras["launches"]["fwd"],
        launches_serving_fixture_lora={k: fixture_lora[k]["launches"]["fwd"] for k in (
            "scale_0", "safetensors", "peft_pt", "int8")},
        launches_serving_fixture_saved_ingested={k: fixture_saved[k]["launches"]["fwd"]
                                                 for k in ("saved", "snapshot_convert",
                                                           "snapshot_cached")},
        launches_serving_7b_lora=big_lora["launches"],
        launches_serving_fixture_generate=fixture_generate["bf16"]["launches"]["fwd"],
        launches_serving_fixture_serve={k: fixture_serve[k]["launches"]["fwd"]
                                        for k in ("batch", "http")},
        launches_serving_7b_http={"request": big_http["request"]["launches"]["fwd"],
                                  "img2img": big_http["img2img"]["launches"]["fwd"],
                                  "cancelled": big_http["cancel"]["launches"]["fwd"]},
        launches_lab=lab["launches"]["fwd"],
        launches_fixture_train=fixture_train["launches"]["fwd"],
        launches_per_train_step_options={
            "dots": train_7b_dots["per_step"]["fwd"],
            "sequence_dropout": train_7b_seqdrop["per_step"]["fwd"],
            "lora": train_7b_lora["per_step"]["fwd"]},
        launches_fixture_resume=fixture_resume["launches_resumed"]["fwd"],
        launches_per_fixture_finetune_micro_step=fixture_finetune["per_micro_step"]["fwd"],
        launches_online={
            "per_7b_d12_step": train_7b_online["per_step"]["fwd"],
            "per_fixture_step": fixture_online["per_step"]["fwd"],
            "per_fixture_eval_of_2_batches": [c["fwd"] for c in fixture_online["evals"]],
            "per_fixture_sample_grid": fixture_online["sample_grids"][0]["fwd"],
            "per_fixture_bucket_step": fixture_buckets["per_step"]["fwd"],
            "fixture_resume_and_debug_nans": fixture_online_resume["launches"]["fwd"]},
        launches_fsdp={"per_fixture_step": fixture_fsdp["per_step_launches"]["fwd"],
                       "per_7b_d12_step": fsdp_7b["per_step_launches"]["fwd"]},
        launches_pipeline_one_stage={
            "per_7b_d12_step_2_microbatches": pipeline_7b["per_step_launches"]["fwd"]},
        launches_tp_at_tp1={
            "per_fixture_step_sequence_parallel": fixture_sp["per_step_launches"]["fwd"],
            "serving_fixture_int8": fixture_int8_tp1["launches"]["fwd"]},
        launches_serving_7b_padded_heads={k: padded_7b[k]["counts"]["fwd"]
                                          for k in ("bf16", "int8")},
        launches_tools={"fixture_converted_pt": fixture_convert["pt"]["launches"]["fwd"],
                        "fixture_converted_hf_dir": fixture_convert["hf_dir"]["launches"]["fwd"],
                        "test_image": fixture_convert["test_image"]["launches"]["fwd"],
                        "per_7b_step_from_tool_cache":
                            cache_builder["train"]["per_step"]["fwd"]},
        max_abs_err=max(r["max_abs_err"] for r in rows),
        max_err_over_tolerance=max(r["max_abs_err"] / r["tolerance"] for r in rows),
        ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=main_row["library_ms"],
        at="7b_self (serving, B=2 L=4112) bfloat16",
        shapes=rows,
    )
    bwd_main = next(r for r in bwd_rows if r["shape"] == "7b_self" and r["dtype"] == "bfloat16")
    backward = []
    for name, fn, ms_key, grads in (("flash_attention_bwd_dq", "_dq_kernel:269", "dq_ms", ("dq",)),
                                    ("flash_attention_bwd_dkv", "_dkv_kernel:316", "dkv_ms", ("dk", "dv"))):
        which = "dq" if name.endswith("dq") else "dkv"
        backward.append(dict(
            name=name,
            route="cuda",
            source="f_lite_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces=f"f_lite_tpu/ops/pallas/flash_attention.py:{fn.split(':')[1]}",
            replaces_function=fn.split(":")[0],
            launches=train_7b["launches"][which],
            launches_per_train_step=train_7b["per_step"][which],
            launches_fixture_train=fixture_train["launches"][which],
            launches_per_train_step_options={
                "dots": train_7b_dots["per_step"][which],
                "sequence_dropout": train_7b_seqdrop["per_step"][which],
                "lora": train_7b_lora["per_step"][which]},
            launches_fixture_resume=fixture_resume["launches_resumed"][which],
            launches_per_fixture_finetune_micro_step=(
                fixture_finetune["per_micro_step"][which]),
            launches_online={
                "per_7b_d12_step": train_7b_online["per_step"][which],
                "per_fixture_step": fixture_online["per_step"][which],
                "per_fixture_eval_of_2_batches": [c[which] for c in fixture_online["evals"]],
                "per_fixture_sample_grid": fixture_online["sample_grids"][0][which],
                "per_fixture_bucket_step": fixture_buckets["per_step"][which],
                "fixture_resume_and_debug_nans": fixture_online_resume["launches"][which]},
            launches_fsdp={"per_fixture_step": fixture_fsdp["per_step_launches"][which],
                           "per_7b_d12_step": fsdp_7b["per_step_launches"][which]},
            launches_pipeline_one_stage={
                "per_7b_d12_step_2_microbatches": pipeline_7b["per_step_launches"][which]},
            launches_tp_at_tp1={"per_fixture_step_sequence_parallel":
                                fixture_sp["per_step_launches"][which]},
            launches_tools={"per_7b_step_from_tool_cache":
                            cache_builder["train"]["per_step"][which]},
            max_abs_err=max(r["max_abs_err"][gname] for r in bwd_rows for gname in grads),
            max_err_over_tolerance=max(r["max_abs_err"][gname] / r["tolerance"][gname]
                                       for r in bwd_rows for gname in grads),
            ms=bwd_main[ms_key], plain_ms=bwd_main["plain_ms"],
            plain_covers="dq, dk and dv together",
            bound_ms=bwd_main["bound_ms"][which], bound_by=bwd_main["bound_by"][which],
            library_ms=bwd_main["library_ms"],
            library_covers="SDPA forward + backward minus forward (dq, dk, dv)",
            pair_ms=bwd_main["pair_ms"], fused_bound_ms=bwd_main["bound_ms"]["fused"],
            at="7b_self (training, B=4 L=1040) bfloat16",
            by_shape={r["shape"]: dict(ms=r[ms_key], pair_ms=r["pair_ms"],
                                       library_ms=r["library_ms"],
                                       bound_ms=r["bound_ms"][which])
                      for r in bwd_rows if r["dtype"] == "bfloat16"},
        ))
    from f_lite_tpu_torch.ops.cuda import flash_variants as fv

    lab_at = {(r["block_q"], r["block_k"], r["variant"]): r["ms"] for r in lab["rows"]}
    serving_pair = fv.SERVING_BLOCKS[256]
    lab_main = next(r for r in variant_rows if r["shape"] == "7b_serving")
    variants = dict(
        name="flash_attention_variants",
        route="cuda",
        source="f_lite_tpu_torch/csrc/flash_attention_variants.cu",
        replaces="tools/flash_variants.py:43",
        replaces_function="_kernel",
        launches=lab["launches"]["variants"],
        launches_serving=sum(c["variants"] for c in (
            fixture["counts"], fixture_extras["launches"], big["counts"],
            img2img["launches"], strength_one["launches"], big_lora["counts"],
            *(fixture_lora[k]["launches"] for k in ("scale_0", "safetensors",
                                                    "peft_pt", "int8")),
            *(fixture_saved[k]["launches"] for k in ("saved", "snapshot_convert",
                                                     "snapshot_cached")),
            fixture_generate["bf16"]["launches"], fixture_generate["int8"]["launches"],
            fixture_serve["batch"]["launches"], fixture_serve["http"]["launches"],
            big_http["request"]["launches"], big_http["img2img"]["launches"],
            big_http["cancel"]["launches"], fixture_convert["pt"]["launches"],
            fixture_convert["hf_dir"]["launches"],
            fixture_convert["test_image"]["launches"])),
        launches_training=sum(r["launches"]["variants"] for r in (
            fixture_train, fixture_finetune, train_7b, train_7b_dots, train_7b_seqdrop,
            train_7b_lora, fixture_online, fixture_online_resume, fixture_buckets,
            train_7b_online, cache_builder["train"]))
        + pipeline_7b["parent_launches"]["variants"]
        + fixture_resume["launches_straight"]["variants"]
        + fixture_resume["launches_resumed"]["variants"],
        max_abs_err=max(r["max_abs_err"] for r in variant_rows),
        max_err_over_tolerance=max(r["max_err_over_tolerance"] for r in variant_rows),
        ms=lab_at[(*serving_pair, "base")],
        ms_block_k_64=lab_at[(128, 64, "base")],
        forward_ms=main_row["ms"],
        plain_ms=lab_main["plain_ms"],
        bound_ms=lab_main["bound_ms"], bound_by=lab_main["bound_by"],
        library_ms=lab_main["library_ms"],
        at=f"7b_serving 2x10x4112x256 bfloat16, base, blocks {serving_pair}; "
           "forward_ms: flash_attention_fwd at 7b_self (phase 3)",
        sweep=[[r["block_q"], r["block_k"], r["variant"], r["ms"]] for r in lab["rows"]],
        shapes=variant_rows,
    )
    int8_main = next(r for r in int8_rows if r["shape"] == "7b_qkv")
    int8_common = dict(
        route="cuda", source="f_lite_tpu_torch/csrc/int8_gemm.cu",
        replaces="f_lite_tpu/quant.py:52",
        replaces_function="quant_matmul",
        replaces_note="lowered and fused by XLA; no Pallas kernel",
        max_abs_err=max(r["max_abs_err"] for r in int8_rows + int8_edges),
        at="7b_qkv (M 8224, N 7680, K 2560) bfloat16")
    int8_kernels = []
    for name, key, counter in (("int8_quantize_rows", "quantize", "quantize"),
                               ("int8_gemm_dequant", "gemm", "gemm")):
        int8_kernels.append(dict(
            name=name, **int8_common,
            launches=big_int8["counts"][counter],
            launches_serving_fixture_int8=fixture_int8["launches"][counter],
            launches_serving_fixture_lora_int8=fixture_lora["int8"]["launches"][counter],
            launches_serving_fixture_generate_int8=(
                fixture_generate["int8"]["launches"][counter]),
            launches_serving_fixture_int8_tp_at_tp1=fixture_int8_tp1["launches"][counter],
            launches_serving_7b_padded_heads_int8=padded_7b["int8"]["counts"][counter],
            launches_serving_7b_release_tool_int8_2_images=release_serve["launches"][counter],
            ms=int8_main[f"{key}_ms"], plain_ms=int8_main[f"{key}_plain_ms"],
            bound_ms=int8_main[f"{key}_bound_ms"],
            bound_by=int8_main[f"{key}_bound_by"],
            library_ms=int8_main["library_ms"] if key == "gemm" else None,
            **(dict(library_covers="torch._int_mm + the dequant as separate passes",
                    int_mm_ms=int8_main["int_mm_ms"],
                    bf16_linear_ms=int8_main["bf16_linear_ms"],
                    # the fit of the design at 7b_qkv, in its own tiles
                    fixed_us_per_tile=int8_fit["pingpong"]["fixed_us_per_tile"],
                    fixed_us_residual=int8_fit["pingpong"]["max_abs_residual_us"],
                    us_per_k_tile=int8_fit["pingpong"]["us_per_k_tile"],
                    fit_tile=int8_fit["pingpong"]["tile"],
                    k_fit=int8_fit,
                    edge_shapes_checked=[r["shape"] for r in int8_edges])
               if key == "gemm" else {}),
            by_shape={r["shape"]: {f: r[f] for f in r if f.startswith(key) or (
                key == "gemm" and f in ("library_ms", "int_mm_ms", "bf16_linear_ms"))}
                for r in int8_rows},
            **(dict(given_amax_entries={r["shape"]: {f: v for f, v in r.items() if f != "shape"}
                                        for r in int8_given})
               if key == "quantize" else {}),
        ))
    norm_main = next(r for r in norm_rows if r["shape"] == "7b_norm")
    per_step_options = {"full": train_7b, "dots": train_7b_dots,
                        "sequence_dropout": train_7b_seqdrop, "lora": train_7b_lora}
    rms_norm_kernel = dict(
        name="rms_norm",
        route="cuda",
        source="f_lite_tpu_torch/csrc/rms_norm.cu",
        replaces="f_lite_tpu/ops/norms.py:22",
        replaces_function="rms_norm",
        replaces_note="plain jnp, fused by XLA; no Pallas kernel",
        launches=big["counts"]["rms_norm"],
        launches_serving_7b_image=big["counts"]["rms_norm"],
        launches_serving_7b_int8_image=big_int8["counts"]["rms_norm"],
        launches_serving_7b_prompt=[prompt_7b[k]["launches"]["rms_norm"]
                                    for k in ("no_negative", "negative")],
        launches_serving_7b_img2img_1280=img2img["launches"]["rms_norm"],
        launches_serving_fixture=fixture["counts"]["rms_norm"],
        launches_text_towers={"qwen2": qwen["launches"]["rms_norm"],
                              "t5": t5_res["launches"]["rms_norm"]},
        launches_block_grads=block["launches"],
        launches_per_train_step={k: {c: r["per_step"][c] for c in ("rms_norm", "rms_norm_bwd")}
                                 for k, r in per_step_options.items()},
        launches_per_fixture_step={c: fixture_online["per_step"][c]
                                   for c in ("rms_norm", "rms_norm_bwd")},
        launches_per_fixture_finetune_micro_step={
            c: fixture_finetune["per_micro_step"][c] for c in ("rms_norm", "rms_norm_bwd")},
        launches_fsdp={"per_fixture_step": fixture_fsdp["per_step_launches"],
                       "per_7b_d12_step": fsdp_7b["per_step_launches"]},
        launches_pipeline_one_stage={
            "per_7b_d12_step_2_microbatches": pipeline_7b["per_step_launches"]},
        max_abs_err=max(r["max_abs_err"] for r in norm_rows),
        max_excess=max(v for r in norm_rows for v in r["excess"].values()),
        ms=norm_main["ms"], bwd_ms=norm_main["bwd_ms"], plain_ms=norm_main["plain_ms"],
        plain_bwd_ms=norm_main["plain_bwd_ms"], bound_ms=norm_main["bound_ms"],
        bwd_bound_ms=norm_main["bwd_bound_ms"], bound_by=norm_main["bound_by"],
        library_ms=norm_main["library_ms"], library_bwd_ms=norm_main["library_bwd_ms"],
        library_note="torch.nn.functional.rms_norm: a yardstick the port never calls",
        at="7b_norm (8224 x 2560) bfloat16, bf16 weight",
        shapes=norm_rows,
    )
    kernels = [forward, *backward, variants, *int8_kernels, rms_norm_kernel]
    for k in kernels:
        missing = [key for key in KERNEL_KEYS if key not in k]
        if missing:
            raise AssertionError(f"kernels line: {k['name']} lacks {missing}")
    # where the checks of 2 and 4 ranks ran (tests/test_torch_parallel.py)
    log(json.dumps({"gpus": torch.cuda.device_count(), "multi_rank_checks": "cpu/gloo",
                    "pipeline_one_stage_7b": {k: pipeline_7b[k] for k in (
                        "config", "rel_gaps", "s_per_step", "reference_s_per_step",
                        "max_memory_allocated_gb", "reference_max_memory_allocated_gb",
                        "export_bit_equal", "export_load_s", "files")},
                    "tp_at_tp1": {
                        "fixture_sequence_parallel": {k: fixture_sp[k] for k in (
                            "losses_bit_equal", "max_rel_gap", "s_per_step",
                            "phase_12g_s_per_step")},
                        "fixture_int8": {k: fixture_int8_tp1[k] for k in (
                            "bit_equal_to_phase_8a", "row_parallel_layers")},
                        "serve_7b": {k: serve_tp1[k] for k in (
                            "bit_equal_to_phase_9e", "save_s", "loaded_s", "ready_s",
                            "waited_here_s", "s_per_request",
                            "phase_9e_s_per_request")}},
                    "padded_heads_7b": {
                        "bf16": {k: padded_7b["bf16"][k] for k in (
                            "max_abs_err_vs_phase_9", "tolerance", "s_per_image",
                            "max_memory_allocated_gb", "phase_9")},
                        "int8": padded_7b_int8}}))
    release_7b = dict(
        manifest=RELEASE_MANIFEST, strict_ingest=release_ingest["tool"]["strict_ingest"],
        keys=release_ingest["keys"], params=release_ingest["params"],
        fabricate_s=release_ingest["tool"]["fabricate_seconds"],
        convert_s=release_ingest["tool"]["convert_seconds"],
        beside=release_ingest["beside"], waited_for_load_s=release_ingest["waited_s"],
        cached_load_s=release_ingest["cached_load_s"],
        bf16_s_per_image=big["s_per_image"], int8_s_per_image=big_int8["s_per_image"],
        tool_int8_p50_s_per_image=release_serve["p50_seconds_per_image"],
        tool_int8_s_per_image=release_serve["seconds_per_image"],
        peak_gb=max(release_ingest["max_memory_allocated_gb"], big["max_memory_allocated_gb"],
                    big_int8["max_memory_allocated_gb"],
                    release_serve["hbm"]["max_memory_allocated_gb"]),
        files=release_ingest["files"]["where"],
        fabricate_peak_host_rss_gb=release_ingest["tool"]["peak_host_rss_gb"])
    log(json.dumps({"kernels": kernels,
                    "release_7b": release_7b,
                    "block_grads_max_rel": block["max_rel"],
                    "backward_shapes": bwd_rows,
                    "fixture_int8": dict(both_acc=fixture_int8["both_acc"],
                                         psnr_vs_bf16_db=fixture_int8["psnr_vs_bf16_db"]),
                    "text_towers": {r["tower"]: {k: r[k] for k in (
                        "max_err_over_tol", "encode_ms", "bound_ms", "bound_by",
                        "peak_gb_with_fp32_copy", "launches")} for r in (t5_res, qwen)},
                    "serving_7b_prompt": {k: prompt_7b[k]["s_per_image"]
                                          for k in ("no_negative", "negative")},
                    "pipeline_extras": {
                        "fixture_lora_both_acc": {k: fixture_lora[k]["both_acc"] for k in (
                            "safetensors", "peft_pt", "int8")},
                        "fixture_saved_load_s": fixture_saved["saved"]["load_s"],
                        "fixture_snapshot_convert_load_s":
                            fixture_saved["snapshot_convert"]["load_s"],
                        "fixture_snapshot_cached_load_s":
                            fixture_saved["snapshot_cached"]["load_s"],
                        "lora_7b": {k: big_lora[k] for k in (
                            "rank", "merged", "merge_s", "s_per_image", "s_per_step",
                            "max_memory_allocated_gb", "phase_9")}},
                    "front_ends": {
                        "fixture_generate_both_acc": fixture_generate["bf16"]["both_acc"],
                        "fixture_serve_batch_images_per_min":
                            fixture_serve["batch"]["images_per_min"],
                        "fixture_http_s_per_request": fixture_serve["http"]["s_per_request"],
                        "fixture_warm_up_s": fixture_serve["warm_up_s"],
                        "http_7b": {k: big_http["request"][k] for k in (
                            "s_per_request", "server_s", "phase_9_s_per_image",
                            "png_encode_ms", "png_decode_ms", "png_decode_ms_by_filter",
                            "png_bytes")},
                        "http_7b_warm_up_s": big_http["warm_up_s"]},
                    "train_state": {
                        "fixture_resume_bit_equal": fixture_resume["losses_equal"],
                        "fixture_sigterm": fixture_resume["sigterm"],
                        "fixture_finetune_both_acc": fixture_finetune["both_acc"],
                        "checkpoint_7b": {k: checkpoint_7b[k] for k in (
                            "params", "expected_gb", "disk_gb", "saves")},
                        "train_7b_s_per_step": {
                            "full": train_7b["s_per_step"], "dots": train_7b_dots["s_per_step"],
                            "sequence_dropout": train_7b_seqdrop["s_per_step"],
                            "lora": train_7b_lora["s_per_step"]},
                        "train_7b_peak_gb": {
                            "full": train_7b["max_memory_allocated_gb"],
                            "dots": train_7b_dots["max_memory_allocated_gb"],
                            "sequence_dropout": train_7b_seqdrop["max_memory_allocated_gb"],
                            "lora": train_7b_lora["max_memory_allocated_gb"]}},
                    "online": {
                        "fixture": {k: fixture_online[k] for k in (
                            "mean_loss_260_300", "phase_12_mean_loss_260_300",
                            "s_per_step", "phase_12_s_per_step",
                            "loader_wait_ms_per_step", "val_loss", "sample_both_acc")}
                        | {"trace_idle_share": fixture_online["trace"]["idle_share"]},
                        "fixture_resume_bit_equal": fixture_online_resume["losses_equal"],
                        "debug_nans_bit_equal":
                            fixture_online_resume["debug_nans_losses_equal"],
                        "bucket_self_lengths": fixture_buckets["self_lengths"],
                        "7b": {k: train_7b_online[k] for k in (
                            "config", "s_per_step", "reference_s_per_step",
                            "vae_encode_ms_per_step", "loader_wait_ms_per_step",
                            "idle_share", "reference_idle_share",
                            "max_memory_allocated_gb", "allocated_at_start_gb",
                            "reference_max_memory_allocated_gb")}},
                    "fsdp": {
                        "fixture": {k: fixture_fsdp[k] for k in (
                            "losses_bit_equal", "max_rel_gap", "resumed_unwrapped_bit_equal",
                            "resumed_max_rel_gap", "s_per_step", "phase_12_s_per_step")},
                        "7b": {k: fsdp_7b[k] for k in (
                            "config", "losses_equal_reference", "s_per_step",
                            "reference_s_per_step", "max_memory_allocated_gb",
                            "reference_max_memory_allocated_gb", "idle_share",
                            "reference_idle_share", "final_save", "phase_13c_sync_save")}},
                    "tools": {
                        "fixture_convert": {k: fixture_convert[k] for k in (
                            "export_s", "hf_dir_ingest_s")}
                        | {"pt_ingest_and_test_image_s":
                           fixture_convert["test_image"]["pt_ingest_and_render_s"],
                           "bit_equal_to_phase_7": [fixture_convert[k]["equal_to_phase_7"]
                                                    for k in ("pt", "hf_dir")]},
                        "convert_7b_d8": {k: convert_7b[k] for k in (
                            "config", "params", "export", "ingest", "bit_equal")},
                        "cache_builder_parity": cache_builder["parity"],
                        "cache_builder_7b": {k: cache_builder["full_width"][k] for k in (
                            "s_per_image", "vae_encode_s_per_image",
                            "text_encode_s_per_image", "cache_gb",
                            "max_memory_allocated_gb")},
                        "train_7b_from_tool_cache": {
                            "s_per_step": cache_builder["train"]["s_per_step"],
                            "phase_13_s_per_step": cache_builder["phase_13_s_per_step"],
                            "max_memory_allocated_gb":
                                cache_builder["train"]["max_memory_allocated_gb"]}}}))
    card_state("at the end")
    log(f"chip_smoke total: {time.perf_counter() - t_total:.1f} s")
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [SP_WORKER]:
        sys.exit(sequence_parallel_train_worker(sys.argv[2:]))
    if sys.argv[1:2] == [PP_WORKER]:
        sys.exit(pipeline_train_worker(sys.argv[2:]))
    sys.exit(main())
