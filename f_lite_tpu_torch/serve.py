"""Serving on NVIDIA GPUs: many prompts -> PNGs, or an HTTP endpoint
(counterpart of `f_lite_tpu/serve.py`; the same flags, plus `--device`).

  python -m f_lite_tpu_torch.serve --model <dir> --prompts prompts.txt \
      --batch_size 4 --width 1024 --height 1024 --steps 30 \
      [--precomputed_dir <cache>] --output_dir outs/

  python -m f_lite_tpu_torch.serve --model <dir> --http_port 8080 --quantize

Batch mode reads a text file (one prompt a line, one seed a batch) or a
`.jsonl` file whose rows carry their own negative prompt and seed; each
such row's latents are drawn as a batch-1 call with that seed draws them
(`torch.Generator(device).manual_seed(seed)`), so a row is its solo image
bit for bit however it is batched. The final batch is padded to the batch
size, and the PNGs are written on a saver thread while the card runs on.

HTTP mode (`--http_port`, stdlib only): `POST /generate` with a JSON body
`{"prompt", "negative_prompt"?, "width"?, "height"?, "steps"?,
"guidance_scale"?, "seed"?, "sampler"?, "image"? (base64: image to
image), "mask_image"? (base64: inpainting), "strength"?}` answers a
parameter-stamped PNG; `GET /healthz` reports readiness and `GET /metrics`
Prometheus counters. Image fields are PNGs of the requested size (the mask
at the latent grid); other formats and sizes need PIL. Device work is
serialised by a lock, and SIGTERM drains: new work gets 503, work in
flight finishes. Before the port binds, one request of each warm-up shape
runs through the serving path, which builds the CUDA kernels (nvcc at first
use) and warms cuBLAS.

Multi-GPU (`--dp` / `--tp`): one process a GPU under torchrun, WORLD_SIZE
= dp x tp (`torchrun --nproc_per_node 4 -m f_lite_tpu_torch.serve --dp 2
--tp 2 ...`; gloo with `--device cpu`). The DiT is split over each group of
tp consecutive ranks (`parallel.tensor.parallelize_dit`, heads padded at
load where tp does not divide them), and each of the dp groups denoises its
share of the rows. Batch mode: every rank runs the batches, each dp group
its rows, whose PNGs the group's first rank writes (the prompts-file
batches draw the whole batch's latents from their seed, so the files are
the one-GPU files). HTTP mode: rank 0 binds the port; with dp > 1 a
`RequestBatcher` groups same-shape requests into one dispatch of dp rows
(`X-F-Lite-Batch` says how many were real; image inputs get 400). Rank 0
hands each dispatch (or a stop) to the other ranks over a gloo group
(`RankGroup`) and gathers their PNGs or their errors: a rank that raises
answers with its error, so no rank waits in a collective for it, and the
others leave their loop when rank 0 stops, after a drain on SIGTERM
(which they ignore themselves).
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

from f_lite_tpu_torch.sampling.euler import SAMPLERS

logger = logging.getLogger("f_lite_tpu_torch.serve")

# the largest image a request may upload, in pixels (checked on the header)
MAX_UPLOAD_PIXELS = 4096 * 4096


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="batched F-Lite serving")
    p.add_argument("--model", required=True)
    p.add_argument("--prompts", default=None,
                   help="batch mode input: a text file (one prompt per "
                        "line, one seed per batch) or a .jsonl file — "
                        "each line {\"prompt\": ..., "
                        "\"negative_prompt\"?, \"seed\"?} gets its own "
                        "latents, so every row is reproducible alone "
                        "(generate --from_png) regardless of batching")
    p.add_argument("--http_port", type=int, default=None,
                   help="serve an HTTP endpoint on this port instead of "
                        "a prompts file (POST /generate, GET /healthz)")
    p.add_argument("--http_host", default="127.0.0.1",
                   help="HTTP bind address (0.0.0.0 to expose)")
    p.add_argument("--text_bucket", type=int, default=128,
                   help="zero-pad the text context up to the next "
                        "multiple of this (exact: masked keys do not "
                        "attend); 0 = pad to the per-prompt multiple-of-8 "
                        "length")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--guidance_scale", type=float, default=6.0)
    p.add_argument("--guidance_interval", type=float, nargs=2,
                   default=None, metavar=("LO", "HI"),
                   help="CFG only while the schedule t is inside "
                        "[LO, HI]; other steps run conditional-only at "
                        "half the model cost")
    p.add_argument("--negative_prompt", type=str, default=None,
                   help="one negative prompt applied to every batch-mode "
                        "image (HTTP requests carry their own)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--precomputed_dir", type=str, default=None,
                   help="serve text embeddings from a precompute cache")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ways (GPUs a model copy; under "
                        "torchrun, WORLD_SIZE = dp x tp)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel ways (model copies; each denoises "
                        "batch/dp rows)")
    p.add_argument("--warmup_shapes", type=str, default=None,
                   help="HTTP mode: extra WxH shapes to warm before the "
                        "port binds, e.g. '1344x896,896x1344' (the "
                        "--width x --height default is always warmed)")
    p.add_argument("--batch_window_ms", type=float, default=100.0,
                   help="HTTP + --dp > 1: how long the request batcher "
                        "waits for same-shape requests to fill dp rows")
    p.add_argument("--output_dir", type=str, default="outputs")
    p.add_argument("--no_text_encoder", action="store_true")
    p.add_argument("--quantize", action="store_true",
                   help="int8 W8A8 DiT projections (dynamic act quant)")
    p.add_argument("--lora_path", type=str, default=None,
                   help="serve a fine-tuned LoRA (dir, .safetensors or a "
                        "peft lora_weights.pt), merged into the base "
                        "weights at load, before int8 quantization")
    p.add_argument("--lora_scale", type=float, default=1.0)
    p.add_argument("--lora_alpha", type=float, default=None,
                   help="peft lora_alpha of the adapter; default = rank")
    p.add_argument("--steps_per_dispatch", type=int, default=None,
                   help="run the denoise trajectory in windows of at most "
                        "N steps; default: the pipeline's automatic size, "
                        "0: one window")
    p.add_argument("--sampler", choices=SAMPLERS, default="euler",
                   help="'ab2' = second-order multistep integration at "
                        "the same per-step cost")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions")
    return p.parse_args(argv)


def _check_mesh(args):
    """`--dp` x `--tp` against the processes torchrun started (JAX checks
    them against the visible chips, `f_lite_tpu/serve.py:156-163`)."""
    from f_lite_tpu_torch.parallel.mesh import launch_info, under_torchrun

    if args.dp < 1 or args.tp < 1:
        raise SystemExit("--dp/--tp must be >= 1")
    n = args.dp * args.tp
    if not under_torchrun():
        if n > 1:
            raise SystemExit(
                f"--dp {args.dp} x --tp {args.tp} = {n} GPUs: multi-GPU serving "
                "runs one process a GPU, under torchrun: torchrun "
                f"--nproc_per_node {n} -m f_lite_tpu_torch.serve ...")
        return
    world = launch_info()[0]
    if n != world:
        raise SystemExit(f"--dp {args.dp} x --tp {args.tp} = {n} ranks, but "
                         f"torchrun started {world} (WORLD_SIZE)")


def _pad_heads_for(args):
    """The head count to pad to where --tp does not divide the DiT's heads
    (JAX's `f_lite_tpu/serve.py:165-177`), else None."""
    if args.tp <= 1:
        return None
    cfg = json.loads((Path(args.model) / "dit" / "config.json").read_text())
    heads = cfg.get("num_heads", 12)
    if heads % args.tp == 0:
        return None
    pad = -(-heads // args.tp) * args.tp
    logger.info("padding %d heads -> %d for tp=%d", heads, pad, args.tp)
    return pad


def build_pipeline(args):
    """Load the pipeline on `--device` (int8, LoRA and head padding at load)
    and attach the text encoder the flags choose. Under torchrun the process
    group is formed here and the DiT split over its tp group
    (`parallelize_dit` on a (dp, 1, tp) mesh, at tp 1 too)."""
    import torch.distributed as dist

    from f_lite_tpu_torch.parallel.mesh import create_mesh, init_distributed
    from f_lite_tpu_torch.pipeline import FLitePipeline

    _check_mesh(args)
    init_distributed(args.device)
    pipe = FLitePipeline.from_pretrained(
        args.model,
        device=args.device,
        load_text_encoder=not (args.precomputed_dir or args.no_text_encoder),
        quantize=args.quantize,
        lora_path=args.lora_path,
        lora_scale=args.lora_scale,
        lora_alpha=args.lora_alpha,
        pad_heads_to=_pad_heads_for(args),
    )
    if dist.is_initialized():
        from f_lite_tpu_torch.parallel.tensor import parallelize_dit

        mesh = create_mesh(args.dp, 1, args.tp, device_type=pipe.device.type)
        parallelize_dit(pipe.dit, mesh["tp"])
        logger.info("DiT split over %d ranks (dp=%d, tp=%d)", args.dp * args.tp,
                    args.dp, args.tp)
    if args.precomputed_dir:
        from f_lite_tpu_torch.text.encoder import PrecomputedTextEncoder

        pipe.text_encoder = PrecomputedTextEncoder(args.precomputed_dir)
    elif args.no_text_encoder:
        from f_lite_tpu_torch.text.encoder import PSEUDO_TEXT_LEN, ZeroTextEncoder

        pipe.text_encoder = ZeroTextEncoder(
            embed_dim=pipe.dit.config.cross_attn_input_size, seq_len=PSEUDO_TEXT_LEN
        )
    return pipe


def _load_jsonl_rows(path: Path, args) -> list[dict]:
    """A .jsonl prompts file -> per-row dicts. Each line: {"prompt": str,
    "negative_prompt"?: str, "seed"?: int}. A missing negative is
    --negative_prompt; missing seeds count up from --seed in file order."""
    rows: list[dict] = []
    for ln, line in enumerate(path.read_text().splitlines(), 1):
        if not line.strip():
            continue
        try:
            r = json.loads(line)
        except ValueError as e:
            raise SystemExit(f"{path}:{ln}: invalid JSON ({e})")
        if not isinstance(r, dict) or not isinstance(r.get("prompt"), str) \
                or not r["prompt"].strip():
            raise SystemExit(
                f"{path}:{ln}: each line must be an object with a "
                "non-empty string 'prompt'"
            )
        unknown = sorted(set(r) - {"prompt", "negative_prompt", "seed"})
        if unknown:
            raise SystemExit(
                f"{path}:{ln}: unknown keys {unknown} (width/steps/... "
                "come from the launch flags)"
            )
        neg = r.get("negative_prompt", args.negative_prompt)
        if neg is not None and not isinstance(neg, str):
            raise SystemExit(f"{path}:{ln}: negative_prompt must be a string")
        seed = r.get("seed")
        if seed is None:
            seed = args.seed + len(rows)
        elif not isinstance(seed, int) or isinstance(seed, bool) \
                or not 0 <= seed <= 2**31 - 1:
            raise SystemExit(
                f"{path}:{ln}: seed must be an integer in [0, 2^31-1]"
            )
        rows.append({"prompt": r["prompt"], "negative_prompt": neg or None,
                     "seed": seed})
    if not rows:
        raise SystemExit(f"no rows in {path}")
    return rows


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    # `is None`, not truthiness: --http_port 0 is an ephemeral port
    if (args.prompts is None) == (args.http_port is None):
        raise SystemExit(
            "pass exactly one of --prompts (batch mode) or "
            "--http_port (HTTP endpoint mode)"
        )
    if args.dp > 1 and args.prompts is not None and args.batch_size % args.dp:
        raise SystemExit(
            f"--batch_size {args.batch_size} must be divisible by "
            f"--dp {args.dp} (each dp shard denoises batch/dp rows)")
    if args.warmup_shapes:
        if args.http_port is None:
            raise SystemExit("--warmup_shapes applies to HTTP mode")
        _parse_warmup_shapes(args.warmup_shapes)  # fail before the load

    rows = None  # .jsonl mode: per-row prompt/negative/seed dicts
    if args.prompts is not None:
        # read and check before the model load, so a typo fails at once
        if args.prompts.endswith(".jsonl"):
            rows = _load_jsonl_rows(Path(args.prompts), args)
            prompts = [r["prompt"] for r in rows]
        else:
            prompts = [
                line.strip()
                for line in Path(args.prompts).read_text().splitlines()
                if line.strip()
            ]
        if not prompts:
            raise SystemExit(f"no prompts in {args.prompts}")
        if args.precomputed_dir:
            # a caption missing from the cache (negatives included) fails
            # here, not after the model load
            from f_lite_tpu_torch.text.encoder import PrecomputedTextEncoder

            te = PrecomputedTextEncoder(args.precomputed_dir)
            need = list(prompts)
            if rows is not None:
                need += [r["negative_prompt"] for r in rows
                         if r["negative_prompt"]]
            elif args.negative_prompt:
                need.append(args.negative_prompt)
            missing = [p for p in need if not te.has(p)]
            if missing:
                raise SystemExit(
                    f"{len(missing)} caption(s) not in the precompute "
                    f"cache {args.precomputed_dir} (first: "
                    f"{missing[0]!r}) — run python -m f_lite_tpu_torch."
                    "tools.precompute_embeddings on them first"
                )

    import torch.distributed as dist

    owned = not dist.is_initialized()
    try:
        pipe = build_pipeline(args)
        group = RankGroup(pipe, args) if dist.is_initialized() else None
        if args.http_port is None:
            return run_batch(pipe, args, prompts, rows, group)
        if group is not None and group.rank != 0:
            return group.follow()
        try:
            return run_http(pipe, args, group)
        finally:
            if group is not None:
                group.stop()
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def run_batch(pipe, args, prompts: list[str], rows: list[dict] | None,
              group=None) -> dict:
    """Batch mode: every prompt to a stamped PNG in --output_dir, and a
    manifest with the images/min. Across ranks (`group`) each dp group
    denoises its rows of each batch and its first rank writes their PNGs;
    rank 0 writes the manifest once every rank is done."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from f_lite_tpu_torch.utils.image import save_with_metadata

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    # this rank's dp group: rows [lo, lo + per) of every batch
    per = args.batch_size // args.dp
    lo = 0 if group is None else group.dp_index * per
    writes = group is None or group.leader
    # pad the final batch to the batch size: every call has one shape
    bs = args.batch_size
    n = len(prompts)
    items = rows if rows is not None else prompts
    padded = items + [items[-1]] * ((-n) % bs)

    results = []
    # PNG encode and write on threads: the card starts the next batch
    # while the host writes the last one's images
    saver = ThreadPoolExecutor(2)
    pending = []
    shared_kwargs = dict(
        height=args.height, width=args.width,
        num_inference_steps=args.steps,
        guidance_scale=args.guidance_scale,
        guidance_interval=args.guidance_interval,
        steps_per_dispatch=args.steps_per_dispatch,
        sampler=args.sampler,
        pad_context_to=args.text_bucket or None,
    )
    t_start = time.perf_counter()
    try:
        for bi in range(0, len(padded), bs):
            chunk = padded[bi:bi + bs]
            t0 = time.perf_counter()
            if group is not None:
                chunk = chunk[lo:lo + per]
            if rows is not None:
                # per-row negatives and per-row seeded latents
                embeds, mask, nemb, nmask = _encode_rows(
                    pipe, [r["prompt"] for r in chunk],
                    [r["negative_prompt"] for r in chunk])
                out = pipe(
                    prompt_embeds=embeds, negative_embeds=nemb,
                    context_mask=mask, negative_context_mask=nmask,
                    latents=_row_latents(pipe, [r["seed"] for r in chunk],
                                         args.height, args.width),
                    **shared_kwargs,
                )
            elif group is not None:
                # the whole batch's latents from its seed, as one GPU draws
                # them; this group's rows of them
                out = pipe(
                    prompt=chunk,
                    negative_prompt=([args.negative_prompt] * len(chunk)
                                     if args.negative_prompt else None),
                    latents=_batch_latents(pipe, args.seed + bi, bs, args.height,
                                           args.width)[lo:lo + per],
                    **shared_kwargs,
                )
            else:
                out = pipe(
                    prompt=chunk,
                    negative_prompt=([args.negative_prompt] * len(chunk)
                                     if args.negative_prompt else None),
                    generator=torch.Generator(pipe.device).manual_seed(args.seed + bi),
                    **shared_kwargs,
                )
            dt = time.perf_counter() - t0
            for j, img in enumerate(out.images):
                idx = bi + (0 if group is None else lo) + j
                if idx >= n:
                    break
                f = out_dir / f"{idx:05d}.png"
                meta = {
                    "prompt": prompts[idx],
                    "width": args.width, "height": args.height,
                    "steps": args.steps,
                    "guidance_scale": args.guidance_scale,
                    "guidance_interval": args.guidance_interval,
                    "sampler": args.sampler,
                    "model": args.model,
                    "quantize": args.quantize or None,
                }
                if rows is not None:
                    # per-row latents: the row reproduces alone
                    meta["negative_prompt"] = rows[idx]["negative_prompt"]
                    meta["seed"] = rows[idx]["seed"]
                else:
                    meta["negative_prompt"] = args.negative_prompt
                    meta["seed"] = args.seed + bi
                    # one seed draws the whole batch (--from_png warns)
                    meta["batch_size"] = bs
                    meta["batch_index"] = idx - bi
                if writes:
                    pending.append(saver.submit(save_with_metadata, img, f, meta))
            for idx in range(bi, min(bi + bs, n)):
                entry = {"prompt": prompts[idx], "file": str(out_dir / f"{idx:05d}.png")}
                if rows is not None:
                    entry["seed"] = rows[idx]["seed"]
                results.append(entry)
            logger.info("batch %d: %.2fs (%.2fs/image)",
                        bi // bs, dt, dt / len(chunk))
        for fut in pending:
            fut.result()  # surface write errors: every file is written
    finally:
        saver.shutdown()
    if group is not None:  # every group's files are written
        group.barrier()
    wall = time.perf_counter() - t_start
    manifest = {
        "images": results,
        "wall_s": wall,
        "images_per_min": 60.0 * n / wall,
    }
    if group is not None and group.rank != 0:
        return manifest
    (out_dir / "manifest.json").write_text(json.dumps(manifest, indent=2))
    print(json.dumps({
        "images": n, "wall_s": round(wall, 2),
        "images_per_min": round(60.0 * n / wall, 2),
    }))
    return manifest


def _encode_rows(pipe, prompts, negs):
    """(embeds, mask, neg_embeds, neg_mask) for per-row prompts with
    optional per-row negatives. A row without a negative keeps the zeros
    context of a solo call, and an encoder that cannot encode any text
    (`PrecomputedTextEncoder`) never sees it."""
    import numpy as np

    embeds, mask = pipe.text_encoder.encode(list(prompts))
    embeds, mask = np.asarray(embeds), np.asarray(mask)
    with_neg = [i for i, x in enumerate(negs) if x]
    if with_neg:
        sub, subm = pipe.text_encoder.encode([negs[i] for i in with_neg])
        sub, subm = np.asarray(sub), np.asarray(subm)
        nemb = np.zeros((len(prompts), sub.shape[1], sub.shape[2]), np.float32)
        nmask = np.ones((len(prompts), subm.shape[1]), bool)
        nemb[with_neg] = sub
        nmask[with_neg] = subm
    else:
        nemb = np.zeros_like(embeds)
        nmask = np.ones(mask.shape, bool)
    return embeds, mask, nemb, nmask


def _batch_latents(pipe, seed, batch, height, width):
    """The starting noise `pipe(..., generator=torch.Generator(device).
    manual_seed(seed))` draws for `batch` rows."""
    import torch

    shape = (batch, height // pipe.vae_scale_factor, width // pipe.vae_scale_factor,
             pipe.dit.config.in_channels)
    return torch.randn(shape, generator=torch.Generator(pipe.device).manual_seed(seed),
                       device=pipe.device, dtype=pipe.dit.dtype)


def _row_latents(pipe, seeds, height, width):
    """One latent row per seed, each drawn as a batch-1 `pipe(...,
    generator=torch.Generator(device).manual_seed(seed))` draws its start
    noise: batching never changes what a seed gives."""
    import torch

    cfg = pipe.dit.config
    shape = (1, height // pipe.vae_scale_factor, width // pipe.vae_scale_factor,
             cfg.in_channels)
    device = pipe.device
    return torch.cat([
        torch.randn(shape, generator=torch.Generator(device).manual_seed(s),
                    device=device, dtype=pipe.dit.dtype)
        for s in seeds
    ])


class ServerMetrics:
    """Prometheus-text-format counters for the HTTP endpoint: requests by
    endpoint and status, images, calls, rows a call, the calls' seconds by
    the host clock (`f_lite_generate_seconds_total`, and a p50/p95 window
    of them) and on the card (`f_lite_device_seconds_total`, CUDA events:
    `_device_timed`), and the batcher's queue wait
    (`f_lite_queue_seconds_total`, enqueue to dispatch). The JAX server's
    compile-cache gauges have no counterpart: the port compiles nothing
    per shape."""

    def __init__(self):
        import collections
        import threading

        self._lock = threading.Lock()
        self.requests = {}  # (endpoint, status) -> count
        self.generate_seconds = 0.0
        self.device_seconds = 0.0
        self.queue_seconds = 0.0
        self.images = 0
        self.batch_rows = 0
        self.dispatch_count = 0
        self._latency = collections.deque(maxlen=1000)

    def record_request(self, endpoint: str, status: int):
        with self._lock:
            k = (endpoint, str(status))
            self.requests[k] = self.requests.get(k, 0) + 1

    def record_dispatch(self, generate_s: float, device_s: float | None, rows: int):
        """Once per pipeline call: its host seconds, its device seconds
        (None off the card) and its rows."""
        with self._lock:
            self.generate_seconds += generate_s
            self.device_seconds += device_s or 0.0
            self.batch_rows += rows
            self.dispatch_count += 1
            self._latency.append(generate_s)

    def record_queue(self, wait_s: float):
        """Seconds requests waited in the batcher's queue."""
        with self._lock:
            self.queue_seconds += wait_s

    def record_image(self):
        with self._lock:
            self.images += 1

    def render(self) -> str:
        with self._lock:
            lines = ["# TYPE f_lite_requests_total counter"]
            for (ep, status), n in sorted(self.requests.items()):
                lines.append(
                    f'f_lite_requests_total{{endpoint="{ep}",'
                    f'status="{status}"}} {n}'
                )
            lines += [
                "# TYPE f_lite_images_total counter",
                f"f_lite_images_total {self.images}",
                "# TYPE f_lite_generate_seconds_total counter",
                f"f_lite_generate_seconds_total {self.generate_seconds:.3f}",
                "# TYPE f_lite_device_seconds_total counter",
                f"f_lite_device_seconds_total {self.device_seconds:.3f}",
                "# TYPE f_lite_queue_seconds_total counter",
                f"f_lite_queue_seconds_total {self.queue_seconds:.3f}",
                "# TYPE f_lite_dispatches_total counter",
                f"f_lite_dispatches_total {self.dispatch_count}",
                "# TYPE f_lite_batch_rows_avg gauge",
                f"f_lite_batch_rows_avg "
                f"{self.batch_rows / max(self.dispatch_count, 1):.3f}",
            ]
            lat = sorted(self._latency)
            if lat:
                p50 = lat[len(lat) // 2]
                p95 = lat[min(len(lat) - 1, int(len(lat) * 0.95))]
                lines += [
                    "# TYPE f_lite_generate_seconds_p50 gauge",
                    f"f_lite_generate_seconds_p50 {p50:.3f}",
                    "# TYPE f_lite_generate_seconds_p95 gauge",
                    f"f_lite_generate_seconds_p95 {p95:.3f}",
                ]
        return "\n".join(lines) + "\n"


class RankGroup:
    """The ranks of a multi-GPU server (torchrun, dp x tp ranks; rank r is
    in dp group r // tp, whose first rank is its leader). Rank 0 serves:
    `call` hands a dispatch to every rank over a gloo group, runs its own
    share and gathers each rank's answer; the other ranks wait in
    `follow` until `stop`. Every rank answers, with its result or its
    error, so none is left in a collective when another raises. The group
    waits without a timeout (an idle server), and the followers ignore
    SIGTERM: they stop when rank 0 has drained."""

    def __init__(self, pipe, args):
        import datetime
        import threading

        import torch.distributed as dist

        self.pipe, self.args = pipe, args
        self.world, self.rank = dist.get_world_size(), dist.get_rank()
        self.dp_index, self.leader = divmod(self.rank, args.tp)
        self.leader = self.leader == 0
        self.group = dist.new_group(backend="gloo",
                                    timeout=datetime.timedelta(days=365))
        self._lock = threading.Lock()
        self._stopped = False

    def _run(self, kind, payload):
        """This rank's share of a dispatch: ("ok", its result where it
        leads its dp group, else None) or ("error", the exception)."""
        try:
            result = _dispatch(self.pipe, self.args, kind, payload, self.dp_index)
            return "ok", result if self.leader else None
        except Exception as e:  # answered, never left in a collective
            logger.exception("rank %d: %s failed", self.rank, kind)
            return "error", e if self.rank == 0 else RuntimeError(
                f"rank {self.rank}: {type(e).__name__}: {e}")

    def call(self, kind: str, payload):
        """Run a dispatch on every rank (rank 0): each dp group's leader's
        result, by dp group. Raises rank 0's own error, or the first
        other rank's."""
        import torch.distributed as dist

        with self._lock:
            msg = [(kind, payload)]
            dist.broadcast_object_list(msg, src=0, group=self.group)
            mine = self._run(kind, payload)
            answers = [None] * self.world
            dist.gather_object(mine, answers, dst=0, group=self.group)
        errors = [a[1] for a in answers if a[0] == "error"]
        if errors:
            raise errors[0]
        return [a[1] for a in answers[::self.args.tp]]

    def follow(self):
        """The loop of a rank other than 0: run each dispatch until a stop."""
        import signal

        import torch.distributed as dist

        signal.signal(signal.SIGTERM, lambda *_: logger.info(
            "rank %d: SIGTERM: waiting for rank 0's stop", self.rank))
        while True:
            msg = [None]
            dist.broadcast_object_list(msg, src=0, group=self.group)
            kind, payload = msg[0]
            if kind == "stop":
                logger.info("rank %d: stopped by rank 0", self.rank)
                return None
            dist.gather_object(self._run(kind, payload), None, dst=0, group=self.group)

    def barrier(self):
        import torch.distributed as dist

        dist.barrier(group=self.group)

    def stop(self):
        """Send the other ranks out of `follow` (rank 0; once)."""
        import torch.distributed as dist

        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            dist.broadcast_object_list([("stop", None)], src=0, group=self.group)


def _device_timed(pipe, fn):
    """(fn(), its device seconds): CUDA events recorded on the current
    stream before and after the call, read once the call's own copy back
    to the host has waited for its work (None off the card)."""
    import torch

    if pipe.device.type != "cuda":
        return fn(), None
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()  # the stream has drained at the copy back
    return out, start.elapsed_time(end) / 1e3


def _dispatch(pipe, args, kind: str, payload, dp_index: int):
    """What every rank runs for a `RankGroup` dispatch: "generate" (one
    request at dp 1: its image and device seconds), "rows" (a batcher's dp
    rows: this dp group's row, as a stamped PNG, its seconds and device
    seconds) or "warm" (a warm-up by embeddings)."""
    if kind == "generate":
        return _device_timed(pipe, lambda: _serve_generate(pipe, args, payload).images[0])
    if kind == "rows":
        key, reqs = payload
        pngs, dt, device_s = _generate_rows(pipe, args, key, reqs[dp_index:dp_index + 1])
        return pngs[0], dt, device_s
    if kind == "warm":
        return _warm_by_embeds(pipe, args, *payload)
    raise ValueError(f"unknown dispatch {kind!r}")


def _generate_rows(pipe, args, key, reqs: list[dict]):
    """Requests of one shape key as one pipeline call, each row with its
    own latents (drawn as its solo call draws them): (their stamped PNGs,
    the call's seconds, its device seconds)."""
    from f_lite_tpu_torch.utils.image import png_bytes_with_metadata

    width, height, steps, sampler, g = key

    def call():
        embeds, mask, nemb, nmask = _encode_rows(
            pipe, [r["prompt"] for r in reqs], [r["negative_prompt"] for r in reqs])
        return pipe(
            prompt_embeds=embeds, negative_embeds=nemb,
            context_mask=mask, negative_context_mask=nmask,
            latents=_row_latents(pipe, [r["seed"] for r in reqs], height, width),
            height=height, width=width, num_inference_steps=steps,
            guidance_scale=g, guidance_interval=args.guidance_interval,
            steps_per_dispatch=args.steps_per_dispatch, sampler=sampler,
            pad_context_to=args.text_bucket or None,
        )

    # timed: text encode, latents, denoise and decode, the work the
    # one-GPU path times inside its lock
    t0 = time.perf_counter()
    out, device_s = _device_timed(pipe, call)
    dt = time.perf_counter() - t0
    # no batch_size / batch_index stamp: each row reproduces alone
    return [png_bytes_with_metadata(img, _request_metadata(r, args))
            for img, r in zip(out.images, reqs)], dt, device_s


class RequestBatcher:
    """Microbatch queued HTTP requests into one dispatch of dp rows
    (`f_lite_tpu/serve.py` RequestBatcher).

    Requests of one shape key (width, height, steps, sampler,
    guidance_scale) are grouped: the dispatcher thread takes the oldest
    queued request, waits up to `--batch_window_ms` for more of its key,
    pads the group to dp rows (repeating the last) and runs one dispatch
    across the ranks (`RankGroup`), each dp group denoising its row. Each
    row's latents are drawn as a batch-1 call with its seed draws them,
    so a row is its request's solo image. FIFO head-of-line: other keys
    wait their turn. The seconds each request waited from its enqueue to
    its dispatch go to the server's `record_queue`."""

    def __init__(self, pipe, args, group, max_batch: int, window_s: float):
        import threading

        self.pipe, self.args, self.group = pipe, args, group
        self.max_batch, self.window = max_batch, window_s
        self.metrics = None  # the server's ServerMetrics, where it has one
        self._cv = threading.Condition()
        self._q: list = []  # (key, request, Future, enqueue time)
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="f-lite-batcher")
        self._thread.start()

    @classmethod
    def from_args(cls, pipe, args, group):
        return cls(pipe, args, group, max_batch=args.dp,
                   window_s=args.batch_window_ms / 1000.0)

    @staticmethod
    def _key(r: dict):
        return (r["width"], r["height"], r["steps"], r["sampler"],
                r["guidance_scale"])

    def submit(self, r: dict):
        """Queue a parsed request: a Future of (png bytes, dispatch
        seconds, rows in the dispatch)."""
        from concurrent.futures import Future

        f: Future = Future()
        with self._cv:
            if self._stop:
                raise RuntimeError("batcher stopped")
            self._q.append((self._key(r), r, f, time.monotonic()))
            self._cv.notify_all()
        return f

    def stop(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=5)

    def _loop(self):
        while True:
            with self._cv:
                while not self._q and not self._stop:
                    self._cv.wait()
                if self._stop:
                    err = RuntimeError("server shutting down")
                    for _, _, f, _ in self._q:
                        f.set_exception(err)
                    self._q.clear()
                    return
                key = self._q[0][0]
                deadline = time.monotonic() + self.window

                def matching():
                    return [i for i, (k, _, _, _) in enumerate(self._q) if k == key]

                while len(matching()) < self.max_batch and not self._stop:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cv.wait(timeout=left)
                if self._stop:
                    continue  # the loop's top fails everything queued
                idxs = matching()[: self.max_batch]
                batch = [self._q[i] for i in idxs]
                for i in reversed(idxs):
                    del self._q[i]
            if self.metrics is not None:
                now = time.monotonic()
                self.metrics.record_queue(sum(now - t for _, _, _, t in batch))
            try:
                reqs = [r for _, r, _, _ in batch]
                rows = reqs + [reqs[-1]] * (self.max_batch - len(reqs))
                answers = self.group.call("rows", (key, rows))
                dt = max(a[1] for a in answers)
                # card-seconds: the device seconds of each dp group's leader
                device_s = sum(a[2] for a in answers if a[2] is not None)
                if self.metrics is not None:
                    self.metrics.record_dispatch(dt, device_s, len(batch))
                for (_, _, f, _), (png, _, _) in zip(batch, answers):
                    f.set_result((png, dt, len(batch)))
            except Exception as e:  # to every waiter; the loop serves on
                logger.exception("batched generation failed")
                for _, _, f, _ in batch:
                    if not f.done():
                        f.set_exception(e)


def make_http_server(pipe, args, host="127.0.0.1", port=0, batcher=None,
                     group=None):
    """HTTP endpoint over a loaded pipeline (stdlib ThreadingHTTPServer).

    POST /generate  {"prompt": str, "negative_prompt"?, "width"?,
                     "height"?, "steps"?, "guidance_scale"?, "seed"?,
                     "sampler"?, "image"?, "mask_image"?, "strength"?}
                                            -> image/png (stamped)
    GET  /healthz                           -> {"status": "ok", ...}
    GET  /metrics                           -> Prometheus text format

    Device work is serialised by a lock; concurrent requests queue on it.
    Across ranks (`group`, rank 0) each request is a dispatch to every
    rank, and with --dp > 1 a `RequestBatcher` (`batcher`, made here when
    not given) replaces the lock: same-shape requests share a dispatch,
    `X-F-Lite-Batch` says how many, and image inputs get 400. A request
    without a seed takes the next of a counter from --seed, and the seed
    used is stamped into the PNG. Returns the server; the caller owns
    serve_forever() and shutdown() (and `server.batcher.stop()` where
    set). `server.begin_drain()` turns new work away with 503, and
    `server.drain_wait()` waits for the work in flight."""
    import itertools
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from f_lite_tpu_torch.text.encoder import PrecomputedTextEncoder
    from f_lite_tpu_torch.utils.image import png_bytes_with_metadata

    # a cache-backed server checks each request's captions up front
    precomputed_te = (pipe.text_encoder
                      if isinstance(pipe.text_encoder, PrecomputedTextEncoder)
                      else None)
    if batcher is None and args.dp > 1:
        batcher = RequestBatcher.from_args(pipe, args, group)
    metrics = ServerMetrics()
    if batcher is not None:
        batcher.metrics = metrics
    device_lock = threading.Lock()
    # drain state: 503 for new work, work in flight finishes
    drain = {"on": False, "inflight": 0}
    drain_cv = threading.Condition()
    auto_seed = itertools.count(args.seed)
    seed_lock = threading.Lock()

    class BadRequest(ValueError):
        pass

    def _int_field(req, key, default, lo, hi):
        # only values a request supplies are range-checked: the server's
        # own defaults are taken as they are
        if key not in req:
            return default
        v = req[key]
        if not isinstance(v, int) or isinstance(v, bool) or not lo <= v <= hi:
            raise BadRequest(f"{key} must be an integer in [{lo}, {hi}]")
        return v

    def _parse_request(req):
        if not isinstance(req, dict):
            raise BadRequest("body must be a JSON object")
        prompt = req.get("prompt")
        if not isinstance(prompt, str) or not prompt.strip():
            raise BadRequest("prompt (non-empty string) is required")
        if len(prompt) > 10_000:
            raise BadRequest("prompt too long (max 10000 chars)")
        neg = req.get("negative_prompt")
        if neg is not None and not isinstance(neg, str):
            raise BadRequest("negative_prompt must be a string")
        width = _int_field(req, "width", args.width, 16, 2048)
        height = _int_field(req, "height", args.height, 16, 2048)
        if width % 16 or height % 16:
            raise BadRequest("width/height must be multiples of 16")
        steps = _int_field(req, "steps", args.steps, 1, 200)
        g = req.get("guidance_scale", args.guidance_scale)
        if not isinstance(g, (int, float)) or isinstance(g, bool) \
                or not 0.0 <= float(g) <= 30.0:
            raise BadRequest("guidance_scale must be a number in [0, 30]")
        sampler = req.get("sampler", args.sampler)
        if sampler not in SAMPLERS:
            raise BadRequest(f"sampler must be one of {sorted(SAMPLERS)}")
        f = pipe.vae_scale_factor
        image = _image_field(req, "image", "RGB", height, width)
        mask_image = _image_field(req, "mask_image", "L", height // f, width // f)
        if mask_image is not None and image is None:
            raise BadRequest("mask_image requires image")
        strength = req.get("strength", 0.8)
        if image is not None and (
            not isinstance(strength, (int, float))
            or isinstance(strength, bool)
            or not 0.0 < float(strength) <= 1.0
        ):
            raise BadRequest("strength must be a number in (0, 1]")
        if "seed" in req:
            seed = _int_field(req, "seed", None, 0, 2**31 - 1)
        else:
            with seed_lock:
                seed = next(auto_seed)
        if precomputed_te is not None:
            for cap in filter(None, (prompt, neg)):
                if not precomputed_te.has(cap):
                    raise BadRequest(
                        f"caption not in the precompute cache: {cap!r}"
                    )
        return dict(prompt=prompt, negative_prompt=neg or None,
                    width=width, height=height, steps=steps,
                    guidance_scale=float(g), sampler=sampler, seed=seed,
                    image=image, mask_image=mask_image,
                    strength=float(strength))

    def _image_field(req, key, mode, height, width):
        """An optional base64 image field -> what the pipeline takes,
        checked here so a bad upload is a 400, not a 500 mid-generation."""
        v = req.get(key)
        if v is None:
            return None
        if not isinstance(v, str):
            raise BadRequest(f"{key} must be a base64-encoded image string")
        import base64
        import binascii

        from f_lite_tpu_torch.utils.image import ImageTooLarge, NeedsResize, load_image

        try:
            raw = base64.b64decode(v, validate=True)
        except (binascii.Error, ValueError):
            raise BadRequest(f"{key}: invalid base64")
        if len(raw) > 6 << 20:
            raise BadRequest(f"{key}: decoded image too large (max 6 MiB)")
        try:
            # the declared size is checked before any pixel is decoded: a
            # small file can declare gigapixels, and without PIL one of
            # another size than the request's is refused unread
            return load_image(raw, mode, max_pixels=MAX_UPLOAD_PIXELS,
                              size=(height, width), what=key)
        except ImageTooLarge as e:
            raise BadRequest(f"{key}: {e} (max 4096x4096)")
        except NeedsResize as e:
            raise BadRequest(str(e))
        except ValueError as e:
            raise BadRequest(f"{key}: not a decodable image ({e})")

    class Handler(BaseHTTPRequestHandler):
        # a client that stops sending mid-body releases its thread
        timeout = 120

        def log_message(self, fmt, *a):
            msg = fmt % a
            if "/healthz" not in msg and "/metrics" not in msg:
                logger.info("http %s", msg)

        def _endpoint(self):
            p = self.path.split("?", 1)[0].lstrip("/")
            return p if p in ("generate", "healthz", "metrics") else "other"

        def _json(self, code, obj):
            metrics.record_request(self._endpoint(), code)
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                if drain["on"]:
                    # not ready: balancers stop routing here
                    return self._json(503, {"status": "draining"})
                self._json(200, {
                    "status": "ok", "model": args.model,
                    "quantize": bool(args.quantize), "tp": args.tp,
                    "dp": args.dp, "device": str(pipe.device),
                    "default": {"width": args.width, "height": args.height,
                                "steps": args.steps},
                })
            elif self.path == "/metrics":
                body = metrics.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": "unknown path (try /generate)"})

        def do_POST(self):
            if self.path != "/generate":
                return self._json(404, {"error": "POST /generate only"})
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                return self._json(400, {"error": "bad Content-Length"})
            # the declared length is bounded before anything is read
            if not 0 <= length <= 1 << 23:
                return self._json(413, {"error": "body too large (max 8 MiB)"})
            try:
                req = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, UnicodeDecodeError):
                return self._json(400, {"error": "invalid JSON body"})
            try:
                r = _parse_request(req)
            except BadRequest as e:
                return self._json(400, {"error": str(e)})
            # only the flag and the counter under drain_cv: a socket write
            # to a slow client must never hold it
            with drain_cv:
                rejected = drain["on"]
                if not rejected:
                    drain["inflight"] += 1
            if rejected:
                return self._json(503, {"error": "server is draining (shutting down)"})
            try:
                return self._generate_locked(r)
            finally:
                with drain_cv:
                    drain["inflight"] -= 1
                    drain_cv.notify_all()

        def _generate_locked(self, r):
            if batcher is not None and r["image"] is not None:
                # the batcher's rows share one call of one shape
                return self._json(400, {
                    "error": "image inputs are not supported with --dp "
                             "request batching; use a --dp 1 server "
                             "for image-to-image/inpainting"
                })
            rows = 1
            try:
                if batcher is not None:
                    # the dispatcher thread owns the device; the seconds
                    # are the shared dispatch's (it records the metrics)
                    png, dt, rows = batcher.submit(r).result()
                else:
                    with device_lock:
                        # timed inside the lock: the call, not the queue
                        t0 = time.perf_counter()
                        image, device_s = (
                            _device_timed(pipe, lambda: _serve_generate(pipe, args, r).images[0])
                            if group is None else group.call("generate", r)[0])
                        dt = time.perf_counter() - t0
                    metrics.record_dispatch(dt, device_s, 1)
                    png = png_bytes_with_metadata(image, _request_metadata(r, args))
            except KeyError as e:
                if precomputed_te is not None:
                    # the embedding file went away after the check: still
                    # the caption's problem
                    return self._json(400, {
                        "error": str(e.args[0]) if e.args else "caption not precomputed"
                    })
                logger.exception("generation failed")
                return self._json(500, {"error": "generation failed (see server log)"})
            except Exception:
                logger.exception("generation failed")
                return self._json(500, {"error": "generation failed (see server log)"})
            metrics.record_request("generate", 200)
            metrics.record_image()
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(png)))
            self.send_header("X-F-Lite-Seed", str(r["seed"]))
            self.send_header("X-F-Lite-Seconds", f"{dt:.2f}")
            if batcher is not None:
                self.send_header("X-F-Lite-Batch", str(rows))
            self.end_headers()
            self.wfile.write(png)

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    server.batcher = batcher
    server.metrics = metrics

    def begin_drain():
        """Turn new generation work away (503, /healthz unready); work in
        flight runs on. Safe from a signal handler."""
        with drain_cv:
            drain["on"] = True
        logger.info("draining: new requests rejected, %d in flight",
                    drain["inflight"])

    def drain_wait(timeout_s: float = 600.0) -> bool:
        """Wait until the generations in flight finish (True) or timeout."""
        deadline = time.monotonic() + timeout_s
        with drain_cv:
            while drain["inflight"] > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                drain_cv.wait(timeout=left)
        return True

    server.begin_drain = begin_drain
    server.drain_wait = drain_wait
    return server


def _serve_generate(pipe, args, r: dict):
    """The one generation call of the HTTP handler and of its warm-up, so
    the warm-up runs what requests run (launch flags and the text bucket
    included)."""
    import torch

    return pipe(
        prompt=r["prompt"],
        negative_prompt=r["negative_prompt"],
        height=r["height"], width=r["width"],
        num_inference_steps=r["steps"],
        guidance_scale=r["guidance_scale"],
        guidance_interval=args.guidance_interval,
        generator=torch.Generator(pipe.device).manual_seed(r["seed"]),
        steps_per_dispatch=args.steps_per_dispatch,
        sampler=r["sampler"],
        pad_context_to=args.text_bucket or None,
        image=r.get("image"),
        mask_image=r.get("mask_image"),
        strength=r.get("strength", 0.8),
    )


def _request_metadata(r: dict, args) -> dict:
    """A request's stampable metadata: the uploaded image and mask are not
    stamped (strength and an inpaint flag are)."""
    meta = {k: v for k, v in r.items()
            if k not in ("image", "mask_image", "strength")}
    if r.get("image") is not None:
        meta["strength"] = r["strength"]
        meta["inpaint"] = (r.get("mask_image") is not None) or None
    meta.update(model=args.model, quantize=args.quantize or None,
                guidance_interval=args.guidance_interval)
    return meta


def _parse_warmup_shapes(spec: str) -> list[tuple[int, int]]:
    """--warmup_shapes 'WxH,WxH' -> [(w, h)], checked as requests are."""
    shapes = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            w, h = (int(x) for x in part.lower().split("x"))
        except ValueError:
            raise SystemExit(f"--warmup_shapes: bad entry {part!r} (want WxH)")
        if not (16 <= w <= 2048 and 16 <= h <= 2048) or w % 16 or h % 16:
            raise SystemExit(
                f"--warmup_shapes: {part}: sides must be multiples of "
                "16 in [16, 2048]"
            )
        shapes.append((w, h))
    return shapes


def _warm_by_embeds(pipe, args, width=None, height=None):
    """Warm a serving shape without the text encoder: a --precomputed_dir
    server has no caption it can be sure is cached, so zero embeddings at
    the bucketed context length go through denoise and decode."""
    import numpy as np

    width = width or args.width
    height = height or args.height
    s = args.text_bucket or 8
    c = pipe.dit.config.cross_attn_input_size
    emb = np.zeros((1, s, c), np.float32)
    mask = np.ones((1, s), bool)
    pipe(
        prompt_embeds=emb, negative_embeds=np.zeros_like(emb),
        context_mask=mask, negative_context_mask=mask,
        latents=_row_latents(pipe, [0], height, width),
        height=height, width=width,
        num_inference_steps=args.steps,
        guidance_scale=args.guidance_scale,
        guidance_interval=args.guidance_interval,
        steps_per_dispatch=args.steps_per_dispatch,
        sampler=args.sampler,
        pad_context_to=args.text_bucket or None,
    )


def warm_up(pipe, args, group=None, batcher=None) -> float:
    """One request of each warm-up shape through the serving path (by
    embeddings on a --precomputed_dir server; through `batcher` where
    given, else as a dispatch to every rank of `group`); the CUDA kernels
    are built and cuBLAS warmed here, before the port binds. Returns the
    seconds."""
    t0 = time.perf_counter()
    shapes = list(dict.fromkeys(
        [(args.width, args.height)]
        + (_parse_warmup_shapes(args.warmup_shapes) if args.warmup_shapes else [])
    ))
    for w, h in shapes:
        logger.info("warming %dx%d / %d steps...", w, h, args.steps)
        req = dict(prompt="warmup", negative_prompt=None, width=w, height=h,
                   steps=args.steps, guidance_scale=args.guidance_scale,
                   sampler=args.sampler, seed=0, image=None, mask_image=None)
        if args.precomputed_dir:
            if group is None:
                _warm_by_embeds(pipe, args, width=w, height=h)
            else:
                group.call("warm", (w, h))
        elif batcher is not None:
            batcher.submit(req).result()
        elif group is not None:
            group.call("generate", req)
        else:
            _serve_generate(pipe, args, req)
    return time.perf_counter() - t0


def run_http(pipe, args, group=None):
    """Warm the serving shapes, then serve until interrupted or SIGTERM
    (which drains). Across ranks this is rank 0's part (`group`); with
    --dp > 1 the warm-up runs through the request batcher, as requests
    will."""
    import signal
    import threading

    if not args.text_bucket:
        logger.warning("--text_bucket 0: the context length follows each prompt")
    batcher = None
    if args.dp > 1:
        batcher = RequestBatcher.from_args(pipe, args, group)
    try:
        logger.info("warm-up: %.1f s", warm_up(pipe, args, group, batcher))
    except BaseException:
        if batcher is not None:
            batcher.stop()
        raise
    server = make_http_server(pipe, args, host=args.http_host, port=args.http_port,
                              batcher=batcher, group=group)
    logger.info("serving on http://%s:%d (POST /generate)",
                *server.server_address[:2])

    def _term(_sig, _frm):
        server.begin_drain()

        def _finish():
            server.drain_wait(600.0)
            server.shutdown()

        threading.Thread(target=_finish, daemon=True).start()

    prev = signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
        logger.info("drained; shutting down")
    except KeyboardInterrupt:
        logger.info("shutting down")
    finally:
        signal.signal(signal.SIGTERM, prev)
        server.server_close()
        if server.batcher is not None:
            server.batcher.stop()
    return None


if __name__ == "__main__":
    main()
