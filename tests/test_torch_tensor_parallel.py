"""Tensor and sequence parallelism, head padding at load and multi-GPU
serving (`parallel/tensor.py`, `convert/heads.py`, `serve.py` `--dp` /
`--tp`) on the CPU, with gloo. Multi-rank jobs run in one spawn a world
size (2 and 4 processes started here as `torchrun` starts them, reusing
`tests/test_torch_parallel.py`'s helpers), at a tiny config in fp32: 6
heads (so tp 4 pads to 8), `residual_v`, `train_bias_and_rms`,
`dynamic_softmax_temperature`, cross-attention in blocks 0 and 2 of 3, and
both AdaLN modes. The one-rank references run in this process.

- the DiT's forward and every gradient at tp 2 and 4 (heads padded to 8),
  tp + sp with L divisible and not, and tp + sp under remat ("dots"),
  against one rank: within 1e-5 of each tensor's largest value (the
  padded heads' gradients zero);
- the collective audit: 3 all-reduces a cross-attention block and 2 a
  self-only block under TP, a reduce-scatter and an all-gather in place of
  each under SP (and one all-gather for the final layer), all on the tp
  group, also at dp 2 x tp 2;
- the trainer at `--tp 2` and `--tp 2 --sequence_parallel` against one
  rank and against the JAX trainer on injected draws (losses within 1e-5
  relative), `--dp 2 --tp 2` against one rank, and `--use_lora`, `--ema`
  and checkpoints (tp 2 -> tp 1 and tp 1 -> tp 2) at tp 2;
- `pad_heads_to`: within 1e-6 relative of no padding, MSE < 1e-9 against
  the JAX pipeline's `pad_heads_to`, and `save_pretrained` writes the
  unpadded files;
- int8 at tp 2 within the int8 noise of one rank, each row's amax the whole
  K's; the plain given-amax quantize equals the fused one fed its own amax;
- serving: a dp 2 HTTP server's batched rows bit-equal to their solo
  requests (`X-F-Lite-Batch` 2, an image input refused with JAX's 400, the
  follower leaving when rank 0 drains on SIGTERM), batch mode at dp 2
  writing the one-rank PNGs, and `--batch_size % dp` exiting as JAX does;
- the errors: a mesh that does not fill the world, `--sequence_parallel`
  without `--tp` > 1, and a tp that does not divide the heads (ValueError,
  as the JAX trainer raises; neither pads).
"""

import base64
import collections
import json
import multiprocessing
import os
import shutil
import signal
import threading
import traceback
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_parallel import _fixed, _fixed_loss_draws, _free_port, _record

STEPS = 3
TIMEOUT_S = 240
SIZE = 16  # the trainer's and the server's images: 64 patches + 16 registers


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the model-level cases
# ---------------------------------------------------------------------------

def _cfg(**kw):
    from f_lite_tpu_torch.models.dit import DiTConfig

    base = dict(in_channels=4, patch_size=2, hidden_size=96, depth=3, num_heads=6,
                cross_attn_input_size=24, residual_v=True, train_bias_and_rms=True,
                dynamic_softmax_temperature=True, cross_attn_period=2,
                cross_attn_first_n=1, n_register_tokens=4)
    base.update(kw)
    return DiTConfig(**base)


def _model(cfg):
    """A seeded DiT of `cfg` with every weight non-zero; a padded config
    pads the unpadded model's weights (`convert.heads`)."""
    import dataclasses

    from f_lite_tpu_torch.convert.heads import pad_dit_heads
    from f_lite_tpu_torch.models.dit import DiT

    if cfg.padded_heads:
        return pad_dit_heads(_model(dataclasses.replace(cfg, padded_heads=None)),
                             cfg.padded_heads)
    m = DiT(cfg).init_weights(torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    return m


def _inputs(size):
    g = torch.Generator().manual_seed(3)
    return (torch.randn(2, size, size, 4, generator=g), torch.randn(2, 5, 24, generator=g),
            torch.tensor([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], dtype=torch.bool),
            torch.tensor([0.3, 0.7]))


def _forward_backward(m, size):
    out = m(*_inputs(size))
    (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum().backward()
    return out.detach()


# name -> (sequence parallel, image size, config overrides). Size 8: 16
# patches + 4 registers = 20 tokens (divides by 2 and 4); size 6: 13.
# "remat": every block but the first recomputed in the backward ("dots"),
# its collectives with it
MODEL_CASES = {
    "tp": (False, 8, {}),
    "tp_sp": (True, 8, {"adaln_mode": "per_block"}),
    "tp_sp_uneven": (True, 6, {}),
    "tp_sp_remat": (True, 8, {"gradient_checkpoint": True, "gradient_checkpoint_from": 1,
                              "remat_policy": "dots"}),
}


def _splits_sequence(case, tp):
    sp, size, _ = MODEL_CASES[case]
    return sp and ((size // 2) ** 2 + 4) % tp == 0


def _case_cfg(name, world):
    kw = dict(MODEL_CASES[name][2])
    if 6 % world:
        kw["padded_heads"] = 8
    return _cfg(**kw)


def _audit(m, size):
    """The forward collectives of `m` under no_grad, with a marker where
    each block starts."""
    from f_lite_tpu_torch.parallel import tensor as tpar

    hooks = [b.register_forward_pre_hook(
        lambda mod, args, i=i: tpar._LOG.append(("block", i)))
        for i, b in enumerate(m.blocks)]
    with tpar.collective_log() as logged, torch.no_grad():
        m(*_inputs(size))
    for h in hooks:
        h.remove()
    return [list(x) for x in logged]


def _model_job(job_dir: Path, rank: int, world: int, job: dict) -> None:
    """Each model case at tp = world (or the (dp 2, 1, tp 2) mesh of
    `job["dp"]`): rank 0 saves the output and the whole gradients (the
    reference layout); every rank its audit."""
    from f_lite_tpu_torch.parallel.mesh import create_mesh
    from f_lite_tpu_torch.parallel.sharding import full_tensor
    from f_lite_tpu_torch.parallel.tensor import parallelize_dit

    dp = job.get("dp", 1)
    mesh = create_mesh(dp, 1, world // dp, device_type="cpu")
    seen = {}
    for name, (sp, size, _) in MODEL_CASES.items():
        m = _model(_case_cfg(name, world // dp))
        parallelize_dit(m, mesh["tp"], sequence_parallel=sp)
        out = _forward_backward(m, size)
        grads = {n: full_tensor(p.grad, n).numpy() for n, p in m.named_parameters()}
        if rank == 0:
            np.savez(job_dir / f"{name}.npz", out=out.numpy(),
                     **{f"grad/{k}": v for k, v in grads.items()})
        seen[name] = _audit(m, size)
    if world // dp == 2:  # the int8 DiT's forward at tp 2
        from f_lite_tpu_torch.quant import quantize_dit

        m = parallelize_dit(quantize_dit(_model(_cfg())), mesh["tp"])
        with torch.no_grad():
            out = m(*_inputs(8))
        if rank == 0:
            np.save(job_dir / "int8.npy", out.numpy())
    (job_dir / f"rank{rank}.json").write_text(json.dumps(seen))


def _int8_job(job_dir: Path, rank: int, job: dict) -> None:
    """The pipeline at --tp 2 --quantize (serve's build_pipeline): the
    final latents of one call from embeddings (rank 0 saves them)."""
    from f_lite_tpu_torch import serve

    pipe = serve.build_pipeline(serve.parse_args(job["argv"]))
    lat = _latents_of(pipe)
    if rank == 0:
        np.save(job_dir / "latents.npy", lat)
    (job_dir / f"rank{rank}.json").write_text("{}")


def _latents_of(pipe) -> np.ndarray:
    rs = np.random.RandomState(7)
    emb = rs.randn(2, 6, 32).astype(np.float32)
    mask = np.arange(6)[None] < np.array([[6], [3]])
    out = pipe(prompt_embeds=emb, context_mask=mask, height=SIZE, width=SIZE,
               latents=rs.randn(2, SIZE, SIZE, 3).astype(np.float32),
               num_inference_steps=3, guidance_scale=5.0, output_type="latent")
    return out.images.float().numpy()


def _png_b64(a) -> str:
    from f_lite_tpu_torch.utils.image import png_bytes_with_metadata

    return base64.b64encode(png_bytes_with_metadata(a)).decode()


def _post(port, body: dict):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


# the requests a dp 2 server batches, and the image request it refuses
HTTP_REQUESTS = [{"prompt": "a red circle", "seed": 11},
                 {"prompt": "a blue square", "seed": 12, "negative_prompt": "blurry"}]


def _http_job(job_dir: Path, rank: int, job: dict) -> None:
    """`serve.main` on every rank (HTTP, --dp 2). Rank 0: /healthz, the
    two requests posted together, an image request, then SIGTERM to
    itself; both ranks record that main returned."""
    from f_lite_tpu_torch import serve

    seen = {}
    if rank == 0:
        made = {}
        ready = threading.Event()
        original = serve.make_http_server

        def capture(*a, **kw):
            made["server"] = original(*a, **kw)
            ready.set()
            return made["server"]

        def client():
            ready.wait(120)
            port = made["server"].server_address[1]
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
                seen["healthz"] = json.loads(r.read())
            answers = [None, None]
            threads = [threading.Thread(target=lambda i=i: answers.__setitem__(
                i, _post(port, HTTP_REQUESTS[i]))) for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            seen["answers"] = [(s, h.get("X-F-Lite-Batch"), base64.b64encode(b).decode())
                               for s, h, b in answers]
            status, _, body = _post(port, {"prompt": "x", "image": _png_b64(
                np.zeros((SIZE, SIZE, 3), np.uint8))})
            seen["image"] = (status, json.loads(body))
            os.kill(os.getpid(), signal.SIGTERM)

        serve.make_http_server = capture
        threading.Thread(target=client, daemon=True).start()
        try:
            serve.main(job["argv"])
        finally:
            serve.make_http_server = original
    else:
        serve.main(job["argv"])
    seen["returned"] = True
    (job_dir / f"rank{rank}.json").write_text(json.dumps(seen))


def _batch_job(job_dir: Path, rank: int, job: dict) -> None:
    from f_lite_tpu_torch import serve

    serve.main(job["argv"])
    (job_dir / f"rank{rank}.json").write_text("{}")


def _error_job(job_dir: Path, rank: int, job: dict) -> None:
    """A trainer run that must raise: its exception, recorded."""
    try:
        _record(job_dir, rank, job)
        seen = {"error": None}
    except Exception as e:
        seen = {"error": type(e).__name__, "message": str(e)}
    (job_dir / f"rank{rank}.json").write_text(json.dumps(seen))


def _tp_worker(rank: int, world: int, port: int, jobs: list, out: str) -> None:
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from f_lite_tpu_torch.parallel.mesh import init_distributed

    try:
        init_distributed("cpu")
        for job in jobs:
            if "copy" in job:
                if rank == 0:
                    shutil.copytree(job["copy"][0], job["copy"][1])
                dist.barrier()
                continue
            job_dir = Path(out) / job["name"]
            job_dir.mkdir(parents=True, exist_ok=True)
            kind = job.get("kind", "train")
            if kind == "model":
                _model_job(job_dir, rank, world, job)
            elif kind == "train":
                _record(job_dir, rank, job)
            else:
                {"int8": _int8_job, "http": _http_job, "batch": _batch_job,
                 "error": _error_job}[kind](job_dir, rank, job)
            dist.barrier()
    except BaseException:
        (Path(out) / f"error_rank{rank}.txt").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn(world: int, jobs: list, out: Path) -> dict:
    """`jobs` on `world` spawned ranks: {job name: [each rank's record]}."""
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_tp_worker, args=(r, world, port, jobs, str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    errors = "".join(f.read_text() for f in sorted(out.glob("error_rank*.txt")))
    assert not alive and all(p.exitcode == 0 for p in procs), (
        f"exit codes {[p.exitcode for p in procs]}, timed out {len(alive)}\n{errors}")
    return {job["name"]: [json.loads((out / job["name"] / f"rank{r}.json").read_text())
                          for r in range(world)]
            for job in jobs if "name" in job}


# ---------------------------------------------------------------------------
# the trainer's recipe (6 heads) and the serving pipeline
# ---------------------------------------------------------------------------

def _base_argv(root: Path, out: Path, *extra) -> list:
    return ["--device", "cpu", "--use_precomputed_data",
            "--precomputed_data_dir", str(root / "cache"), "--pixel_space",
            "--model_width", "96", "--model_depth", "3", "--model_head_dim", "16",
            "--cross_attn_input_size", "32", "--residual_v", "--train_bias_and_rms",
            "--cross_attn_period", "2", "--cross_attn_first_n", "1",
            "--train_batch_size", "8", "--num_epochs", "3",
            "--max_steps", str(STEPS), "--learning_rate", "1e-3",
            "--lr_scheduler", "constant", "--num_warmup_steps", "1",
            "--max_grad_norm", "0.3",
            "--log_every", "1", "--seed", "0", "--report_to", "none",
            "--sample_every", "0", "--eval_every", "0", "--num_workers", "1",
            "--checkpointing_steps", "2", "--pretrained_model_path",
            str(root / "init"), "--output_dir", str(out), *extra]


RECIPES = {
    "base": [],
    "lora": ["--use_lora", "--lora_rank", "4", "--lora_alpha", "4"],
    "ema": ["--ema_decay", "0.9"],
}


def _serve_argv(root: Path, *extra) -> list:
    return ["--model", str(root / "init"), "--device", "cpu", "--no_text_encoder",
            "--width", str(SIZE), "--height", str(SIZE), "--steps", "2",
            "--guidance_scale", "5.0", *extra]


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> Path:
    """The cache (24 items of 16x16x3, 3 batches an epoch) and the initial
    pipeline (6 heads, seeded weights, the zero heads drawn too)."""
    from f_lite_tpu_torch.data.precomputed import PrecomputedCacheWriter
    from f_lite_tpu_torch.models.dit import DiT
    from f_lite_tpu_torch.pipeline import FLitePipeline
    from f_lite_tpu_torch.train.trainer import build_config, parse_args

    root = tmp_path_factory.mktemp("tensor_parallel")
    writer = PrecomputedCacheWriter(root / "cache")
    rs = np.random.RandomState(5)
    for i in range(24):
        writer.add(f"{i}", f"a caption {i % 4}",
                   rs.uniform(-1, 1, (SIZE, SIZE, 3)).astype(np.float32),
                   rs.randn(5 + i % 3, 32).astype(np.float32))
    writer.finalize()
    argv = _base_argv(root, root / "unused")
    i = argv.index("--pretrained_model_path")
    cfg = build_config(parse_args(argv[:i] + argv[i + 2:]))
    assert cfg.num_heads == 6
    dit = DiT(cfg).init_weights(torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in dit.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.02)
    FLitePipeline(dit).save_pretrained(root / "init")
    (root / "prompts.txt").write_text("a red circle\na blue square\na white triangle\n")
    return root


def _one_rank(root: Path, name: str, *extra, fixed=False) -> tuple:
    """(every step's (loss, grad norm), the run's output dir) here, one
    rank (`fixed`: `_fixed`'s draws)."""
    from f_lite_tpu_torch.train import loss as loss_mod
    from f_lite_tpu_torch.train.trainer import parse_args, train

    out = root / "one" / name
    seen = []
    saved = loss_mod.draw_loss_inputs
    if fixed:
        loss_mod.draw_loss_inputs = _fixed_loss_draws
    try:
        train(parse_args(_base_argv(root, out, *extra)),
              on_step=lambda s, m: seen.append((float(m["loss"]), float(m["grad_norm"]))))
    finally:
        loss_mod.draw_loss_inputs = saved
    return seen, out


@pytest.fixture(scope="module")
def one_rank(root) -> dict:
    runs = {name: _one_rank(root, name, *extra) for name, extra in RECIPES.items()}
    runs["fixed"] = _one_rank(root, "fixed", fixed=True)
    return runs


def _job(root: Path, name: str, *extra, **kw) -> dict:
    return {"name": name, "argv": _base_argv(root, root / "runs" / name, *extra), **kw}


@pytest.fixture(scope="module")
def two_ranks(root, one_rank) -> dict:
    resume = root / "runs" / "resume_tp2"
    jobs = [{"name": "model2", "kind": "model"},
            _job(root, "tp2", "--tp", "2", fixed_draws=True),
            _job(root, "tp2_sp", "--tp", "2", "--sequence_parallel", fixed_draws=True),
            *(_job(root, f"tp2_{n}", "--tp", "2", *RECIPES[n])
              for n in ("base", "lora", "ema")),
            {"copy": (str(one_rank["base"][1] / "checkpoints" / "2"),
                      str(resume / "checkpoints" / "2"))},
            _job(root, "resume_tp2", "--tp", "2", "--resume_from_checkpoint", "latest"),
            {"name": "int8_tp2", "kind": "int8",
             "argv": _serve_argv(root, "--tp", "2", "--quantize", "--prompts", "x")},
            {"name": "http_dp2", "kind": "http",
             "argv": _serve_argv(root, "--dp", "2", "--http_port", "0",
                                 "--batch_window_ms", "3000")},
            {"name": "batch_dp2", "kind": "batch",
             "argv": _serve_argv(root, "--dp", "2", "--batch_size", "2", "--prompts",
                                 str(root / "prompts.txt"), "--output_dir",
                                 str(root / "runs" / "batch_dp2" / "png"))}]
    return _spawn(2, jobs, root / "two")


@pytest.fixture(scope="module")
def four_ranks(root) -> dict:
    jobs = [{"name": "model4", "kind": "model"},
            {"name": "model_dp2_tp2", "kind": "model", "dp": 2},
            _job(root, "dp2_tp2", "--dp", "2", "--tp", "2"),
            {**_job(root, "tp4_heads", "--tp", "4"), "kind": "error"}]
    return _spawn(4, jobs, root / "four")


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0, err_msg=what)


def _final_tensors(out: Path) -> dict:
    from f_lite_tpu_torch.train.checkpoint import Checkpointer

    ckpt = Checkpointer(out)
    _, tensors = ckpt.load(ckpt.latest)
    return {k: tensors[k] for k in tensors}


def _same_final_state(out_a: Path, out_b: Path) -> None:
    a, b = _final_tensors(out_a), _final_tensors(out_b)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(b[k].float().numpy(), a[k].float().numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# the DiT at tp 2 and 4 against one rank; the collective audit
# ---------------------------------------------------------------------------

def _near(got, want, what):
    """Within 1e-5 of the tensor's largest value."""
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale, err_msg=what)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_forward_and_gradients_match_one_rank(request, root, world, case):
    """tp, tp + sp (20 tokens), tp + sp where 13 tokens do not divide (the
    stream stays replicated) and tp + sp under remat; at tp 4 the 6 heads
    are padded to 8 and the padded heads' gradients are zero."""
    import dataclasses

    from f_lite_tpu_torch.convert.heads import unpad_head_state

    request.getfixturevalue({2: "two_ranks", 4: "four_ranks"}[world])
    cfg = _case_cfg(case, world)
    ref = _model(dataclasses.replace(cfg, padded_heads=None))
    want_out = _forward_backward(ref, MODEL_CASES[case][1]).numpy()
    got = np.load(root / {2: "two", 4: "four"}[world] / f"model{world}" / f"{case}.npz")
    _near(got["out"], want_out, "output")
    grads = {k[5:]: torch.from_numpy(got[k]) for k in got.files if k.startswith("grad/")}
    grads = unpad_head_state(grads, cfg)  # raises where a padded grad is not 0
    for name, p in ref.named_parameters():
        _near(grads[name].numpy(), p.grad.numpy(), name)


def _per_block(log):
    blocks, current = [], None
    for kind, ranks in log:
        if kind == "block":
            current = collections.Counter()
            blocks.append(current)
        elif current is not None:
            current[(kind, tuple(ranks))] += 1
    return blocks


@pytest.mark.parametrize("job,world", [("model2", 2), ("model_dp2_tp2", 4)])
def test_collective_audit(request, job, world):
    """Under TP: 3 all-reduces a cross-attention block (blocks 0 and 2), 2
    a self-only block (block 1); under SP a reduce-scatter and an
    all-gather in place of each, and one all-gather for the final layer;
    where 13 tokens do not divide, TP's. All on this rank's tp group."""
    runs = request.getfixturevalue({2: "two_ranks", 4: "four_ranks"}[world])[job]
    tp = 2
    for rank, seen in enumerate(runs):
        group = tuple(range(rank // tp * tp, rank // tp * tp + tp))
        for case, log in seen.items():
            blocks = _per_block(log)
            seq = _splits_sequence(case, tp)
            for i, counts in enumerate(blocks):
                n = 3 if i in (0, 2) else 2
                want = ({("all_gather", group): n, ("reduce_scatter", group): n} if seq
                        else {("all_reduce", group): n})
                if seq and i == 2:  # the final layer's gather follows block 2
                    want[("all_gather", group)] += 1
                assert dict(counts) == want, (rank, case, i, counts)
            assert len(blocks) == 3


# ---------------------------------------------------------------------------
# the trainer across ranks against one rank and against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,ranks,ref", [
    ("tp2", "two", "fixed"), ("tp2_sp", "two", "fixed"), ("tp2_base", "two", "base"),
    ("dp2_tp2", "four", "base")])
def test_tp_runs_match_one_rank(request, root, one_rank, name, ranks, ref):
    assert min(w[1] for w in one_rank["base"][0]) > 0.3  # every step clips
    runs = request.getfixturevalue(f"{ranks}_ranks")[name]
    want, out = one_rank[ref]
    assert len(want) == STEPS
    for rank, seen in enumerate(runs):
        _close(seen["losses"], [w[0] for w in want], f"{name} rank {rank} loss")
        _close(seen["grad_norms"], [w[1] for w in want], f"{name} rank {rank} norm")
    _same_final_state(out, root / "runs" / name)


def _jax_trainer_losses(argv, monkeypatch) -> list:
    """The JAX trainer on `argv` with `_fixed`'s draws injected (looked up
    by their step key), as `test_torch_parallel` injects them."""
    import jax
    import jax.numpy as jnp

    from f_lite_tpu.train import loss as jax_loss_mod
    from f_lite_tpu.train import trainer as jax_trainer

    steps = {}
    for s in range(2 * STEPS):
        k = jax.random.split(jax.random.fold_in(jax.random.key(0), s))[1]
        steps[np.asarray(jax.random.key_data(k)).tobytes()] = s
    original = jax_loss_mod.flow_matching_loss

    def injected(apply_fn, params, rng, latents, ctx, mask, **kw):
        def host(key_data):
            return _fixed(steps[np.asarray(key_data).tobytes()], latents.shape)

        t, n = jax.pure_callback(
            host, (jax.ShapeDtypeStruct(latents.shape[:1], jnp.float32),
                   jax.ShapeDtypeStruct(latents.shape, jnp.float32)),
            jax.random.key_data(rng))
        kw.update(uncond_prob=0.0, timesteps=t, noise=n)
        return original(apply_fn, params, rng, latents, ctx, mask, **kw)

    logged = []
    monkeypatch.setattr(jax_loss_mod, "flow_matching_loss", injected)
    monkeypatch.setattr(jax_trainer.MetricsLogger, "log",
                        lambda self, scalars, step: logged.append(scalars))
    jax_trainer.train(jax_trainer.parse_args(argv[2:]))
    return [float(x["train/loss"]) for x in logged if "train/loss" in x]


def test_tp_runs_match_the_jax_trainer(root, two_ranks, monkeypatch):
    """The JAX trainer at --tp 2 --sequence_parallel (a (1, 1, 4, 2) mesh
    of the 8 CPU devices) and the port at --tp 2, with and without
    --sequence_parallel, on the same cache, pipeline and injected draws:
    every step's loss within 1e-5 relative. (--scan_layers: the JAX
    trainer loads a pretrained pipeline restacked, ADVICE.md:3.)"""
    want = _jax_trainer_losses(
        _base_argv(root, root / "jax", "--checkpointing_steps", "0", "--scan_layers",
                   "--tp", "2", "--sequence_parallel"), monkeypatch)
    assert len(want) == STEPS
    for name in ("tp2", "tp2_sp"):
        for rank, seen in enumerate(two_ranks[name]):
            _close(seen["losses"], want, f"{name} rank {rank}")


@pytest.mark.parametrize("recipe", ["lora", "ema"])
def test_recipe_options_at_tp2_match_one_rank(root, one_rank, two_ranks, recipe):
    """--use_lora (the factors split like their weights: qkv's and
    context_kv's lora_b by heads) and --ema_decay at tp 2 against one rank;
    the saved factors and the EMA whole, in the reference layout. (Remat
    under tp is a model case above: this depth-3 recipe recomputes no
    block, `gradient_checkpoint_from` being 8.)"""
    want, out = one_rank[recipe]
    for rank, seen in enumerate(two_ranks[f"tp2_{recipe}"]):
        _close(seen["losses"], [w[0] for w in want], f"{recipe} rank {rank} loss")
        _close(seen["grad_norms"], [w[1] for w in want], f"{recipe} rank {rank} norm")
    _same_final_state(out, root / "runs" / f"tp2_{recipe}")
    final = Path("checkpoints") / str(STEPS)
    if recipe == "ema":
        from f_lite_tpu_torch.train.checkpoint import read_entry

        a = read_entry(out / final / "ema")[1]
        b = read_entry(root / "runs" / "tp2_ema" / final / "ema")[1]
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), rtol=0, atol=1e-5)
    if recipe == "lora":
        from f_lite_tpu_torch.utils.safetensors import load_file

        name = final / "lora_weights.safetensors"
        a, b = load_file(out / name), load_file(root / "runs" / "tp2_lora" / name)
        # self qkv, proj x 3 blocks; cross q, context_kv, proj x 2; 2 factors
        assert set(a) == set(b) and len(a) == 24
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("direction", ["tp2_to_tp1", "tp1_to_tp2"])
def test_checkpoints_resume_across_tp(root, one_rank, two_ranks, direction):
    """tp 2's step-2 checkpoint resumed at one rank, and one rank's resumed
    at tp 2, give the straight one-rank run's step 3 and final state."""
    straight, out = one_rank["base"]
    if direction == "tp1_to_tp2":
        for seen in two_ranks["resume_tp2"]:
            _close(seen["losses"], [w[0] for w in straight[2:]], "tp 2 resumed")
        _same_final_state(out, root / "runs" / "resume_tp2")
        return
    from f_lite_tpu_torch.train.trainer import parse_args, train

    resumed = root / "resume_tp1"
    shutil.copytree(root / "runs" / "tp2_base" / "checkpoints" / "2",
                    resumed / "checkpoints" / "2")
    losses = []
    train(parse_args(_base_argv(root, resumed, "--resume_from_checkpoint", "latest")),
          on_step=lambda s, m: losses.append(float(m["loss"])))
    _close(losses, [w[0] for w in straight[2:]], "tp 1 resumed")
    _same_final_state(out, resumed)


# ---------------------------------------------------------------------------
# the error cases
# ---------------------------------------------------------------------------

def test_tp_that_does_not_divide_the_heads_raises_as_the_jax_trainer(root, four_ranks):
    """--tp 4 over 6 heads: the JAX trainer's device_put raises ValueError
    (its qkv kernel's head axis does not divide), and the port's
    parallelize_dit raises ValueError on every rank; neither pads."""
    from f_lite_tpu.train import trainer as jax_trainer

    argv = _base_argv(root, root / "jax_tp4", "--scan_layers", "--tp", "4")
    with pytest.raises(ValueError, match="divisible by 4"):
        jax_trainer.train(jax_trainer.parse_args(argv[2:]))
    for seen in four_ranks["tp4_heads"]:
        assert seen["error"] == "ValueError"
        assert "tp 4 does not divide the DiT's 6 attention heads" in seen["message"]


def test_sequence_parallel_needs_tp_as_in_jax(root):
    from f_lite_tpu.train import trainer as jax_trainer
    from f_lite_tpu_torch.train.trainer import parse_args, train

    argv = _base_argv(root, root / "sp1", "--sequence_parallel")
    with pytest.raises(ValueError, match=r"--sequence_parallel requires --tp > 1"):
        jax_trainer.train(jax_trainer.parse_args(argv[2:] + ["--scan_layers"]))
    with pytest.raises(ValueError, match=r"^--sequence_parallel requires --tp > 1$"):
        train(parse_args(argv))


@pytest.mark.parametrize("case", ["train", "train_node", "serve"])
def test_mesh_that_does_not_fill_the_world(root, monkeypatch, case):
    from f_lite_tpu_torch import serve
    from f_lite_tpu_torch.train.trainer import parse_args, train

    env = dict(WORLD_SIZE="4", RANK="0", LOCAL_RANK="0", LOCAL_WORLD_SIZE="4",
               MASTER_ADDR="127.0.0.1", MASTER_PORT="1")
    if case == "train_node":  # a tp group across two nodes of 2
        env["LOCAL_WORLD_SIZE"] = "2"
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if case == "train":
        with pytest.raises(SystemExit, match=r"dp=1 x fsdp=1 x tp=2 = 2 != 4 ranks"):
            train(parse_args(_base_argv(root, root / "e", "--tp", "2")))
    elif case == "train_node":
        with pytest.raises(SystemExit, match="a tp group lies inside one node"):
            train(parse_args(_base_argv(root, root / "e", "--tp", "4", "--fsdp", "0")))
    else:
        with pytest.raises(SystemExit, match="torchrun started 4"):
            serve.build_pipeline(serve.parse_args(_serve_argv(root, "--tp", "2",
                                                              "--http_port", "0")))


# ---------------------------------------------------------------------------
# head padding at load; int8 under tp
# ---------------------------------------------------------------------------

def test_pad_heads_matches_no_padding_and_the_jax_pipeline(root):
    """from_pretrained(pad_heads_to=8): the final latents within 1e-6
    relative of no padding, and MSE < 1e-9 against the JAX pipeline's
    pad_heads_to=8 (fp32, the same latents)."""
    import jax.numpy as jnp

    from f_lite_tpu.pipeline import FLitePipeline as JaxPipeline
    from f_lite_tpu_torch.pipeline import FLitePipeline

    def port(pad):
        pipe = FLitePipeline.from_pretrained(root / "init", dtype=torch.float32,
                                             device="cpu", pad_heads_to=pad)
        assert pipe.dit.config.compute_heads == (pad or 6)
        return _latents_of(pipe)

    padded, plain = port(8), port(None)
    scale = float(np.abs(plain).max())
    np.testing.assert_allclose(padded, plain, rtol=0, atol=1e-6 * scale)
    jpipe = JaxPipeline.from_pretrained(root / "init", dtype=jnp.float32,
                                        load_text_encoder=False, pad_heads_to=8)
    rs = np.random.RandomState(7)
    emb = rs.randn(2, 6, 32).astype(np.float32)
    mask = np.arange(6)[None] < np.array([[6], [3]])
    want = np.asarray(jpipe(prompt_embeds=emb, context_mask=mask,
                            latents=jnp.asarray(rs.randn(2, SIZE, SIZE, 3).astype(np.float32)),
                            num_inference_steps=3, guidance_scale=5.0,
                            output_type="latent").images)
    mse = float(((padded - want) ** 2).mean())
    assert mse < 1e-9, mse


def test_save_pretrained_of_a_padded_pipeline_writes_the_unpadded_files(root, tmp_path):
    from f_lite_tpu_torch.pipeline import FLitePipeline

    for pad in (None, 8):
        FLitePipeline.from_pretrained(root / "init", dtype=torch.float32, device="cpu",
                                      pad_heads_to=pad).save_pretrained(tmp_path / str(pad))
    for f in ("dit/config.json", "dit/flax_params.safetensors", "model_index.json"):
        assert (tmp_path / "8" / f).read_bytes() == (tmp_path / "None" / f).read_bytes(), f
    assert (tmp_path / "8" / "dit" / "flax_params.safetensors").read_bytes() == \
        (root / "init" / "dit" / "flax_params.safetensors").read_bytes()


def test_int8_at_tp2_is_within_the_int8_noise_of_one_rank(root, two_ranks):
    """The row-parallel layers quantize each row with the amax of the whole
    K (taken over the ranks), so the int8 DiT at tp 2 differs from one
    rank's only by the partial sums' fp32 order: by under 1e-3 of one
    rank's int8 noise (its MSE against fp32) in one forward; and serve
    --tp 2 --quantize (bf16) gives final latents within that noise of one
    rank's."""
    from f_lite_tpu_torch import serve
    from f_lite_tpu_torch.quant import quantize_dit

    with torch.no_grad():
        f32 = _model(_cfg())(*_inputs(8)).numpy()
        i8 = quantize_dit(_model(_cfg()))(*_inputs(8)).numpy()
    got = np.load(root / "two" / "model2" / "int8.npy")
    noise = float(((i8 - f32) ** 2).mean())
    assert 0 < noise and float(((got - i8) ** 2).mean()) < 1e-3 * noise
    got = np.load(root / "two" / "int8_tp2" / "latents.npy")
    one = {q: _latents_of(serve.build_pipeline(serve.parse_args(_serve_argv(
        root, "--prompts", "x", *(["--quantize"] if q else []))))) for q in (False, True)}
    noise = float(((one[True] - one[False]) ** 2).mean())
    gap = float(((got - one[True]) ** 2).mean())
    assert 0 < noise and gap < noise, (gap, noise)


def test_given_amax_quantize_equals_the_fused_one_fed_its_own_amax():
    from f_lite_tpu_torch.ops.cuda import int8_gemm

    rs = np.random.RandomState(2)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rs.randn(37, 96).astype(np.float32)).to(dtype)
        x[3] = 0  # an all-zero row: sx 1
        amax = int8_gemm.row_amax(x)
        assert torch.equal(amax, x.float().abs().amax(-1))
        for got, want in zip(int8_gemm.quantize_rows_given(x, amax),
                             int8_gemm.quantize_rows(x)):
            assert torch.equal(got, want)
        # a larger given amax (another rank's share of the row) coarsens sx
        x8, sx = int8_gemm.quantize_rows_given(x, amax * 2)
        assert torch.equal(sx[amax > 0], (amax * 2 / torch.full_like(amax, 127.0))[amax > 0])


# ---------------------------------------------------------------------------
# serving across ranks
# ---------------------------------------------------------------------------

def test_dp2_http_rows_are_bit_equal_to_their_solo_requests(root, two_ranks):
    """Two requests posted together to a dp 2 server share one dispatch
    (X-F-Lite-Batch 2) and answer the PNGs a one-rank server gives each
    alone; /healthz reports dp 2 and tp 1; an image input gets JAX's 400;
    SIGTERM to rank 0 drains it, and the follower leaves its loop."""
    from f_lite_tpu_torch import serve

    rank0, rank1 = two_ranks["http_dp2"]
    assert rank0["returned"] and rank1["returned"]
    assert rank0["healthz"]["dp"] == 2 and rank0["healthz"]["tp"] == 1
    status, body = rank0["image"]
    assert status == 400 and "not supported with --dp request batching" in body["error"]
    args = serve.parse_args(_serve_argv(root, "--http_port", "0"))
    server = serve.make_http_server(serve.build_pipeline(args), args, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        for req, (status, batch, png) in zip(HTTP_REQUESTS, rank0["answers"]):
            assert status == 200 and batch == "2"
            s, headers, want = _post(server.server_address[1], req)
            assert s == 200 and "X-F-Lite-Batch" not in headers
            assert base64.b64decode(png) == want
    finally:
        server.shutdown()
        server.server_close()


def test_dp2_batch_mode_writes_the_one_rank_pngs(root, two_ranks, tmp_path):
    from f_lite_tpu_torch import serve

    serve.main(_serve_argv(root, "--batch_size", "2", "--prompts", str(root / "prompts.txt"),
                           "--output_dir", str(tmp_path)))
    got_dir = root / "runs" / "batch_dp2" / "png"
    names = sorted(p.name for p in tmp_path.glob("*.png"))
    assert names == ["00000.png", "00001.png", "00002.png"]
    assert sorted(p.name for p in got_dir.glob("*.png")) == names
    for n in names:
        assert (got_dir / n).read_bytes() == (tmp_path / n).read_bytes(), n
    manifest = json.loads((got_dir / "manifest.json").read_text())
    assert [e["file"] for e in manifest["images"]] == [str(got_dir / n) for n in names]


def test_batch_size_that_dp_does_not_divide_exits_as_jax(root):
    from f_lite_tpu import serve as jserve
    from f_lite_tpu_torch import serve

    argv = _serve_argv(root, "--dp", "2", "--batch_size", "3", "--prompts",
                       str(root / "prompts.txt"))
    with pytest.raises(SystemExit) as want:  # JAX's serve has no --device
        jserve.main([a for a in argv if a not in ("--device", "cpu")])
    with pytest.raises(SystemExit) as got:
        serve.main(argv)
    assert str(got.value) == str(want.value) and "must be divisible by --dp 2" in str(got.value)
