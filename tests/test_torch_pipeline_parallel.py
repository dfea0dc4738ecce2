"""Pipeline parallelism (`parallel/pipeline.py`, the trainer's `--pp`,
`--pp_microbatches` and `--scan_layers`) on the CPU, with gloo. Multi-rank
jobs run in one spawn a world size (2 and 4 processes started here as
`torchrun` starts them, with `tests/test_torch_parallel.py`'s helpers), at
tiny configs in fp32; the one-rank references and the JAX package run in
this process (JAX on its own 8-device CPU mesh).

- the DiT split into stages, forward and every gradient against one rank
  (within 1e-5 of each tensor's largest value): v1 (shared AdaLN, a
  periodic `blocks_rest` of 2 units behind 2 front blocks, remat from
  block 1) and v2 (per-block AdaLN, cross-attention everywhere, "dots"
  remat from block 2), both with residual_v and `train_bias_and_rms`, at
  pp 2 and pp 4; an off-recipe batch of 3 at 2 microbatches degrades with
  JAX's warning; the 2-stage forward within MSE 1e-9 of JAX's
  `PipelineTrunk`; the scan <-> pipeline layout reshapes equal JAX's;
- the trainer at `--pp 2 --pp_microbatches 2 --scan_layers` against one
  rank, and (v2 at depth 2) against the JAX trainer on the same flags and
  injected draws (losses within 1e-5 relative), and at pp 4, pp 2 x tp 2 with sequence
  parallelism, pp 2 x fsdp 2 and pp 2 x dp 2 against one rank (losses and
  norms within 1e-5 relative, the final state within 1e-5 of each
  tensor's largest value); accumulation with rampup and EMA; aspect
  buckets (the stream's length changes between steps) with a sample grid
  whose CFG batch of 6 degrades from 4 microbatches; validation on the
  online path, its batches of 3 degraded from 2 microbatches; the
  empty-region v1 (depth <= first_n: every stage runs the whole model);
- checkpoints: pp 2 -> 1 and 1 -> 2 resume the straight run;
- the export under `--scan_layers`: bit-equal to JAX's `to_scan_layout` of
  the unrolled export, `scan_layers: true` and `pipeline_stages: 1`, and
  loaded by both packages;
- JAX's five rejections, with JAX's messages.
"""

import json
import logging
import multiprocessing
import os
import shutil
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_parallel import _fixed_loss_draws, _free_port, _record

STEPS = 3
TIMEOUT_S = 240
SIZE = 16  # the trainer's images: 64 patches + 16 registers
PP = ["--pp", "2", "--pp_microbatches", "2", "--scan_layers"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the DiT in stages
# ---------------------------------------------------------------------------

def _cfg(**kw):
    from f_lite_tpu_torch.models.dit import DiTConfig

    base = dict(in_channels=4, patch_size=2, hidden_size=64, num_heads=4,
                cross_attn_input_size=24, residual_v=True, train_bias_and_rms=True,
                dynamic_softmax_temperature=True, n_register_tokens=4)
    base.update(kw)
    return DiTConfig(**base)


MODEL_CASES = {
    "v1": dict(depth=6, cross_attn_first_n=2, cross_attn_period=2,
               gradient_checkpoint=True, gradient_checkpoint_from=1),
    "v2": dict(depth=4, cross_attn_all=True, adaln_mode="per_block",
               gradient_checkpoint=True, gradient_checkpoint_from=2, remat_policy="dots"),
}


def _model(cfg):
    """A seeded DiT of `cfg` with every weight non-zero."""
    from f_lite_tpu_torch.models.dit import DiT

    m = DiT(cfg).init_weights(torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    return m


def _inputs(b=4):
    g = torch.Generator().manual_seed(3)
    lens = torch.tensor([3, 5, 1, 4])[:b]
    return (torch.randn(b, 8, 8, 4, generator=g), torch.randn(b, 5, 24, generator=g),
            torch.arange(5)[None] < lens[:, None], torch.rand(b, generator=g))


def _weights(shape):
    return torch.linspace(-1, 1, int(np.prod(shape))).reshape(shape)


def _model_job(job_dir: Path, rank: int, world: int, job: dict) -> None:
    """Each model case at pp = world: the forward (every rank), every
    stage's gradients (each rank its own) and the off-recipe batch."""
    from f_lite_tpu_torch.parallel.mesh import create_mesh, stage_of
    from f_lite_tpu_torch.parallel.pipeline import PipelinedDiT, build_stage, stage_blocks

    mesh = create_mesh(1, 1, 1, world, device_type="cpu")
    stage, n = stage_of(mesh)
    warned = []
    handler = logging.Handler()
    handler.emit = lambda record: warned.append(record.getMessage())
    logging.getLogger("f_lite_tpu_torch.parallel.pipeline").addHandler(handler)
    for name in job["cases"]:
        cfg = _cfg(**MODEL_CASES[name])
        whole = _model(cfg).state_dict()
        m = build_stage(cfg, stage, n, stage_blocks(cfg, n)[stage], "cpu")
        m.load_state_dict({k: whole[k] for k in m.state_dict()}, strict=True)
        net = PipelinedDiT(m, mesh["pp"].get_group(), 2, "cpu")
        out = net(*_inputs())
        off = net(*_inputs(3))
        net.train_microbatches(*_inputs(), _weights(out.shape).reshape(4, -1),
                               lambda pred, w: (pred * w.reshape(pred.shape)).sum())
        np.savez(job_dir / f"{name}_rank{rank}.npz", out=out.numpy(), off=off.numpy(),
                 **{f"grad/{k}": p.grad.numpy() for k, p in m.named_parameters()})
    (job_dir / f"rank{rank}.json").write_text(json.dumps({"warned": warned}))


def _pp_worker(rank: int, world: int, port: int, jobs: list, out: str) -> None:
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
            if job.get("kind") == "model":
                _model_job(job_dir, rank, world, job)
            else:
                _record(job_dir, rank, job)
            dist.barrier()
    except BaseException:
        (Path(out) / f"error_rank{rank}.txt").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _start(world: int, jobs: list, out: Path) -> list:
    """`jobs` on `world` spawned ranks, started."""
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_pp_worker, args=(r, world, port, jobs, str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _finish(procs: list, jobs: list, out: Path) -> dict:
    """Wait for `_start`'s ranks: {job name: [each rank's record]}."""
    for p in procs:
        p.join(TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    errors = "".join(f.read_text() for f in sorted(out.glob("error_*.txt")))
    assert not alive and all(p.exitcode == 0 for p in procs), (
        f"exit codes {[p.exitcode for p in procs]}, timed out {len(alive)}\n{errors}")
    return {job["name"]: [json.loads((out / job["name"] / f"rank{r}.json").read_text())
                          for r in range(len(procs))]
            for job in jobs if "name" in job}


def _jax_job(argv: list, out: str) -> None:
    """The JAX trainer on `argv` with `_fixed`'s draws injected, in a
    process of its own (with the CPU platform, the precision and the
    compile cache of tests/conftest.py): its losses in `out`."""
    try:
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_default_matmul_precision", "highest")
        if os.environ.get("F_LITE_TEST_COMPILE_CACHE", "1") != "0":
            cache = (os.environ.get("F_LITE_TEST_COMPILE_CACHE_DIR")
                     or str(Path.home() / ".cache" / "f_lite_tpu" / "xla_tests"))
            Path(cache).mkdir(parents=True, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", cache)
            jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
        from test_torch_tensor_parallel import _jax_trainer_losses

        with pytest.MonkeyPatch.context() as mp:
            Path(out).write_text(json.dumps(_jax_trainer_losses(argv, mp)))
    except BaseException:
        Path(out).with_name("error_jax.txt").write_text(traceback.format_exc())
        raise


# ---------------------------------------------------------------------------
# the trainer's recipes
# ---------------------------------------------------------------------------

def _base_argv(root: Path, out: Path, *extra, init="init", cache="cache") -> list:
    """v1 at depth 6 (front blocks 0-1, a periodic region of 2 units of 2
    blocks), 4 heads of 16, residual_v, train_bias_and_rms; 8 rows a step."""
    argv = ["--device", "cpu", "--use_precomputed_data",
            "--precomputed_data_dir", str(root / cache), "--pixel_space",
            "--model_width", "64", "--model_depth", "6", "--model_head_dim", "16",
            "--cross_attn_input_size", "32", "--residual_v", "--train_bias_and_rms",
            "--cross_attn_period", "2", "--cross_attn_first_n", "2",
            "--train_batch_size", "8", "--num_epochs", "3",
            "--max_steps", str(STEPS), "--learning_rate", "1e-3",
            "--lr_scheduler", "constant", "--num_warmup_steps", "1",
            "--max_grad_norm", "0.3", "--resolution", str(SIZE),
            "--log_every", "1", "--seed", "0", "--report_to", "none",
            "--sample_every", "0", "--eval_every", "0", "--num_workers", "1",
            "--checkpointing_steps", "2", "--output_dir", str(out)]
    if init:
        argv += ["--pretrained_model_path", str(root / init)]
    return argv + list(extra)


V2 = ["--cross_attn_all", "--adaln_mode", "per_block", "--model_depth", "4"]
# v2 at depth 2: what the JAX trainer runs too (its pipelined step compiles
# twice, in about 10 s each at this depth)
V2_D2 = [*V2[:-1], "2"]
# each: (options of both runs, the init pipeline, the cache)
RECIPES = {
    "base": ([], "init", "cache"),
    "fixed": (V2_D2, "init_v2_d2", "cache"),
    # two latent shapes (the stream's length changes) and a sample grid of
    # 3 prompts: a CFG batch of 6 that 4 microbatches do not divide
    "buckets": (["--use_resolution_buckets", "--sample_every", str(STEPS), "--debug"],
                "init", "buckets_cache"),
    # seed 1: the rampup weights of steps 1-2 fall unevenly over microbatches
    "recipe": (["--bs_rampup", "4", "--gradient_accumulation_steps", "2", "--seed", "1",
                "--ema_decay", "0.9"], "init", "cache"),
    # depth 6 <= first_n 8: no periodic region
    "empty_v1": (["--cross_attn_first_n", "8"], None, "cache"),
    # the online path with validation batches of 3 (the model degrades them
    # from 2 microbatches to 1)
    "eval": (["--eval_every", str(STEPS), "--eval_batch_size", "3"], "init", None),
    "v2": (V2, "init_v2", "cache"),
}


def _write_init(root: Path, name: str, *extra) -> None:
    from f_lite_tpu_torch.models.dit import DiT
    from f_lite_tpu_torch.pipeline import FLitePipeline
    from f_lite_tpu_torch.train.trainer import build_config, parse_args

    cfg = build_config(parse_args(_base_argv(root, root / "unused", *extra, init=None)))
    dit = DiT(cfg).init_weights(torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in dit.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.02)
    FLitePipeline(dit).save_pretrained(root / name)


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> Path:
    """The caches (24 items of 16x16x3; the bucket cache 16 of those and 8
    of 12x12x3), PNG tables (16 rows, and 6 to validate on), the initial
    pipelines (v1 and v2, seeded, the zero heads drawn too) and the sample
    prompts (cached captions)."""
    from f_lite_tpu_torch.data.precomputed import PrecomputedCacheWriter
    from f_lite_tpu_torch.utils.image import png_bytes_with_metadata

    root = tmp_path_factory.mktemp("pipeline_parallel")
    rs = np.random.RandomState(5)
    for name, sizes in (("cache", [SIZE] * 24), ("buckets_cache", [SIZE] * 16 + [12] * 8)):
        writer = PrecomputedCacheWriter(root / name)
        for i, size in enumerate(sizes):
            writer.add(f"{i}", f"a caption {i % 4}",
                       rs.uniform(-1, 1, (size, size, 3)).astype(np.float32),
                       rs.randn(5 + i % 3, 32).astype(np.float32))
        writer.finalize()
    for name, n in (("pngs", 16), ("pngs_val", 6)):
        (root / name).mkdir()
        rows = []
        for i in range(n):
            f = root / name / f"{i}.png"
            f.write_bytes(png_bytes_with_metadata(
                rs.randint(0, 256, (SIZE, SIZE, 3)).astype(np.uint8)))
            rows.append({"media_path": str(f), "captions": [f"c{i}"], "width": SIZE,
                         "height": SIZE})
        (root / name / "table.json").write_text(json.dumps(rows))
    _write_init(root, "init")
    _write_init(root, "init_v2", *V2)
    _write_init(root, "init_v2_d2", *V2_D2)
    (root / "prompts.txt").write_text("a caption 0\na caption 1\na caption 2\n")
    return root


def _recipe_argv(root: Path, out: Path, name: str, *extra) -> list:
    options, init, cache = RECIPES[name]
    argv = _base_argv(root, out, *options, *extra, init=init, cache=cache or "cache")
    if name == "buckets":
        argv += ["--sample_prompts_file", str(root / "prompts.txt")]
    if cache is None:  # the online path: PNG tables, a validation one
        i = argv.index("--use_precomputed_data")
        del argv[i:i + 3]
        argv += ["--train_data_path", str(root / "pngs" / "table.json"),
                 "--val_data_path", str(root / "pngs_val" / "table.json"),
                 "--root_dir_type", "json", "--base_url", "file://", "--center_crop"]
    return argv


def _one_rank(root: Path, name: str) -> tuple:
    """(every step's (loss, grad norm), the run's output dir) here, one
    rank (`fixed`: `_fixed`'s draws)."""
    from f_lite_tpu_torch.train import loss as loss_mod
    from f_lite_tpu_torch.train.trainer import parse_args, train

    out = root / "one" / name
    seen = []
    saved = loss_mod.draw_loss_inputs
    if name == "fixed":
        loss_mod.draw_loss_inputs = _fixed_loss_draws
    try:
        train(parse_args(_recipe_argv(root, out, name)),
              on_step=lambda s, m: seen.append((float(m["loss"]), float(m["grad_norm"]))))
    finally:
        loss_mod.draw_loss_inputs = saved
    return seen, out


def _job(root: Path, name: str, recipe: str, *extra, **kw) -> dict:
    return {"name": name, "argv": _recipe_argv(root, root / "runs" / name, recipe, *extra),
            **kw}


@pytest.fixture(scope="module")
def started(root):
    """The JAX trainer, then the 2-rank and the 4-rank jobs, each in
    processes of their own, started (the one-rank straight run first: 2
    ranks resume its checkpoint); killed at the end of the module."""
    jax_out = root / "jax" / "losses.json"
    jax_out.parent.mkdir(parents=True)
    jax_argv = _recipe_argv(root, root / "jax", "fixed", *PP, "--checkpointing_steps", "0")
    jax_proc = multiprocessing.get_context("spawn").Process(
        target=_jax_job, args=(jax_argv, str(jax_out)))
    procs = {"jax": [jax_proc]}
    jax_proc.start()
    try:
        one = {"base": _one_rank(root, "base")}
        resume = root / "runs" / "resume_pp2"
        jobs = {
            "two": [{"name": "model2", "kind": "model", "cases": list(MODEL_CASES)},
                    _job(root, "pp2_fixed", "fixed", *PP, fixed_draws=True),
                    _job(root, "pp2", "base", *PP, "--export_pipeline"),
                    _job(root, "pp2_buckets", "buckets", "--pp", "2",
                         "--pp_microbatches", "4", "--scan_layers"),
                    _job(root, "pp2_recipe", "recipe", *PP),
                    _job(root, "pp2_empty_v1", "empty_v1", *PP),
                    _job(root, "pp2_eval", "eval", *PP),
                    {"copy": (str(one["base"][1] / "checkpoints" / "2"),
                              str(resume / "checkpoints" / "2"))},
                    _job(root, "resume_pp2", "base", *PP, "--resume_from_checkpoint",
                         "latest")],
            "four": [{"name": "model4", "kind": "model", "cases": ["v2"]},
                     _job(root, "pp4", "v2", "--pp", "4", "--pp_microbatches", "2",
                          "--scan_layers"),
                     _job(root, "pp2_tp2_sp", "base", *PP, "--tp", "2",
                          "--sequence_parallel"),
                     _job(root, "pp2_fsdp2", "base", *PP, "--fsdp", "2"),
                     _job(root, "pp2_dp2", "base", *PP, "--dp", "2")]}
        procs["two"] = _start(2, jobs["two"], root / "two")
        procs["four"] = _start(4, jobs["four"], root / "four")
        yield {"one": one, "procs": procs, "jobs": jobs, "jax_out": jax_out}
    finally:
        for p in [q for group in procs.values() for q in group]:
            if p.is_alive():
                p.kill()
                p.join()


@pytest.fixture(scope="module")
def runs(root, started) -> dict:
    """The one-rank references here while the other processes run, then
    every record."""
    one = started["one"]
    for name in RECIPES:
        if name not in one:
            one[name] = _one_rank(root, name)
    procs, jobs = started["procs"], started["jobs"]
    out = {"one": one, **{k: _finish(procs[k], jobs[k], root / k) for k in jobs}}
    _finish(procs["jax"], [], root / "jax")
    out["jax"] = json.loads(started["jax_out"].read_text())
    return out


@pytest.fixture(scope="module")
def one_rank(runs) -> dict:
    return runs["one"]


@pytest.fixture(scope="module")
def two_ranks(runs) -> dict:
    return runs["two"]


@pytest.fixture(scope="module")
def four_ranks(runs) -> dict:
    return runs["four"]


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0, err_msg=what)


def _near(got, want, what):
    """Within 1e-5 of the tensor's largest value."""
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale, err_msg=what)


def _final_tensors(out: Path) -> dict:
    from f_lite_tpu_torch.train.checkpoint import Checkpointer

    ckpt = Checkpointer(out)
    _, tensors = ckpt.load(ckpt.latest)
    return {k: tensors[k].float().numpy() for k in tensors}


def _same_final_state(out_a: Path, out_b: Path) -> None:
    """The parameters within 1e-5 of each one's largest value; the
    optimizer's moments and accumulator within 1e-5, as the repo's other
    runs across ranks hold them (an accumulated gradient is a sum over
    microbatches: a 1-element one of lambda_v cancels to 1.8e-6 and
    differs from one rank's by 1.6e-5 of itself)."""
    a, b = _final_tensors(out_a), _final_tensors(out_b)
    assert set(a) == set(b)
    for k in a:
        if k.startswith("opt."):
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-5, err_msg=k)
        else:
            _near(b[k], a[k], k)


# ---------------------------------------------------------------------------
# JAX's rejections
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra,match", [
    (["--use_lora", "--scan_layers"], "--use_lora is incompatible with --scan_layers"),
    (["--pp", "2"], r"--pp > 1 requires --scan_layers"),
    (["--pp", "2", "--scan_layers", "--sequence_dropout", "0.5"],
     r"--pp > 1 is incompatible with --sequence_dropout"),
    (["--pp_microbatches", "2"], r"--pp_microbatches > 1 has no effect without --pp > 1"),
    (["--pp", "2", "--pp_microbatches", "3", "--scan_layers"],
     r"global batch 8 \(= train_batch_size x batch_multiplicity x process_count\) "
     r"must be divisible by --pp_microbatches 3"),
])
def test_jax_rejections(root, started, extra, match):
    """The JAX trainer's five checks raise SystemExit in both trainers with
    one message (while the multi-rank processes run)."""
    from f_lite_tpu.train import trainer as jax_trainer
    from f_lite_tpu_torch.train.trainer import parse_args, train

    argv = _base_argv(root, root / "rejected", *extra)
    with pytest.raises(SystemExit, match=match) as want:
        jax_trainer.train(jax_trainer.parse_args(argv[2:]))
    with pytest.raises(SystemExit) as got:
        train(parse_args(argv))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the DiT in stages against one rank and against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,case", [(2, "v1"), (2, "v2"), (4, "v2")])
def test_stages_match_one_rank(request, root, world, case):
    """The forward on every rank, and every parameter's gradient from the
    stage that holds it (each exactly once), against one rank; the
    off-recipe batch of 3 against one rank's 3 rows, with JAX's warning."""
    runs = request.getfixturevalue({2: "two_ranks", 4: "four_ranks"}[world])
    ref = _model(_cfg(**MODEL_CASES[case]))
    with torch.no_grad():
        want_off = ref(*_inputs(3)).numpy()
    want = ref(*_inputs())
    (want * _weights(want.shape)).sum().backward()
    job = root / {2: "two", 4: "four"}[world] / f"model{world}"
    grads = {}
    for rank in range(world):
        got = np.load(job / f"{case}_rank{rank}.npz")
        _near(got["out"], want.detach().numpy(), f"rank {rank} output")
        _near(got["off"], want_off, f"rank {rank} off-recipe output")
        for k in got.files:
            if k.startswith("grad/"):
                assert k[5:] not in grads, k
                grads[k[5:]] = got[k]
    assert set(grads) == {n for n, _ in ref.named_parameters()}
    for name, p in ref.named_parameters():
        _near(grads[name], p.grad.numpy(), name)
    for seen in runs[f"model{world}"]:
        assert any("batch 3 not divisible by pipeline_microbatches=2 — degrading this "
                   "program to 1 microbatch(es)" in w for w in seen["warned"])


def test_two_stage_forward_matches_jax_pipeline_trunk(root, two_ranks):
    """The same v2 weights in JAX's pipeline layout through `DiT` at
    pipeline_stages 2 and 2 microbatches on a 2-device pp mesh: the port's
    2-stage forward within MSE 1e-9."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from f_lite_tpu.convert.torch_to_jax import to_scan_layout
    from f_lite_tpu.models.dit import DiT as JaxDiT
    from f_lite_tpu.models.dit import DiTConfig as JaxDiTConfig
    from f_lite_tpu.parallel import create_mesh, scan_to_pipeline_params
    from f_lite_tpu.parallel.mesh import mesh_rules
    from f_lite_tpu_torch.convert.from_jax import unflatten
    from f_lite_tpu_torch.convert.to_jax import state_dict_to_jax

    cfg = _cfg(**MODEL_CASES["v2"])
    fields = {f.name for f in dataclasses.fields(JaxDiTConfig)}
    jcfg = JaxDiTConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                           if k in fields and k != "dtype"},
                        scan_layers=True, pipeline_stages=2, pipeline_microbatches=2,
                        use_pallas_attention=False)
    flat = {k: v.numpy() for k, v in state_dict_to_jax(_model(cfg).state_dict(), cfg).items()}
    params = scan_to_pipeline_params({"params": to_scan_layout(unflatten(flat), jcfg)}, 2)
    mesh = create_mesh(dp=1, fsdp=1, tp=1, pp=2, devices=jax.devices()[:2])
    with mesh_rules(mesh):
        want = np.asarray(jax.jit(JaxDiT(jcfg).apply)(
            params, *(jnp.asarray(a.numpy()) for a in _inputs())))
    got = np.load(root / "two" / "model2" / "v2_rank0.npz")["out"]
    assert np.abs(want).max() > 1e-2
    assert float(((got - want) ** 2).mean()) < 1e-9


@pytest.mark.parametrize("case,pp", [("v1", 2), ("v2", 2), ("v2", 4)])
def test_layout_reshapes_match_jax(case, pp):
    """`scan_to_pipeline_params` / `pipeline_to_scan_params` on the port's
    scan tree (`to_scan_layout` of a seeded DiT) equal the JAX package's,
    leaf for leaf, and the round trip is lossless; `pp` must divide the
    units."""
    from f_lite_tpu.parallel import pipeline as jax_pipeline
    from f_lite_tpu_torch.convert.from_jax import unflatten
    from f_lite_tpu_torch.convert.to_jax import state_dict_to_jax, to_scan_layout
    from f_lite_tpu_torch.parallel import pipeline

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            key = f"{prefix}.{k}" if prefix else k
            out.update(flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
        return out

    cfg = _cfg(**MODEL_CASES[case])
    scan = {k: v.numpy() for k, v in to_scan_layout(
        state_dict_to_jax(_model(cfg).state_dict(), cfg), cfg).items()}
    tree = {"params": unflatten(scan)}
    got = pipeline.scan_to_pipeline_params(tree, pp)
    want = flat(jax_pipeline.scan_to_pipeline_params(tree, pp))
    assert set(flat(got)) == set(want)
    for k, v in flat(got).items():
        assert np.array_equal(v, want[k]), k
    back = flat(pipeline.pipeline_to_scan_params(got))
    assert set(back) == set(flat(tree)) and all(
        np.array_equal(v, flat(tree)[k]) for k, v in back.items())
    with pytest.raises(ValueError, match="not divisible by pipeline_stages=3"):
        pipeline.scan_to_pipeline_params(tree, 3)


# ---------------------------------------------------------------------------
# the trainer across stages against one rank and against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,ranks,ref", [
    ("pp2_fixed", "two", "fixed"), ("pp2", "two", "base"),
    ("pp2_buckets", "two", "buckets"), ("pp2_recipe", "two", "recipe"),
    ("pp2_empty_v1", "two", "empty_v1"), ("pp2_eval", "two", "eval"),
    ("pp4", "four", "v2"),
    ("pp2_tp2_sp", "four", "base"), ("pp2_fsdp2", "four", "base"),
    ("pp2_dp2", "four", "base")])
def test_pipelined_runs_match_one_rank(request, root, one_rank, name, ranks, ref):
    assert min(w[1] for w in one_rank["base"][0]) > 0.3  # every step clips
    runs = request.getfixturevalue(f"{ranks}_ranks")[name]
    want, out = one_rank[ref]
    assert len(want) == STEPS
    for rank, seen in enumerate(runs):
        _close(seen["losses"], [w[0] for w in want], f"{name} rank {rank} loss")
        _close(seen["grad_norms"], [w[1] for w in want], f"{name} rank {rank} norm")
    _same_final_state(out, root / "runs" / name)
    if ref == "recipe":  # the EMA, whole
        from f_lite_tpu_torch.train.checkpoint import read_entry

        final = Path("checkpoints") / str(STEPS) / "ema"
        a, b = read_entry(out / final)[1], read_entry(root / "runs" / name / final)[1]
        assert set(a) == set(b)
        for k in a:
            _near(b[k].numpy(), a[k].numpy(), k)
    if ref == "eval":  # the validation loss, from degraded batches of 3
        lines = [json.loads(x) for x in
                 (out / "logs" / "metrics.jsonl").read_text().splitlines()]
        want_val = [x["val/loss"] for x in lines if "val/loss" in x and "step" in x]
        assert len(want_val) == 1
        for rank, seen in enumerate(runs):
            _close([seen["val/loss"]], want_val, f"rank {rank} val/loss")
    if ref == "buckets":  # the sample grid, from the degraded CFG batch
        from f_lite_tpu_torch.utils.image import read_png

        png = Path("samples") / f"step_{STEPS}.png"
        a = read_png((out / png).read_bytes()).astype(int)
        b = read_png((root / "runs" / name / png).read_bytes()).astype(int)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1


def test_two_stage_run_matches_the_jax_trainer(runs):
    """The JAX trainer at --pp 2 --pp_microbatches 2 --scan_layers (a (1,
    2, 1, 1) mesh of the CPU devices) and the port at the same flags, v2 at
    depth 2, on the same cache, pipeline and injected draws: every step's
    loss within 1e-5 relative."""
    want = runs["jax"]
    assert len(want) == STEPS
    for rank, seen in enumerate(runs["two"]["pp2_fixed"]):
        _close(seen["losses"], want, f"rank {rank}")


@pytest.mark.parametrize("direction", ["pp2_to_pp1", "pp1_to_pp2"])
def test_checkpoints_resume_across_pipeline_degrees(root, one_rank, two_ranks, direction):
    """pp 2's step-2 checkpoint resumed at one rank, and one rank's resumed
    at pp 2, give the straight one-rank run's step 3 and final state."""
    straight, out = one_rank["base"]
    if direction == "pp1_to_pp2":
        for seen in two_ranks["resume_pp2"]:
            _close(seen["losses"], [w[0] for w in straight[2:]], "pp 2 resumed")
        _same_final_state(out, root / "runs" / "resume_pp2")
        return
    from f_lite_tpu_torch.train.trainer import parse_args, train

    resumed = root / "resume_pp1"
    shutil.copytree(root / "runs" / "pp2" / "checkpoints" / "2",
                    resumed / "checkpoints" / "2")
    losses = []
    train(parse_args(_base_argv(root, resumed, "--resume_from_checkpoint", "latest")),
          on_step=lambda s, m: losses.append(float(m["loss"])))
    _close(losses, [w[0] for w in straight[2:]], "pp 1 resumed")
    _same_final_state(out, resumed)


def test_scan_layers_export_is_jax_layout_and_loads_in_both(root, two_ranks, tmp_path):
    """pp 2's `--export_pipeline` under `--scan_layers`: its tensors
    bit-equal to JAX's `to_scan_layout` of the unrolled export of the same
    weights, `scan_layers: true` and `pipeline_stages: 1`; the port loads
    the trained weights back bit for bit, and the JAX pipeline loads it."""
    import jax.numpy as jnp

    from f_lite_tpu.convert.torch_to_jax import to_scan_layout
    from f_lite_tpu.models.dit import DiTConfig as JaxDiTConfig
    from f_lite_tpu.pipeline import FLitePipeline as JaxPipeline
    from f_lite_tpu_torch.convert.from_jax import unflatten
    from f_lite_tpu_torch.models.dit import DiT
    from f_lite_tpu_torch.pipeline import FLitePipeline
    from f_lite_tpu_torch.train.trainer import build_config, parse_args
    from f_lite_tpu_torch.utils.safetensors import load_file

    export = root / "runs" / "pp2" / "pipeline"
    config = json.loads((export / "dit" / "config.json").read_text())
    assert config["scan_layers"] is True and config["pipeline_stages"] == 1
    trained = _final_tensors(root / "runs" / "pp2")
    cfg = build_config(parse_args(_base_argv(root, tmp_path)))
    dit = DiT(cfg)
    dit.load_state_dict({k: torch.from_numpy(v) for k, v in trained.items()
                         if not k.startswith("opt.")}, strict=True)
    FLitePipeline(dit).save_pretrained(tmp_path / "unrolled")

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            key = f"{prefix}.{k}" if prefix else k
            out.update(flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
        return out

    jcfg = JaxDiTConfig(**{k: v for k, v in config.items()
                           if k in {f for f in JaxDiTConfig.__dataclass_fields__}})
    want = flat(to_scan_layout(unflatten(load_file(
        tmp_path / "unrolled" / "dit" / "flax_params.safetensors")), jcfg))
    got = load_file(export / "dit" / "flax_params.safetensors")
    assert set(got) == set(want) and any(k.startswith("blocks_rest.") for k in got)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    back = FLitePipeline.from_pretrained(export, dtype=torch.float32, device="cpu",
                                         load_text_encoder=False).dit.state_dict()
    for k, v in back.items():
        assert np.array_equal(v.numpy(), trained[k]), k
    jpipe = JaxPipeline.from_pretrained(export, dtype=jnp.float32, load_text_encoder=False)
    assert jpipe.dit_model.config.scan_layers
    assert "blocks_rest" in jpipe.dit_params["params"]
