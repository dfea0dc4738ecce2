"""Data-parallel and FSDP training across ranks (`f_lite_tpu_torch/parallel/`)
on the CPU, with gloo: each multi-rank run is 2 or 4 processes started
here as `torchrun` starts them (its variables set, one process a rank, a
free port), at a tiny config in fp32 on a precomputed cache.

- `create_mesh` / `resolve_mesh` sizes and errors, `process_replica_info`
  from torchrun's variables;
- the samplers strided over 2 and 4 replicas against
  `f_lite_tpu.data.samplers`, item for item, with resume state;
- 3 steps at fsdp 2, fsdp 4, dp 2 and dp 2 x fsdp 2 against the same 3
  steps on one rank: every logged loss and gradient norm within 1e-5
  relative, the final checkpoint's tensors (gathered whole) within 1e-5
  (the runs clip: their norms pass `--max_grad_norm 0.3`); and a 2-rank run
  against the JAX trainer on one process, both on the same injected draws;
- each rank's share of the parameter and moment bytes;
- `--bs_rampup` with accumulation, `--ema_decay` and `--use_lora` at 2
  ranks against one, at the same bars;
- a checkpoint written at 2 ranks resumed at 1 and at 2 ranks;
- SIGTERM to one rank stops both at the same step;
- `--multihost` over two nodes of one rank each (the loader strided by
  node): an odd bucket count under a linear schedule (both nodes take as
  many steps and keep equal replicas), a resume past epoch 0 from an
  async checkpoint, and an uneven validation set under FSDP across the
  nodes;
- the streaming safetensors writer's order;
- the errors: a mesh that does not fill the world, `--multihost` without
  torchrun's variables, a batch that does not divide over a node's ranks.
The one-rank references run in this process, unwrapped.
"""

import hashlib
import json
import multiprocessing
import os
import shutil
import signal
import socket
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
STEPS = 3
TIMEOUT_S = 150


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fixed(step: int, shape) -> tuple:
    """Injected draws of step `step` for a batch of `shape` (B, h, w, C):
    timesteps and noise, the same for the port and for JAX."""
    rs = np.random.RandomState(1000 + step)
    return (rs.uniform(0.05, 0.95, shape[0]).astype(np.float32),
            rs.randn(*shape).astype(np.float32))


def _fixed_loss_draws(generator, shape, device, **kw):
    """`loss.draw_loss_inputs` with `_fixed`'s draws (seed 0: the step
    generator's seed is the step) and no caption dropout."""
    from f_lite_tpu_torch.train.loss import LossDraws

    t, n = _fixed(generator.initial_seed(), tuple(shape))
    return LossDraws(None, torch.from_numpy(t).to(device),
                     torch.from_numpy(n).to(device), None)


def _record(job_dir: Path, rank: int, job: dict) -> None:
    """Run one job of a worker (every rank the same) and write what it
    saw to job_dir/rank{rank}.json."""
    from f_lite_tpu_torch.parallel.sharding import local
    from f_lite_tpu_torch.train import loss as loss_mod
    from f_lite_tpu_torch.train.trainer import parse_args, train

    seen = {"losses": [], "grad_norms": []}

    def on_step(state, metrics):
        seen["losses"].append(float(metrics["loss"]))
        seen["grad_norms"].append(float(metrics["grad_norm"]))
        seen["state"] = state
        if job.get("sigterm_rank") == rank and state.step == job["sigterm_step"]:
            os.kill(os.getpid(), signal.SIGTERM)

    saved = loss_mod.draw_loss_inputs
    if job.get("fixed_draws"):
        loss_mod.draw_loss_inputs = _fixed_loss_draws
    try:
        result = train(parse_args(job["argv"]), on_step=on_step)
    finally:
        loss_mod.draw_loss_inputs = saved
    state = seen.pop("state")
    with torch.no_grad():
        opt = getattr(state.optimizer, "opt", state.optimizer)
        seen["param_bytes"] = sum(local(p).numel() * p.element_size()
                                  for p in state.model.parameters())
        seen["moment_bytes"] = sum(local(t).numel() * t.element_size()
                                   for t in [*opt.mu, *opt.nu])
        digest = hashlib.sha256()
        for p in state.model.parameters():
            digest.update(local(p).numpy().tobytes())
        seen["local_params_sha256"] = digest.hexdigest()
    seen["whole_param_bytes"] = sum(p.numel() * p.element_size()
                                    for p in state.model.parameters())
    for key in ("preempted_at", "global_step", "train/lr", "val/loss"):
        seen[key] = result.get(key)
    (job_dir / f"rank{rank}.json").write_text(json.dumps(seen))


def _worker(rank: int, world: int, local_world: int, port: int, jobs: list,
            out: str) -> None:
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank % local_world),
                      LOCAL_WORLD_SIZE=str(local_world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from f_lite_tpu_torch.parallel.mesh import init_distributed

    try:
        init_distributed("cpu")  # kept across the jobs: train() forms none
        for job in jobs:
            if "copy" in job:  # rank 0 copies a checkpoint between jobs
                if rank == 0:
                    shutil.copytree(job["copy"][0], job["copy"][1])
                dist.barrier()
                continue
            job_dir = Path(out) / job["name"]
            job_dir.mkdir(parents=True, exist_ok=True)
            _record(job_dir, rank, job)
            dist.barrier()
    except BaseException:
        (Path(out) / f"error_rank{rank}.txt").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn(world: int, jobs: list, out: Path, local_world=None) -> dict:
    """Run `jobs` on `world` spawned ranks (`local_world` a node); {job
    name: [each rank's record]}."""
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker,
                         args=(r, world, local_world or world, port, jobs, str(out)))
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
# the recipe: a tiny pixel-space DiT from a seeded pipeline, 8 rows a step
# ---------------------------------------------------------------------------

def _base_argv(root: Path, out: Path, *extra) -> list:
    return ["--device", "cpu", "--use_precomputed_data",
            "--precomputed_data_dir", str(root / "cache"), "--pixel_space",
            "--model_width", "64", "--model_depth", "2", "--model_head_dim", "32",
            "--cross_attn_input_size", "32", "--residual_v",
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
    # seed 1: the weights of steps 1-2 fall 3 / 1 and 1 / 3 over 2 ranks
    "rampup_accum": ["--bs_rampup", "4", "--gradient_accumulation_steps", "2",
                     "--seed", "1"],
    "ema": ["--ema_decay", "0.9"],
    "lora": ["--use_lora", "--lora_rank", "4", "--lora_alpha", "4"],
}


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> Path:
    """The cache (24 items of 16x16x3, captions of 5-7 tokens: 3 batches
    an epoch, so that step 2 is mid-epoch, ROADMAP R4) and the
    initial pipeline (seeded weights, the zero heads drawn too, so every
    weight gets a gradient at the first step)."""
    from f_lite_tpu_torch.data.precomputed import PrecomputedCacheWriter
    from f_lite_tpu_torch.models.dit import DiT
    from f_lite_tpu_torch.pipeline import FLitePipeline
    from f_lite_tpu_torch.train.trainer import build_config, parse_args

    root = tmp_path_factory.mktemp("parallel")
    writer = PrecomputedCacheWriter(root / "cache")
    rs = np.random.RandomState(5)
    for i in range(24):
        writer.add(f"{i}", f"a caption {i % 4}",
                   rs.uniform(-1, 1, (16, 16, 3)).astype(np.float32),
                   rs.randn(5 + i % 3, 32).astype(np.float32))
    writer.finalize()
    argv = _base_argv(root, root / "unused")
    i = argv.index("--pretrained_model_path")
    cfg = build_config(parse_args(argv[:i] + argv[i + 2:]))
    dit = DiT(cfg).init_weights(torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in dit.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.02)
    FLitePipeline(dit).save_pretrained(root / "init")
    return root


def _one_rank(root: Path, name: str, *extra) -> tuple:
    """(every step's (loss, grad norm), the run's output dir) on this
    process, one rank."""
    from f_lite_tpu_torch.train.trainer import parse_args, train

    out = root / "one" / name
    seen = []
    train(parse_args(_base_argv(root, out, *extra)),
          on_step=lambda s, m: seen.append((float(m["loss"]), float(m["grad_norm"]))))
    return seen, out


@pytest.fixture(scope="module")
def one_rank(root) -> dict:
    return {name: _one_rank(root, name, *extra) for name, extra in RECIPES.items()}


def _job(root: Path, name: str, *extra, **kw) -> dict:
    return {"name": name, "argv": _base_argv(root, root / "runs" / name, *extra), **kw}


@pytest.fixture(scope="module")
def two_ranks(root) -> dict:
    resume2 = root / "runs" / "resume2"
    jobs = [_job(root, "fsdp2", "--fsdp", "2"),
            _job(root, "dp2", "--dp", "2"),
            *(_job(root, f"fsdp2_{n}", "--fsdp", "0", *RECIPES[n])
              for n in ("rampup_accum", "ema", "lora")),
            {"copy": (str(root / "runs" / "fsdp2" / "checkpoints" / "2"),
                      str(resume2 / "checkpoints" / "2"))},
            _job(root, "resume2", "--fsdp", "2", "--resume_from_checkpoint", "latest"),
            _job(root, "jax_draws", "--fsdp", "2", fixed_draws=True),
            _job(root, "sigterm", "--fsdp", "2", "--max_steps", "6",
                 "--checkpointing_steps", "0", sigterm_rank=1, sigterm_step=2)]
    return _spawn(2, jobs, root / "two")


@pytest.fixture(scope="module")
def four_ranks(root) -> dict:
    jobs = [_job(root, "fsdp4", "--fsdp", "4"),
            _job(root, "dp2_fsdp2", "--dp", "2", "--fsdp", "2")]
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
# mesh and samplers
# ---------------------------------------------------------------------------

def test_create_mesh_sizes_errors_and_replica_info(monkeypatch):
    from f_lite_tpu_torch.parallel import mesh

    assert mesh.resolve_mesh(1, 0, 8) == (1, 8)
    assert mesh.resolve_mesh(2, 0, 8) == (2, 4)
    assert mesh.resolve_mesh(2, 2, 4) == (2, 2)
    assert mesh.resolve_mesh(1, 0, 1) == (1, 1)
    with pytest.raises(ValueError, match="must equal WORLD_SIZE"):
        mesh.resolve_mesh(2, 3, 8)
    with pytest.raises(ValueError, match="does not divide"):
        mesh.resolve_mesh(3, 0, 8)
    for v in mesh.TORCHRUN_VARS:
        monkeypatch.delenv(v, raising=False)
    assert mesh.process_replica_info() == (1, 0)
    assert mesh.init_distributed("cpu") == (1, 0, 1, 0)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    for world, rank, local_world, want in ((8, 5, 4, (2, 1)), (8, 3, 8, (1, 0)),
                                           (6, 4, 2, (3, 2))):
        monkeypatch.setenv("WORLD_SIZE", str(world))
        monkeypatch.setenv("RANK", str(rank))
        monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
        monkeypatch.setenv("LOCAL_RANK", str(rank % local_world))
        assert mesh.process_replica_info() == want


class _Items:
    def __init__(self, n, shapes=((8, 8, 4),)):
        self.n, self.shapes = n, shapes

    def __len__(self):
        return self.n

    def setup_aspect_ratio_buckets(self):
        buckets = {}
        for i in range(self.n):
            buckets.setdefault(self.shapes[i % len(self.shapes)], []).append(i)
        self.aspect_ratio_buckets = buckets


@pytest.mark.parametrize("replicas", [2, 4])
@pytest.mark.parametrize("kind", ["shuffled", "bucketed"])
def test_strided_samplers_match_jax_item_for_item(kind, replicas):
    """Each replica's items (or batches), its state JSON, and its order
    after a resume and after reset(0), against the JAX samplers; the
    replicas' items together are the epoch's, each once."""
    from f_lite_tpu.data.samplers import ResolutionBucketSampler as JaxBucket
    from f_lite_tpu.data.samplers import StatefulDistributedSampler as JaxItems
    from f_lite_tpu_torch.data.samplers import (
        ResolutionBucketSampler,
        StatefulDistributedSampler,
    )

    shapes = [(8, 8, 4), (8, 12, 4), (12, 8, 4)]

    def pair(rank, seed):
        kw = dict(num_replicas=replicas, rank=rank, seed=seed)
        if kind == "shuffled":
            return (JaxItems(_Items(27), 4, shuffle=True, **kw),
                    StatefulDistributedSampler(_Items(27), 4, shuffle=True, **kw))
        return (JaxBucket(_Items(40, shapes), 3, **kw),
                ResolutionBucketSampler(_Items(40, shapes), 3, **kw))

    seen = []
    for rank in range(replicas):
        j, t = pair(rank, 5)
        for s in (j, t):
            s.set_epoch(2)
        got = list(t)
        assert got == list(j) and len(t) == len(got)
        seen += [i for b in got for i in (b if kind == "bucketed" else [b])]
        for step in (0, 3, 7, 50):
            assert json.dumps(t.state_dict(step)) == json.dumps(j.state_dict(step))
        state = j.state_dict(2)
        j2, t2 = pair(rank, 0)
        j2.load_state_dict(state)
        t2.load_state_dict(json.loads(json.dumps(state)))
        assert t2.epoch == 2 and list(t2) == list(j2) and len(t2) == len(list(j2))
        j2.reset(0)
        t2.reset(0)
        assert list(t2) == list(j2)
    assert len(seen) == len(set(seen))
    if kind == "shuffled":
        assert sorted(seen) == list(range(27))


# ---------------------------------------------------------------------------
# runs across ranks against one rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,ranks", [("fsdp2", "two"), ("dp2", "two"),
                                        ("fsdp4", "four"), ("dp2_fsdp2", "four")])
def test_mesh_runs_match_one_rank(request, root, one_rank, name, ranks):
    assert min(w[1] for w in one_rank["base"][0]) > 0.3  # every step clips
    runs = request.getfixturevalue(f"{ranks}_ranks")[name]
    want, out = one_rank["base"]
    assert len(want) == STEPS
    for rank, seen in enumerate(runs):
        _close(seen["losses"], [w[0] for w in want], f"{name} rank {rank} loss")
        _close(seen["grad_norms"], [w[1] for w in want], f"{name} rank {rank} norm")
    _same_final_state(out, root / "runs" / name)


def test_two_rank_run_matches_the_jax_trainer(root, two_ranks, monkeypatch):
    """The JAX trainer on one process and the port at fsdp 2 on the same
    cache, pipeline and injected draws (`_fixed`; no caption dropout; the
    JAX draws looked up by their step key): every step's loss within 1e-5
    relative."""
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
    # --scan_layers: the JAX trainer loads a pretrained pipeline restacked,
    # which its unrolled model does not take (ADVICE.md:3, a fault of the
    # reference that ROADMAP records)
    argv = _base_argv(root, root / "jax", "--checkpointing_steps", "0", "--scan_layers")
    jax_trainer.train(jax_trainer.parse_args(argv[2:]))
    want = [float(x["train/loss"]) for x in logged if "train/loss" in x]
    assert len(want) == STEPS
    for rank, seen in enumerate(two_ranks["jax_draws"]):
        _close(seen["losses"], want, f"rank {rank}")


@pytest.mark.parametrize("name,ranks,world", [("fsdp2", "two", 2),
                                              ("fsdp4", "four", 4)])
def test_each_rank_holds_its_share_of_the_state(request, name, ranks, world):
    """Parameters and AdamW moments: about 1/world of the whole a rank
    (FSDP2 pads each tensor's last shard)."""
    runs = request.getfixturevalue(f"{ranks}_ranks")[name]
    whole = runs[0]["whole_param_bytes"]
    for seen in runs:
        assert seen["param_bytes"] <= whole / world * 1.15
        assert seen["moment_bytes"] <= 2 * whole / world * 1.15
    assert sum(s["param_bytes"] for s in runs) == whole
    assert sum(s["moment_bytes"] for s in runs) == 2 * whole


@pytest.mark.parametrize("recipe", ["rampup_accum", "ema", "lora"])
def test_recipe_options_at_two_ranks_match_one_rank(root, one_rank, two_ranks, recipe):
    want, out = one_rank[recipe]
    for rank, seen in enumerate(two_ranks[f"fsdp2_{recipe}"]):
        _close(seen["losses"], [w[0] for w in want], f"{recipe} rank {rank} loss")
        _close(seen["grad_norms"], [w[1] for w in want], f"{recipe} rank {rank} norm")
    _same_final_state(out, root / "runs" / f"fsdp2_{recipe}")
    if recipe == "ema":
        ema = Path("checkpoints") / str(STEPS) / "ema"
        from f_lite_tpu_torch.train.checkpoint import read_entry

        a, b = read_entry(out / ema)[1], read_entry(root / "runs" / "fsdp2_ema" / ema)[1]
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), rtol=0, atol=1e-5)
    if recipe == "lora":
        from f_lite_tpu_torch.utils.safetensors import load_file

        final = Path("checkpoints") / str(STEPS) / "lora_weights.safetensors"
        a, b = load_file(out / final), load_file(root / "runs" / "fsdp2_lora" / final)
        # self qkv, proj; cross q, context_kv, proj: x 2 blocks x 2 factors
        assert set(a) == set(b) and len(a) == 20
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("world", [1, 2])
def test_checkpoint_from_two_ranks_resumes(root, two_ranks, world):
    """fsdp 2's step-2 checkpoint resumed at 2 ranks gives its step 3 bit
    for bit, and at one rank within 1e-5."""
    straight = two_ranks["fsdp2"][0]["losses"]
    if world == 2:
        for seen in two_ranks["resume2"]:
            assert seen["losses"] == straight[2:]
        return
    out = root / "resume1"
    shutil.copytree(root / "runs" / "fsdp2" / "checkpoints" / "2",
                    out / "checkpoints" / "2")
    from f_lite_tpu_torch.train.trainer import parse_args, train

    losses = []
    train(parse_args(_base_argv(root, out, "--resume_from_checkpoint", "latest")),
          on_step=lambda s, m: losses.append(float(m["loss"])))
    _close(losses, straight[2:], "resumed at one rank")
    _same_final_state(root / "runs" / "fsdp2", out)


def test_sigterm_to_one_rank_stops_both_at_one_step(root, two_ranks):
    runs = two_ranks["sigterm"]
    assert [s["preempted_at"] for s in runs] == [2, 2]
    assert all(len(s["losses"]) == 2 for s in runs)
    from f_lite_tpu_torch.train.checkpoint import Checkpointer

    assert Checkpointer(root / "runs" / "sigterm").steps() == [2]


def _without(argv: list, option: str, values: int = 1) -> list:
    """`argv` without `option` and its `values` values."""
    i = argv.index(option)
    return argv[:i] + argv[i + 1 + values:]


@pytest.fixture(scope="module")
def two_nodes(root) -> dict:
    """Runs over two nodes of one rank each (`--multihost`)."""
    from f_lite_tpu_torch.utils.image import png_bytes_with_metadata

    images = root / "images"
    rs = np.random.RandomState(9)
    for table, n in (("train", 8), ("val", 3)):
        rows = []
        for i in range(n):
            f = images / table / f"{i}.png"
            f.parent.mkdir(parents=True, exist_ok=True)
            f.write_bytes(png_bytes_with_metadata(rs.randint(0, 256, (16, 16, 3), np.uint8)))
            rows.append({"media_path": str(f), "captions": [f"shape {i}"],
                         "width": 16, "height": 16})
        (images / f"{table}.json").write_text(json.dumps(rows))
    online = _without(_base_argv(root, root / "runs" / "uneven_val"),
                      "--use_precomputed_data", values=0)
    online = _without(online, "--precomputed_data_dir")
    online += ["--train_data_path", str(images / "train.json"), "--root_dir_type", "json",
               "--base_url", "file://", "--resolution", "16", "--center_crop",
               "--train_batch_size", "4", "--val_data_path", str(images / "val.json"),
               "--eval_batch_size", "1", "--eval_every", "1", "--max_steps", "1",
               "--checkpointing_steps", "0", "--multihost", "--fsdp", "0"]
    resume = root / "runs" / "items_resume"
    # 24 items at a node batch of 4: 3 batches a node an epoch, so step 4
    # is epoch 1's first; 3 bucket batches of 8 fall 2 / 1 over the nodes
    items = ("--multihost", "--fsdp", "0", "--train_batch_size", "4", "--max_steps", "5",
             "--checkpointing_steps", "4", "--async_checkpoint")
    jobs = [_job(root, "multihost", "--multihost", "--fsdp", "0", "--train_batch_size", "4"),
            {"name": "buckets_linear",
             "argv": _without(_base_argv(root, root / "runs" / "buckets_linear"),
                              "--max_steps")
             + ["--multihost", "--dp", "2", "--use_resolution_buckets",
                "--lr_scheduler", "linear"]},
            _job(root, "items_straight", *items),
            {"copy": (str(root / "runs" / "items_straight" / "checkpoints" / "4"),
                      str(resume / "checkpoints" / "4"))},
            _job(root, "items_resume", *items, "--resume_from_checkpoint", "latest"),
            {"name": "uneven_val", "argv": online}]
    return _spawn(2, jobs, root / "nodes", local_world=1)


def test_multihost_over_two_nodes(two_nodes):
    """Two nodes of one rank each (`--multihost`, fsdp 2): each node loads
    its stride of the items, the ranks log one global loss, finite."""
    runs = two_nodes["multihost"]
    assert runs[0]["losses"] == runs[1]["losses"]
    assert len(runs[0]["losses"]) == STEPS and np.isfinite(runs[0]["losses"]).all()


def test_nodes_with_uneven_strides_agree_on_steps_and_schedule(two_nodes):
    """3 bucket batches over 2 nodes (2 and 1) with a linear schedule and
    the default max_steps: both nodes count 1 batch an epoch, so 3 steps
    over 3 epochs at the same learning rates, and the dp replicas end
    equal bit for bit."""
    a, b = two_nodes["buckets_linear"]
    assert a["global_step"] == b["global_step"] == 3
    assert a["train/lr"] == b["train/lr"]
    assert a["losses"] == b["losses"] and len(a["losses"]) == 3
    assert a["local_params_sha256"] == b["local_params_sha256"]


def test_multihost_resume_past_epoch_zero(root, two_nodes):
    """A checkpoint at step 4 (epoch 1's first batch of each node, written
    async) resumes into epoch 1's second batch: step 5's loss and the final
    tensors are the straight run's, bit for bit."""
    straight, resumed = two_nodes["items_straight"], two_nodes["items_resume"]
    state = json.loads((root / "runs" / "items_straight" / "checkpoints" / "4"
                        / "sampler_state.json").read_text())
    assert state == {"start_index": 4, "epoch": 1, "seed": 0, "shuffle": True}
    for a, b in zip(straight, resumed):
        assert len(a["losses"]) == 5 and b["losses"] == a["losses"][4:]
    want = _final_tensors(root / "runs" / "items_straight")
    got = _final_tensors(root / "runs" / "items_resume")
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_uneven_validation_over_nodes(two_nodes):
    """3 validation items at batch 1 over 2 nodes (2 and 1) with the DiT
    sharded across the nodes: each node runs the least count, 1 batch,
    and both log one finite loss."""
    a, b = two_nodes["uneven_val"]
    assert a["val/loss"] == b["val/loss"] and np.isfinite(a["val/loss"])


def test_streaming_writer_holds_the_file_order(tmp_path):
    from f_lite_tpu_torch.utils.safetensors import load_file, order, writer

    tensors = {"b": torch.ones(2), "a": torch.zeros(3, dtype=torch.bfloat16)}
    assert order(tensors) == ["a", "b"]
    with writer(tensors, tmp_path / "ok.safetensors") as put:
        for name in order(tensors):
            put(name, tensors[name])
    got = load_file(tmp_path / "ok.safetensors")
    assert got["a"].tolist() == [0, 0, 0] and got["b"].tolist() == [1, 1]
    with pytest.raises(ValueError, match="'b' where 'a' is next"):
        with writer(tensors, tmp_path / "bad.safetensors") as put:
            put("b", tensors["b"])
    with pytest.raises(ValueError, match="'b' was never written"):
        with writer(tensors, tmp_path / "short.safetensors") as put:
            put("a", tensors["a"])


@pytest.mark.parametrize("case", ["mesh_short", "mesh_over", "multihost_no_torchrun",
                                  "multihost_one_node", "batch"])
def test_mesh_and_batch_errors(root, monkeypatch, case):
    from f_lite_tpu_torch.train.trainer import parse_args, train

    env = dict(WORLD_SIZE="4", RANK="0", LOCAL_RANK="0", LOCAL_WORLD_SIZE="4",
               MASTER_ADDR="127.0.0.1", MASTER_PORT="1")
    extra, match = {
        "mesh_short": (["--dp", "1", "--fsdp", "2"], "must equal WORLD_SIZE"),
        "mesh_over": (["--dp", "2", "--fsdp", "4"], "must equal WORLD_SIZE"),
        "multihost_no_torchrun": (["--multihost"], "torchrun's variables"),
        "multihost_one_node": (["--multihost", "--fsdp", "0"], "one node"),
        "batch": (["--fsdp", "0", "--train_batch_size", "6"],
                  "does not divide evenly over the 4 ranks"),
    }[case]
    for k, v in env.items():
        if case == "multihost_no_torchrun":
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match=match):
        train(parse_args(_base_argv(root, root / "errors", *extra)))
