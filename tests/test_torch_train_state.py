"""The port trainer's run state and recipe options against the JAX package,
on the CPU in fp32.

- sequence dropout: the DiT with injected `token_indices` (rope and
  positional rows) against JAX's `DiT.apply(..., token_indices)`, MSE <
  1e-9, and its parameter gradients against `jax.grad` (1e-4 relative);
- remat "dots": gradients bit-equal to no remat and to "full", and the
  activations the forward leaves for the backward strictly between
  theirs;
- `optim.Accumulate` against `optax.MultiSteps(build_optimizer(...), k)`;
  the trainer's `global_step` and `max_steps` under accumulation (R3);
- EMA against the JAX trainer's update, exactly; `--bs_rampup`'s weights
  against its formula, exactly;
- the samplers' `state_dict` JSON and resumed order against
  `f_lite_tpu.data.samplers`; the bucketed precomputed loader's batches;
- the checkpoint's commit marker, `latest`, prune and async drain; resume
  bit-equal to the straight run; the mid-epoch resume's 18 steps
  (`tests/test_trainer.py`); SIGTERM in a subprocess.
"""

import json
import os
import signal
import subprocess
import sys
import time
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from f_lite_tpu.data.precomputed import create_precomputed_data_loader as jax_loader
from f_lite_tpu.data.samplers import ResolutionBucketSampler as JaxBucketSampler
from f_lite_tpu.data.samplers import StatefulDistributedSampler as JaxSampler
from f_lite_tpu.models.dit import DiT as JaxDiT
from f_lite_tpu.models.dit import DiTConfig as JaxDiTConfig
from f_lite_tpu.ops.patching import patchify as jax_patchify
from f_lite_tpu.train.optim import build_optimizer as jax_optimizer
from f_lite_tpu_torch.data.precomputed import (
    PrecomputedCacheWriter,
    create_precomputed_data_loader,
)
from f_lite_tpu_torch.data.samplers import (
    ResolutionBucketSampler,
    StatefulDistributedSampler,
)
from f_lite_tpu_torch.models.dit import DiTConfig
from f_lite_tpu_torch.train.checkpoint import Checkpointer
from f_lite_tpu_torch.train.optim import build_lr_schedule, build_optimizer
from f_lite_tpu_torch.train.trainer import (
    ema_update,
    parse_args,
    rampup_weights,
    train,
)
from test_torch_dit import flatten, random_jax_params
from test_torch_train import SMALL, _batch, _jax_loss, _port_loss, _port_model, _tiny_cache

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny models: one intra-op thread each, so that parallel test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _indices(seed, b=3, n=16, k=8):
    rs = np.random.RandomState(seed)
    return np.stack([rs.permutation(n)[:k] for _ in range(b)]).astype(np.int64)


# ---------------------------------------------------------------------------
# sequence dropout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_rope", [True, False])
def test_dit_with_token_indices_matches_jax(use_rope):
    kw = dict(SMALL, use_rope=use_rope)
    jcfg = JaxDiTConfig(**kw, use_pallas_attention=False)
    flat = random_jax_params(jcfg, 21)
    b = _batch(4)
    idx = _indices(5)
    _, params = _jax_loss(jcfg, flat, b)
    want = np.asarray(JaxDiT(jcfg).apply(
        {"params": params}, jnp.asarray(b["latents"]), jnp.asarray(b["context"]),
        jnp.asarray(b["mask"]), jnp.asarray(b["timesteps"]), jnp.asarray(idx)))
    model = _port_model(kw, flat)
    with torch.no_grad():
        got = model(*(torch.from_numpy(b[k]) for k in ("latents", "context", "mask",
                                                      "timesteps")),
                    torch.from_numpy(idx)).numpy()
    assert got.shape == want.shape == (3, 8, 16)
    assert float(np.abs(want).max()) > 1e-2
    assert float(((got - want) ** 2).mean()) < 1e-9


def test_token_indices_parameter_grads_match_jax_grad():
    """The flow-matching loss on kept tokens (the JAX loss's own formula:
    token-space prediction against the gathered target): loss to 1e-5 and
    per tensor max |g - g_jax| <= 1e-4 * max |g_jax|."""
    jcfg = JaxDiTConfig(**SMALL, use_pallas_attention=False)
    flat = random_jax_params(jcfg, 22)
    b = _batch(6)
    idx = _indices(7)
    _, params = _jax_loss(jcfg, flat, b)

    def jax_loss(p):
        t = jnp.asarray(b["timesteps"])[:, None, None, None]
        x, n = jnp.asarray(b["latents"]), jnp.asarray(b["noise"])
        pred = JaxDiT(jcfg).apply({"params": p}, x * (1 - t) + n * t,
                                  jnp.asarray(b["context"]), jnp.asarray(b["mask"]),
                                  jnp.asarray(b["timesteps"]), jnp.asarray(idx))
        targ = jnp.take_along_axis(jax_patchify(x - n, 2), jnp.asarray(idx)[..., None],
                                   axis=1)
        return jnp.mean(jnp.mean((targ - pred) ** 2, axis=(1, 2)))

    want_loss, jgrads = jax.value_and_grad(jax_loss)(params)
    from f_lite_tpu_torch.convert.from_jax import state_dict_from_jax
    from f_lite_tpu_torch.train.loss import flow_matching_loss

    want = state_dict_from_jax(flatten(jgrads), DiTConfig(**SMALL))
    model = _port_model(SMALL, flat)
    loss, _ = flow_matching_loss(
        model, *(torch.from_numpy(b[k]) for k in ("latents", "context", "mask")),
        uncond_prob=0.0, timesteps=torch.from_numpy(b["timesteps"]),
        noise=torch.from_numpy(b["noise"]), token_indices=torch.from_numpy(idx))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    loss.backward()
    for name, p in model.named_parameters():
        scale = float(want[name].abs().max())
        assert scale > 0, name
        assert float((p.grad - want[name]).abs().max()) <= 1e-4 * scale, name


def test_loss_keeps_the_jax_count_of_tokens():
    """token_keep_ratio draws max(1, int(n * ratio)) distinct patches a row
    from the generator: 0.5 of 16 patches keeps 8, 0.01 keeps 1."""
    seen = []

    def dit(x, ctx, mask, t, token_indices=None):
        seen.append(token_indices)
        return torch.zeros(x.shape[0], token_indices.shape[1], 16)

    b = _batch(8)
    from f_lite_tpu_torch.train.loss import flow_matching_loss

    for ratio, keep in ((0.5, 8), (0.01, 1)):
        flow_matching_loss(dit, *(torch.from_numpy(b[k]) for k in ("latents", "context",
                                                                   "mask")),
                           generator=torch.Generator().manual_seed(0), uncond_prob=0.0,
                           token_keep_ratio=ratio)
        idx = seen[-1]
        assert idx.shape == (3, keep)
        assert all(len(set(row.tolist())) == keep for row in idx)


# ---------------------------------------------------------------------------
# remat "dots"
# ---------------------------------------------------------------------------

class _LiveOutputs(TorchDispatchMode):
    """Weak references to every tensor an op makes under the mode."""

    def __init__(self):
        super().__init__()
        self.refs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.refs.extend(weakref.ref(t) for t in tree_flatten(out)[0]
                         if isinstance(t, torch.Tensor))
        return out


def test_dots_remat_gives_the_same_grads_and_keeps_the_products():
    """Gradients under "dots" are bit-equal to no remat and to "full"
    (blocks 1-2 checkpointed). What the forward leaves for the backward,
    counted as the tensors made in the forward that are alive when it
    returns (a `saved_tensors_hooks` pack hook does not see inside a
    non-reentrant checkpoint, whose own hooks take precedence), lies
    strictly between "full"'s and no remat's."""
    import gc

    jcfg = JaxDiTConfig(**SMALL, use_pallas_attention=False)
    flat = random_jax_params(jcfg, 23)
    b = _batch(9)
    grads, alive = {}, {}
    for mode in ("none", "full", "dots"):
        extra = {} if mode == "none" else dict(gradient_checkpoint=True,
                                                gradient_checkpoint_from=1,
                                                remat_policy=mode)
        model = _port_model(SMALL, flat, **extra)
        track = _LiveOutputs()
        with track:
            loss, _ = _port_loss(model, b)
        gc.collect()
        alive[mode] = sum(r() is not None for r in track.refs)
        loss.backward()
        grads[mode] = {n: p.grad for n, p in model.named_parameters()}
    for name, g in grads["none"].items():
        assert torch.equal(g, grads["full"][name]), name
        assert torch.equal(g, grads["dots"][name]), name
    assert alive["full"] < alive["dots"] < alive["none"], alive


# ---------------------------------------------------------------------------
# gradient accumulation, EMA, bs_rampup
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 3])
def test_accumulation_matches_optax_multisteps(k):
    """6 micro-steps of clip + AdamW under MultiSteps(k): parameters to
    1e-6 after every call, and the optimizer's count advances once per k."""
    rs = np.random.RandomState(10 + k)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    params = [rs.randn(*s).astype(np.float32) for s in shapes]
    kw = dict(learning_rate=1e-2, lr_scheduler="cosine", num_warmup_steps=1,
              max_steps=10, weight_decay=0.1, max_grad_norm=1.0)
    opt = optax.MultiSteps(jax_optimizer(**kw), k)
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    topt = build_optimizer(tp, **kw, accumulation_steps=k)
    for i in range(6):
        g = [rs.randn(*s).astype(np.float32) * (0.2 + i) for s in shapes]
        jg = [jnp.asarray(x) for x in g]
        updates, state = opt.update(jg, state, jp)
        jp = optax.apply_updates(jp, updates)
        norm = topt.step([torch.from_numpy(x) for x in g])
        np.testing.assert_allclose(float(norm), float(optax.global_norm(jg)), rtol=1e-6)
        for a, want in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        assert topt.count == (i + 1) // k and topt.mini_step == int(state.mini_step)
    for a, want in zip(topt.acc, state.acc_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_accumulation_counts_micro_batches_as_the_jax_trainer(tmp_path):
    """R3: with k = 2 and no --max_steps, max_steps is the epochs' batches
    over k (`f_lite_tpu/train/trainer.py:682-684`), global_step counts
    micro-batches (`:987`) and the logged lr is the schedule at global_step
    (`:1002`): 8 items at batch 4 over 3 epochs -> max_steps 3, 3 calls,
    one optimizer update."""
    cache = _tiny_cache(tmp_path / "cache")
    argv = _argv(cache, tmp_path / "out", "--num_epochs", "3",
                 "--gradient_accumulation_steps", "2")
    i = argv.index("--max_steps")
    del argv[i: i + 2]
    counts = []
    result = train(parse_args(argv), on_step=lambda s, m: counts.append(
        (s.step, s.optimizer.count)))
    assert result["global_step"] == 3
    assert counts == [(1, 0), (2, 1), (3, 1)]
    assert result["train/lr"] == build_lr_schedule(
        "linear", 1e-2, num_warmup_steps=1, max_steps=3)(3)


@pytest.mark.parametrize("ema_dtype", ["fp32", "bf16"])
def test_ema_matches_the_jax_update_exactly(ema_dtype):
    """The JAX trainer's update (`trainer.py:826-835`) op by op. Under
    `jax.jit` XLA's CPU backend contracts e * d + p * (1 - d) into a fused
    multiply-add, which differs in the last bit; the port, like eager JAX
    and numpy, rounds each product."""
    d = 0.99
    rs = np.random.RandomState(12)
    jdt = jnp.bfloat16 if ema_dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if ema_dtype == "bf16" else torch.float32
    p = [rs.randn(33, 7).astype(np.float32) for _ in range(3)]
    e0 = [rs.randn(33, 7).astype(np.float32) for _ in range(3)]
    jax_update = (lambda e, q: jax.tree.map(
        lambda a, b: (a.astype(jnp.float32) * d
                      + b.astype(jnp.float32) * (1.0 - d)).astype(a.dtype), e, q))
    je = [jnp.asarray(x, jdt) for x in e0]
    te = {str(i): torch.from_numpy(x).to(tdt) for i, x in enumerate(e0)}
    for _ in range(3):
        je = jax_update(je, [jnp.asarray(x) for x in p])
        ema_update(te, {str(i): torch.from_numpy(x) for i, x in enumerate(p)}, d)
    for i, want in enumerate(je):
        np.testing.assert_array_equal(te[str(i)].float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("decay", ["1.0", "-0.1"])
def test_ema_decay_outside_0_1_raises(tmp_path, decay):
    cache = _tiny_cache(tmp_path / "cache")
    with pytest.raises(ValueError, match="ema_decay must be 0"):
        train(parse_args(_argv(cache, tmp_path / "out", "--ema_decay", decay)))


def _jax_rampup(global_step, bsz, rampup, seed):
    """`f_lite_tpu/train/trainer.py:954-972`, verbatim but for the names."""
    if rampup and global_step < rampup:
        target = min(bsz, -(-(global_step + 1) * bsz // (rampup * 4)) * 4)
        if target < bsz:
            rs = np.random.RandomState((seed * 1000003 + global_step) % (2**32))
            perm = rs.permutation(bsz)
            w = np.zeros(bsz, np.float32)
            w[perm[:target]] = 1.0
            return w
    return None


@pytest.mark.parametrize("bsz,rampup,seed", [(32, 20, 0), (8, 5, 3), (4, 3, 11)])
def test_bs_rampup_weights_match_the_jax_formula(bsz, rampup, seed):
    for step in range(rampup + 2):
        want = _jax_rampup(step, bsz, rampup, seed)
        got = rampup_weights(step, bsz, rampup, seed)
        if want is None:
            assert got is None, step
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"step {step}")
    assert rampup_weights(0, bsz, None, seed) is None


# ---------------------------------------------------------------------------
# samplers and the bucketed precomputed loader
# ---------------------------------------------------------------------------

class _Items:
    def __init__(self, n, shapes=None):
        self.n = n
        self.shapes = shapes

    def __len__(self):
        return self.n

    def setup_aspect_ratio_buckets(self):
        buckets = {}
        for i in range(self.n):
            buckets.setdefault(self.shapes[i % len(self.shapes)], []).append(i)
        self.aspect_ratio_buckets = buckets


@pytest.mark.parametrize("kind", ["stateful", "bucket"])
def test_sampler_state_and_resumed_order_match_jax(kind):
    """state_dict JSON key for key after a mid-epoch step, then the order a
    fresh sampler gives after load_state_dict, and after reset(0)."""
    if kind == "stateful":
        j, t = (JaxSampler(_Items(23), 4, shuffle=True, seed=5),
                StatefulDistributedSampler(_Items(23), 4, shuffle=True, seed=5))
        j2, t2 = (JaxSampler(_Items(23), 4, shuffle=True, seed=0),
                  StatefulDistributedSampler(_Items(23), 4, shuffle=True, seed=0))
    else:
        shapes = [(8, 8, 4), (8, 12, 4), (12, 8, 4)]
        j, t = (JaxBucketSampler(_Items(40, shapes), 3, seed=5),
                ResolutionBucketSampler(_Items(40, shapes), 3, seed=5))
        j2, t2 = (JaxBucketSampler(_Items(40, shapes), 3, seed=0),
                  ResolutionBucketSampler(_Items(40, shapes), 3, seed=0))
    for s in (j, t):
        s.set_epoch(2)
    assert list(t) == list(j) and len(t) == len(j)
    for step in (0, 3, 7, 50):
        assert json.dumps(t.state_dict(step)) == json.dumps(j.state_dict(step))
    state = j.state_dict(7)
    j2.load_state_dict(state)
    t2.load_state_dict(json.loads(json.dumps(state)))
    assert t2.epoch == 2 and list(t2) == list(j2) and len(t2) == len(j2)
    assert json.dumps(t2.state_dict(9)) == json.dumps(j2.state_dict(9))
    j2.reset(0)
    t2.reset(0)
    assert list(t2) == list(j2)


def test_bucketed_precomputed_loader_matches_jax(tmp_path):
    writer = PrecomputedCacheWriter(tmp_path)
    rs = np.random.RandomState(13)
    for i in range(14):
        shape = [(4, 4, 3), (4, 6, 3), (6, 4, 3)][i % 3]
        writer.add(f"id{i}", f"caption {i % 5}", rs.randn(*shape).astype(np.float32),
                   rs.randn(5 + i % 4, 16).astype(np.float32))
    writer.finalize()
    jdl, js = jax_loader(tmp_path, 2, num_workers=1, seed=3, use_buckets=True)
    tdl, ts = create_precomputed_data_loader(tmp_path, 2, seed=3, use_buckets=True)
    for s in (js, ts):
        s.set_epoch(1)
    assert len(tdl) == len(jdl) == 6

    def check(jdl, tdl):
        n = 0
        for want, got in zip(jdl, tdl, strict=True):
            assert got["_id"] == want["_id"]
            for key in ("vae_latent", "text_embedding", "text_mask"):
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            n += 1
        return n

    assert check(jdl, tdl) == 6
    state = js.state_dict(4)
    jdl, _ = jax_loader(tmp_path, 2, num_workers=1, seed=3, use_buckets=True,
                        sampler_state=state)
    tdl, _ = create_precomputed_data_loader(tmp_path, 2, seed=3, use_buckets=True,
                                            sampler_state=state)
    assert check(jdl, tdl) == 2


# ---------------------------------------------------------------------------
# checkpoints, resume, SIGTERM
# ---------------------------------------------------------------------------

def test_checkpoint_commit_marker_latest_prune_and_async_drain(tmp_path):
    ck = Checkpointer(tmp_path, total_limit=2)
    t = {"w": torch.arange(6.0).reshape(2, 3), "h": torch.ones(4, dtype=torch.bfloat16)}
    for step in (2, 4):
        ck.save(step, t, {"step": step}, {"start_index": step}, extra={"ema": t})
    # a torn save (no state entry) is neither latest nor counted
    (ck.dir(9) / "ema").mkdir(parents=True)
    assert ck.steps() == [2, 4] and ck.latest == 4
    ck.save(6, t, {"step": 6}, wait=False)  # returns with the write in flight
    t["w"].add_(100.0)  # what was copied to host is what lands
    ck.wait_until_finished()
    assert ck.steps() == [4, 6] and ck.latest == 6 and not ck.dir(2).exists()
    meta, got = ck.load(6)
    assert meta == {"step": 6} and got["h"].dtype == torch.bfloat16
    assert torch.equal(got["w"], torch.arange(6.0).reshape(2, 3))
    assert ck.load_sampler_state(4) == {"start_index": 4}
    assert ck.load_extra(4, "ema")["w"].shape == (2, 3) and ck.load_extra(6, "ema") is None
    assert [(x["step"], x["wait"]) for x in ck.timings] == [(2, True), (4, True), (6, False)]
    assert all(x["write_s"] >= 0 and x["blocked_s"] >= 0 for x in ck.timings)
    assert ck.resolve("latest") == 6 and ck.resolve(str(ck.dir(4))) == 4


def test_checkpoint_writer_failure_raises_at_the_drain(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, {"w": torch.zeros(2, dtype=torch.int64)}, {}, wait=False)
    with pytest.raises(RuntimeError, match="checkpoint writer failed"):
        ck.wait_until_finished()
    assert ck.steps() == []


def _argv(cache, out, *extra):
    from test_torch_train import _tiny_argv

    argv = _tiny_argv(cache, out)
    argv.remove("--export_pipeline")
    argv.remove("--gradient_checkpointing")
    return argv + list(extra)


def _run(argv):
    steps = []

    def on_step(state, metrics):
        steps.append(float(metrics["loss"]))

    result = train(parse_args(argv), on_step=on_step)
    return result, steps


@pytest.mark.parametrize("recipe", [
    [],
    ["--gradient_accumulation_steps", "2", "--ema_decay", "0.9", "--bs_rampup", "3",
     "--sequence_dropout", "0.5"],
])
def test_resume_is_bit_equal_to_the_straight_run(tmp_path, recipe):
    """4 steps straight against 2 steps, then `--resume_from_checkpoint
    latest` to 4: the final checkpoint's parameters, optimizer state and
    EMA, and every step's loss, equal bit for bit. 24 items at batch 4:
    step 2 is inside the epoch (a checkpoint on an epoch's last step
    resumes into that epoch again, the JAX sampler's arithmetic, R4)."""
    cache = _tiny_cache(tmp_path / "cache", n=24)
    # a constant schedule: a linear one would decay to each run's max_steps
    common = ["--num_epochs", "4", "--checkpointing_steps", "2",
              "--lr_scheduler", "constant", *recipe]
    straight, losses = _run(_argv(cache, tmp_path / "a", *common, "--max_steps", "4"))
    _, first = _run(_argv(cache, tmp_path / "b", *common, "--max_steps", "2"))
    resumed, rest = _run(_argv(cache, tmp_path / "b", *common, "--max_steps", "4",
                               "--resume_from_checkpoint", "latest"))
    assert straight["global_step"] == resumed["global_step"] == 4
    assert losses == first + rest
    for name in (["state"] + (["ema"] if recipe else [])):
        a = Checkpointer(tmp_path / "a")
        b = Checkpointer(tmp_path / "b")
        want = a.load(4)[1] if name == "state" else a.load_extra(4, name)
        got = b.load(4)[1] if name == "state" else b.load_extra(4, name)
        assert set(want) == set(got)
        for k in want:
            assert torch.equal(want[k], got[k]), (name, k)
    assert a.load(4)[0] == b.load(4)[0]


def test_mid_epoch_resume_continues_that_epoch(tmp_path):
    """`tests/test_trainer.py`'s arithmetic on the precomputed path: 24
    items at batch 4 are 6 batches an epoch; stopped at step 8 (epoch 1),
    the resumed run does the 4 batches left of epoch 1 and all 6 of epoch 2:
    18 steps. The precomputed loader is resumed (R1)."""
    cache = _tiny_cache(tmp_path / "cache", n=24)
    out = tmp_path / "out"
    train(parse_args(_argv(cache, out, "--num_epochs", "3", "--max_steps", "8",
                           "--checkpointing_steps", "8")))
    state = json.loads((out / "checkpoints" / "8" / "sampler_state.json").read_text())
    assert state == {"start_index": 8, "epoch": 1, "seed": 0, "shuffle": True}
    result = train(parse_args(_argv(cache, out, "--num_epochs", "3", "--max_steps", "100",
                                    "--checkpointing_steps", "100",
                                    "--resume_from_checkpoint", "latest")))
    assert result["global_step"] == 18


def test_sigterm_checkpoints_exits_zero_and_resumes(tmp_path):
    """The counterpart of `tests/test_preemption.py`: SIGTERM while the
    trainer runs (`python -m f_lite_tpu_torch.train --device cpu`) ends
    it with exit 0, `preempted_at` and a checkpoint at the signal's step;
    `--resume_from_checkpoint latest` then runs to --max_steps."""
    cache = _tiny_cache(tmp_path / "cache")
    out = tmp_path / "out"
    # far more steps than the test waits for: only the signal ends the run
    argv = [sys.executable, "-m", "f_lite_tpu_torch.train",
            *_argv(cache, out, "--max_steps", "100000", "--num_epochs", "100000",
                   "--checkpointing_steps", "0", "--sample_every", "0")]
    log = tmp_path / "run.log"
    with open(log, "w") as lf:
        proc = subprocess.Popen(argv, stdout=lf, stderr=subprocess.STDOUT, cwd=ROOT,
                                env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        deadline = time.time() + 120
        while " loss " not in log.read_text():
            assert proc.poll() is None, log.read_text()
            assert time.time() < deadline, log.read_text()
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = log.read_text()
    assert rc == 0, text
    assert "will checkpoint and stop" in text and "stopping on signal" in text
    stopped = int(text.split("stopping on signal")[1].split("at step")[1].split(";")[0])
    ck = Checkpointer(out)
    assert ck.latest == stopped >= 1
    assert ck.load(stopped)[0]["step"] == stopped
    result = train(parse_args(_argv(cache, out, "--max_steps", str(stopped + 2),
                                    "--num_epochs", "100",
                                    "--resume_from_checkpoint", "latest")))
    assert result["global_step"] == stopped + 2 and "preempted_at" not in result
    assert os.path.isdir(out / "checkpoints" / str(stopped + 2) / "state")
