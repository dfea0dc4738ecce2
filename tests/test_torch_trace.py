"""The port's spans and counters (`f_lite_tpu_torch/utils/trace.py`) on the
CPU: spans nest by thread, with the parent and root they should have (the
recompute of a checkpointed block under the backward), nothing is kept
without a recording, the kernels' launch counters are the registry's, the
spans make a Chrome-trace track, and recording changes no image and no
trained parameter. The join of spans with a profiler's kernels is the
benchmark's (`portbench/tests/test_portbench_spans.py`)."""

import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from f_lite_tpu_torch.models.dit import DiT, DiTConfig
from f_lite_tpu_torch.ops.cuda import flash_attention as fa
from f_lite_tpu_torch.ops.cuda import flash_variants as fv
from f_lite_tpu_torch.ops.cuda import int8_gemm as ig
from f_lite_tpu_torch.ops import norms
from f_lite_tpu_torch.ops.cuda import rms_norm as rn
from f_lite_tpu_torch.pipeline import FLitePipeline
from f_lite_tpu_torch.text.encoder import ZeroTextEncoder
from f_lite_tpu_torch.train.loss import LossDraws
from f_lite_tpu_torch.train.optim import build_optimizer
from f_lite_tpu_torch.train.step import TrainState, train_step
from f_lite_tpu_torch.utils import trace

FIXTURE = str(Path(__file__).resolve().parent.parent / "artifacts" / "fixture_run" / "pipeline")
CFG = DiTConfig(in_channels=4, hidden_size=64, depth=3, num_heads=2, mlp_ratio=2.0,
                cross_attn_input_size=16, residual_v=True, cross_attn_first_n=1,
                cross_attn_period=2, n_register_tokens=2, gradient_checkpoint=True,
                gradient_checkpoint_from=1)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(seed=0):
    model = DiT(CFG)
    model.init_weights(torch.Generator().manual_seed(seed))
    with torch.no_grad():  # non-zero heads, so that every block moves
        for name, p in model.named_parameters():
            if "adaLN" in name or "final" in name:
                p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(len(name)))
    model.train()
    return TrainState(model, build_optimizer(list(model.parameters())))


def _batch(seed=1, b=2):
    g = torch.Generator().manual_seed(seed)
    lat = torch.randn(b, 8, 8, 4, generator=g)
    ctx = torch.randn(b, 4, 16, generator=g)
    mask = torch.arange(4)[None] < torch.tensor([[2], [4]])
    draws = LossDraws(torch.tensor([False, True]), torch.rand(b, generator=g),
                      torch.randn(b, 8, 8, 4, generator=g), None)
    return lat, ctx, mask, draws


def _lineage(rec):
    """Span id -> the names from it up to its root."""
    by_id = {s.id: s for s in rec.spans}
    out = {}
    for s in rec.spans:
        names, p = [], s
        while p is not None:
            names.append(p.name)
            p = by_id.get(p.parent)
        out[s.id] = names
    return out


def test_spans_nest_by_thread_with_parents_roots_and_epoch_times():
    before = time.time_ns()
    seen = {}

    def worker():
        with trace.span("worker.outer"):
            seen["thread"] = threading.get_native_id()
            with trace.span("worker.inner", index=3):
                pass

    with trace.recording() as rec:
        with trace.span("main.root"):
            with trace.span("main.child"):
                with trace.span("main.before"):
                    pass
                t = threading.Thread(target=worker)
                t.start()
                t.join(timeout=30)
            assert not t.is_alive()
        with trace.span("main.second"):
            pass
    after = time.time_ns()
    by = {s.name: s for s in rec.spans}
    assert set(by) == {"main.root", "main.child", "main.before", "worker.outer",
                       "worker.inner", "main.second"}
    root, child = by["main.root"], by["main.child"]
    assert root.parent is None and root.root == root.id
    assert child.parent == root.id and child.root == root.id
    # a thread with nothing open hangs its spans under the span open then on
    # the recording's thread (not under one that had closed)
    assert by["main.before"].parent == child.id
    assert by["worker.outer"].parent == child.id and by["worker.outer"].root == root.id
    assert by["worker.inner"].parent == by["worker.outer"].id
    assert by["worker.inner"].attrs == {"index": 3}
    assert by["worker.outer"].thread == seen["thread"] != root.thread == rec.thread
    assert by["main.second"].root == by["main.second"].id  # a tree of its own
    for s in rec.spans:
        assert before <= s.start_ns <= s.end_ns <= after
    assert child.start_ns >= root.start_ns and child.end_ns <= root.end_ns
    assert _lineage(rec)[by["worker.inner"].id] == ["worker.inner", "worker.outer",
                                                    "main.child", "main.root"]


def test_nothing_is_kept_without_a_recording():
    assert trace.span("a") is trace.span("b")  # the shared no-op
    with trace.span("unrecorded") as s:
        assert s is None
    with trace.recording() as rec:
        with pytest.raises(RuntimeError, match="already open"):
            with trace.recording():
                pass
    assert rec.spans == []
    with trace.span("after"):
        pass
    assert rec.spans == []


def test_launch_counters_are_the_registry_objects():
    reg = trace.COUNTERS
    assert fa.LAUNCHES is reg["flash_fwd"] is trace.counter("flash_fwd")
    assert fa.DQ_LAUNCHES is reg["flash_bwd_dq"] and fa.DKV_LAUNCHES is reg["flash_bwd_dkv"]
    assert ig.QUANTIZE_LAUNCHES is reg["int8_quantize"] and ig.GEMM_LAUNCHES is reg["int8_gemm"]
    assert fv.LAUNCHES is reg["flash_variants"]


def test_rms_norm_counters_are_registry_objects_untouched_on_the_cpu():
    """The RMSNorm kernel's counters live in the registry; the CPU path
    (the plain twin) launches nothing, so neither moves there."""
    reg = trace.COUNTERS
    assert rn.LAUNCHES is reg["rms_norm"] and rn.BWD_LAUNCHES is reg["rms_norm_bwd"]
    before = (rn.LAUNCHES.count, rn.BWD_LAUNCHES.count)
    x = torch.randn(3, 8, requires_grad=True)
    norms.rms_norm(x, torch.ones(8)).sum().backward()
    assert (rn.LAUNCHES.count, rn.BWD_LAUNCHES.count) == before


def test_waits_counts_seconds_and_spans_each_wait():
    clock = trace.counter("test.waits")
    before = clock.count
    with trace.recording() as rec:
        got = list(trace.waits(iter([1, 2, 3]), "test.waits"))
    assert got == [1, 2, 3] and clock.count > before
    assert [s.name for s in rec.spans] == ["test.waits"] * 4  # the last finds the end


def test_train_step_spans_and_recompute_and_equal_parameters():
    lat, ctx, mask, draws = _batch()
    plain, traced = _state(), _state()
    train_step(plain, lat, ctx, mask, draws=draws)
    with trace.recording() as rec:
        train_step(traced, lat, ctx, mask, draws=draws)
    for a, b in zip(plain.model.parameters(), traced.model.parameters()):
        assert torch.equal(a, b)
    lin = _lineage(rec)
    names = [s.name for s in rec.spans]
    for n in ("train.step", "train.loss", "train.backward", "optim.norm", "optim.clip",
              "optim.update", "dit.embed", "dit.head", "block.adaln", "op.rms_norm",
              "op.rope", "op.swiglu"):
        assert n in names, n
    blocks = [s for s in rec.spans if s.name == "dit.block"]
    # three blocks in the forward, two again in the backward (checkpointed from 1)
    fwd = sorted(s.attrs["index"] for s in blocks if "train.loss" in lin[s.id])
    again = sorted(s.attrs["index"] for s in blocks if "train.backward" in lin[s.id])
    assert fwd == [0, 1, 2] and again == [1, 2]
    assert len({s.root for s in rec.spans}) == 1
    step = next(s for s in rec.spans if s.name == "train.step")
    assert step.parent is None and all(lin[s.id][-1] == "train.step" for s in rec.spans)
    # QK-norms and the blocks' norms under a block, the context and final norms outside
    assert all(("dit.block" in lin[s.id]) or ("dit.embed" in lin[s.id])
               or ("dit.head" in lin[s.id]) for s in rec.spans if s.name == "op.rms_norm")


def test_pipeline_images_equal_with_recording_on_and_off():
    pipe = FLitePipeline.from_pretrained(FIXTURE, dtype=torch.float32, device="cpu")
    embeds, mask = ZeroTextEncoder(64, seq_len=8).encode(["a red circle"])
    latents = np.random.RandomState(0).randn(1, 32, 32, 3).astype(np.float32)
    kw = dict(prompt_embeds=embeds, context_mask=mask, latents=latents, height=32,
              width=32, num_inference_steps=3, guidance_scale=6.0)
    plain = pipe(**kw).images
    with trace.recording() as rec:
        traced = pipe(**kw).images
    np.testing.assert_array_equal(plain, traced)
    lin = _lineage(rec)
    req = [s for s in rec.spans if s.name == "pipeline.request"]
    assert len(req) == 1
    kids = sorted((s for s in rec.spans if s.parent == req[0].id), key=lambda s: s.start_ns)
    assert [s.name for s in kids] == ["pipeline.prepare", "pipeline.denoise",
                                      "pipeline.decode", "pipeline.return"]
    steps = [s for s in rec.spans if s.name == "sample.step"]
    assert [s.attrs["index"] for s in steps] == [0, 1, 2]
    assert all(lin[s.id][1:] == ["pipeline.denoise", "pipeline.request"] for s in steps)
    assert {s.attrs["index"] for s in rec.spans if s.name == "dit.block"} == set(range(6))


def test_chrome_events_are_a_track_of_their_own():
    rec = trace.Recording()
    rec.spans.append(trace.Span(1, "train.step", {}, None, 1, 1, 5_000, 9_000))
    ev = trace.chrome_events(rec, base_ns=1_000)
    assert ev == [{"ph": "X", "cat": "span", "name": "train.step", "pid": "program spans",
                   "tid": 1, "ts": 4.0, "dur": 4.0,
                   "args": {"id": 1, "parent": None, "root": 1}}]
    json.dumps(ev)

