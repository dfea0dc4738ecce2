"""`portbench/spans.py`: the join of program spans with a profiled window's
kernels and idle gaps on synthetic spans, launches and kernels, the
readings built on it, and the probe end to end in the tiny cells on the
CPU (where no device operation is recorded, so only the host readings
have numbers)."""

from __future__ import annotations

import pytest
import torch

from f_lite_tpu_torch.utils.trace import Span
from portbench import spans as sp
from portbench.tests.conftest import tiny_cell
from portbench.trace import kernel_class


def _spans():
    rows = [(1, "train.step", 0, 1000, None, 1), (2, "train.loss", 10, 300, 1, 1),
            (3, "op.rms_norm", 50, 80, 2, 1), (4, "train.backward", 310, 800, 1, 1),
            # the autograd engine's thread: a block recomputed under the backward
            (5, "dit.block", 400, 500, 4, 2), (6, "op.swiglu", 420, 440, 5, 2),
            (7, "optim.update", 810, 990, 1, 1)]
    return [Span(i, name, {}, parent, 1, thread, start, end)
            for i, name, start, end, parent, thread in rows]


# (start, end, correlation, name) on the device; launches by correlation
OPS = [(100, 150, 11, "rms"), (160, 170, 12, "gemm_kernel"), (430, 460, 13, "silu"),
       (470, 480, 14, "bwd"), (900, 950, 15, "adam"), (955, 960, 16, "nolaunch")]
LAUNCHES = {11: (60, 62), 12: (200, 203), 13: (425, 426), 14: (600, 601), 15: (850, 852)}


def test_attribute_puts_kernels_and_gaps_down_to_spans():
    spans = _spans()
    got = sp.attribute(OPS, LAUNCHES, spans, main_thread=1, window=(0, 1000))
    names = {s.id: s.name for s in spans}
    assert [(d, names.get(s), n) for d, s, n in got["kernels"]] == [
        (50, "op.rms_norm", "rms"), (10, "train.loss", "gemm_kernel"),
        (30, "op.swiglu", "silu"), (10, "train.backward", "bwd"),
        (50, "optim.update", "adam"), (5, "optim.update", "nolaunch")]
    # gaps go to the recording thread's innermost span at the ending launch
    assert [(d, names.get(s)) for d, s in got["gaps"]] == [
        (100, "op.rms_norm"), (10, "train.loss"), (260, "train.backward"),
        (10, "train.backward"), (420, "optim.update"), (5, "optim.update"), (40, None)]
    assert sum(d for d, _ in got["gaps"]) + sum(e - s for s, e, *_ in OPS) == 1000
    assert sp.busy_ms(OPS) == pytest.approx(155e-6)


def test_readings_of_the_join():
    spans = _spans()
    index = sp.Index(spans)
    joined = sp.attribute(OPS, LAUNCHES, spans, main_thread=1, window=(0, 1000))
    assert index.lineage(6) == ["op.swiglu", "dit.block", "train.backward", "train.step"]
    assert index.lineage(None) == []
    # two steps' worth: each reading per step
    parts = sp.idle_parts(joined, index, per=2)
    assert parts == pytest.approx({"forward": 55e-6, "backward": 135e-6,
                                   "optimizer": 212.5e-6, "step_other": 0.0,
                                   "outside": 20e-6})
    ew = sp.op_ms(joined, index, "train.step", 1, kernel_class)
    assert ew["op_ms"]["op.rms_norm"] == pytest.approx(50e-6)
    assert ew["op_ms"]["op.swiglu"] == pytest.approx(30e-6)
    assert ew["op_ms"]["block.adaln"] == 0.0
    # "gemm_kernel" is a matmul; the rest are the elementwise class "other"
    assert ew["other_ms"] == pytest.approx(145e-6)
    assert ew["other_in_ops_ms"] == pytest.approx(80e-6)
    assert ew["rest_by_kernel"] == pytest.approx({"adam": 50e-6, "bwd": 10e-6,
                                                  "nolaunch": 5e-6})
    assert sp.device_ms_under(joined, index, "train.backward") == pytest.approx(40e-6)
    assert sp.host_ms(spans, "train.loss") == [pytest.approx(290e-6)]
    window = sp.Profiled(torch.device("cpu"))
    window.start_ns = 0
    assert window.first_gap(OPS, joined, index) == {
        "ms": pytest.approx(100e-6), "span": "op.rms_norm < train.loss < train.step"}


@pytest.mark.parametrize("name", ["f_lite_7b.t2i_1024", "f_lite_7b.train_512"])
def test_the_probe_runs_a_tiny_cell(name):
    cell = tiny_cell(name)
    probe = sp.serve if cell.traffic["driver"] == "serve" else sp.train
    out = probe(cell, 2**31 + 5, torch.device("cpu"), pairs=1)
    assert out["clock"] is None  # needs the card
    m = out["metrics"]
    if probe is sp.serve:
        assert set(m) == {"norm_ms.serve", "adaln_ms.serve", "rope_ms.serve",
                          "swiglu_ms.serve", "step_host_ms.serve",
                          "prepare_host_ms.spans", "return_idle_ms.spans",
                          "vae_decode_ms.spans"}
        assert m["step_host_ms.serve"] > 0 and m["prepare_host_ms.spans"] > 0
        assert len(out["request_s"]["open"]) == len(out["request_s"]["closed"]) == 1
        # one request's spans: the pipeline's five, a step and its DiT's
        assert out["spans_a_request"] > 5 * cell.traffic["steps"]
    else:
        assert set(m) == {"step_host_ms.train", "forward_idle_ms.train",
                          "backward_idle_ms.train", "optimizer_idle_ms.train"}
        assert m["step_host_ms.train"] > 0
        assert [r["open"] for r in out["steps"]] == [False, True]
    assert all(v is None for k, v in m.items() if "host" not in k)  # no device trace
