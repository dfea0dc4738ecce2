"""A run's result line and its inputs: the keys the benchmark prints,
its refusal without a card, and inputs that depend on the seed alone."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import registry, run
from portbench.drivers import serve, train
from portbench.tests.conftest import tiny_cell, tiny_run
from portbench.weights import dit_weights

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", ["f_lite_7b.t2i_1024", "f_lite_7b.train_512"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(name, trace):
    cell = tiny_cell(name)
    record = tiny_run(cell, trace=trace)
    out = run.result(cell, record, trace, torch.device("cpu"))
    keys = list(out)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert set(keys) <= set(KEYS) | {"breakdown", "checks"}
    assert out["attempted"] >= 1 and out["failed"] == 0
    want = {m["name"]: m["unit"] for m in (cell.per_layer if trace else cell.end_to_end)}
    for name_, m in out["metrics"].items():
        assert m["unit"] == want[name_] and isinstance(m["value"], float)
    if not trace:
        assert set(out["metrics"]) == set(want)
    else:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(out["checks"]) == set(cell.limits)
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_no_card_no_result(capsys):
    """Without enough CUDA devices the run exits non-zero and prints no
    result (this machine has none)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "f_lite_7b.t2i_1024", "--seed", "3",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_requests_depend_on_the_seed_alone():
    cell = registry.cell("f_lite_7b.t2i_1024")
    cfg, traffic = tiny_cell("f_lite_7b.t2i_1024").config, tiny_cell(cell.name).traffic
    seed = 2**31 + 12345
    dev = torch.device("cpu")

    def draw(s, i):
        return serve.draw_request(cfg, traffic, s, i, serve.text_lengths(traffic, s), dev)

    a, b, c = draw(seed, 3), draw(seed, 3), draw(seed + 1, 3)
    assert (a["embeds"] == b["embeds"]).all() and torch.equal(a["latents"], b["latents"])
    assert not (a["embeds"] == c["embeds"]).all()
    assert sorted(serve.text_lengths(traffic, seed)) == sorted(traffic["text_lengths"])
    assert serve.text_lengths(traffic, seed) != serve.text_lengths(traffic, seed + 2)


def test_batches_and_weights_depend_on_the_seed_alone():
    traffic = tiny_cell("f_lite_7b.train_512").traffic
    cfg = tiny_cell("f_lite_7b.train_512").config
    dev = torch.device("cpu")
    seed = 2**31 + 99
    lengths = train.text_lengths(traffic, seed)
    a = train.draw_batch(cfg, traffic, seed, 4, lengths, dev)
    b = train.draw_batch(cfg, traffic, seed, 4, lengths, dev)
    c = train.draw_batch(cfg, traffic, seed, 5, lengths, dev)
    assert all(torch.equal(a[k], b[k]) for k in ("latents", "context", "t", "noise"))
    assert not torch.equal(a["latents"], c["latents"])
    w1, w2 = dit_weights(cfg, seed, dev, torch.float32), dit_weights(cfg, seed, dev, torch.float32)
    w3 = dit_weights(cfg, seed + 1, dev, torch.float32)
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert not torch.equal(w1["final_proj.weight"], w3["final_proj.weight"])
