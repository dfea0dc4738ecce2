"""The operation and byte counts of `portbench/flops.py` against hand
counts for the 7B at 1024 px (a CFG pair: 2 rows of 64 x 64 patches and
16 registers, 4112 tokens; 128 text rows, 72 real)."""

from __future__ import annotations

import json

import pytest

from portbench import flops, registry

CFG = json.loads((registry.ROOT / "portbench/configs/f_lite_7b.json").read_text())
D, F, T, CTX = 2560, 10240, 2 * 4112, 2 * 128


def test_forward_products():
    prods = flops.dit_products(CFG, 2, (64, 64), 128)
    # per block: qkv, proj, gate, up, down; 16 cross blocks: q, context_kv, proj
    block = 2 * T * (3 * D * D + D * D + 2 * F * D + D * F)
    cross = 16 * 2 * (2 * T * D * D + CTX * 2 * D * D)
    outer = 2 * (CTX * D * 4096 + 2 * 4096 * D * 64 + 2 * 4 * D * D * 2 + 2 * 9 * D * D
                 + 2 * 2 * D * D + 2 * 4096 * 64 * D)
    assert sum(2 * m * n * k for _, m, n, k in prods) == pytest.approx(
        40 * block + cross + outer)
    assert len([p for p in prods if p[0] in ("qkv", "proj", "q", "context_kv", "gate_proj",
                                              "up_proj", "down_proj")]) == 248


def test_attention_flops_and_bounds():
    att = flops.dit_attentions(CFG, 2, (64, 64), 128, [72, 72])
    assert len(att) == 56
    self_att = 4 * 10 * 4112 * 256 * (2 * 4112)
    cross_att = 4 * 10 * 4112 * 256 * 144
    assert sum(flops.attention_flops(*a) for a in att) == 40 * self_att + 16 * cross_att
    # self-attention is bound by its operations: 3.46e11 / 989e12 = 0.350 ms
    assert flops.attention_fwd_bound_s(*att[0]) == pytest.approx(self_att / 989e12)
    assert flops.attention_fwd_bound_s(*att[0]) * 1e3 == pytest.approx(0.3501, abs=1e-4)
    # cross-attention by its bytes: q and out over every row, k and v over the real keys
    nbytes = 2 * (2 * 2 * 10 * 4112 * 256 + 2 * 10 * 256 * 144)
    assert flops.attention_fwd_bound_s(*att[1]) == pytest.approx(nbytes / 3.35e12)


def test_backward_and_int8_bounds():
    b, h, lq, d = 4, 10, 1040, 256
    assert flops.attention_bwd_bound_s(b, h, lq, lq, d, None) == pytest.approx(
        10 * h * lq * d * b * lq / 989e12)
    q, g = flops.int8_bound_s(8224, 7680, 2560)
    assert q == pytest.approx((8224 * 2560 * 3 + 4 * 8224) / 3.35e12)
    assert g == pytest.approx(2 * 8224 * 7680 * 2560 / 1979e12)


def test_vae_decode_flops():
    """Hand count of the Flux decoder at 128 x 128 latents: 3x3 convs at
    each resolution, the middle attention's four linears and two products."""
    def conv(cin, cout, hw, k=3):
        return 2 * cin * cout * k * k * hw * hw

    total = conv(16, 512, 128) + 4 * conv(512, 512, 128)
    total += 4 * 2 * 128 * 128 * 512 * 512 + 2 * 2 * (128 * 128) ** 2 * 512
    total += 6 * conv(512, 512, 128) + conv(512, 512, 256)
    total += 6 * conv(512, 512, 256) + conv(512, 512, 512)
    total += conv(512, 256, 512) + 5 * conv(256, 256, 512) + conv(512, 256, 512, 1)
    total += conv(256, 256, 1024)
    total += conv(256, 128, 1024) + 5 * conv(128, 128, 1024) + conv(256, 128, 1024, 1)
    total += conv(128, 3, 1024)
    assert flops.vae_decode_flops(CFG["vae"], 128, 128) == pytest.approx(total)
