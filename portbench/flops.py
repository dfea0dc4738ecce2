"""Operations, bytes and least times from shapes, against one NVIDIA H100
SXM's published peaks (data sheet, dense, at its 700 W limit).

Every count here is of the mathematics a configuration asks for at the
given shapes, never of what a kernel happens to do: attention over the
real keys, each input byte read once and each output byte written once.
"""

from __future__ import annotations

from portbench.weights import QUANT_TARGETS, has_cross_attn

PEAK_FLOPS = {"bfloat16": 989e12, "int8": 1979e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def attention_fwd_bound_s(b, h, lq, lk, d, kv_lens, item=2) -> float:
    """Kernel #1: 4 H Lq D flops for each real key of each row; q and the
    output over every row, k and v over the real keys."""
    keys = sum(kv_lens) if kv_lens is not None else b * lk
    flops = 4.0 * h * lq * d * keys
    nbytes = item * (2 * b * h * lq * d + 2 * h * d * keys)
    return max(flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES)


def attention_bwd_bound_s(b, h, lq, lk, d, kv_lens, item=2) -> float:
    """Kernels #2 and #3 together: 10 H Lq D flops a real key, the
    backward's five products (S = Q K^T recomputed once, dP = dO V^T,
    dV = P^T dO, dQ = dS K, dK = dS^T Q; the kernels' split recomputes S
    and dP in both, 14, which is not counted); q, dO, O and dq over every
    row, k and v over the real keys, the fp32 lse and delta, dk and dv
    over every key."""
    keys = sum(kv_lens) if kv_lens is not None else b * lk
    q_rows = b * h * lq * d * item
    kv_real = h * keys * d * item
    kv_all = b * h * lk * d * item
    stats = b * h * lq * 4
    nbytes = 3 * q_rows + 2 * kv_real + 2 * stats + q_rows + 2 * kv_all
    return max(10.0 * h * lq * d * keys / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES)


def int8_bound_s(m, n, k, item=2) -> tuple[float, float]:
    """(quantize, product): kernel #5 reads x once and writes x8 and the
    row scales; kernel #6 takes 2 M N K int8 operations or its bytes (x8,
    w8 and both scales read once, the output written once)."""
    quantize = (m * k * item + m * k + 4 * m) / PEAK_BYTES
    product = max(2.0 * m * n * k / PEAK_FLOPS["int8"],
                  (m * k + n * k + 4 * (m + n) + m * n * item) / PEAK_BYTES)
    return quantize, product


def dit_products(cfg: dict, batch: int, grid: tuple,
                 text_rows: int) -> list[tuple[str, int, int, int]]:
    """Every weight product of one DiT forward: (layer, M, N, K), with
    `batch` rows, a (gh, gw) patch grid and `text_rows` context rows."""
    d, c, p = cfg["hidden_size"], cfg["in_channels"], cfg["patch_size"]
    inter = int(d * cfg["mlp_ratio"])
    tokens = batch * (grid[0] * grid[1] + cfg["n_register_tokens"])
    patches = batch * grid[0] * grid[1]
    ctx = batch * text_rows
    out = [("context_proj", ctx, d, cfg["cross_attn_input_size"]),
           ("patch_embed", patches, d, p * p * c),
           ("time_embed.0", batch, 4 * d, d), ("time_embed.2", batch, d, 4 * d),
           ("adaLN_modulation", batch, 9 * d, d),
           ("final_modulation", batch, 2 * d, d), ("final_proj", patches, p * p * c, d)]
    for i in range(cfg["depth"]):
        out += [("qkv", tokens, 3 * d, d), ("proj", tokens, d, d)]
        if has_cross_attn(cfg, i):
            out += [("q", tokens, d, d), ("context_kv", ctx, 2 * d, d), ("proj", tokens, d, d)]
        out += [("gate_proj", tokens, inter, d), ("up_proj", tokens, inter, d),
                ("down_proj", tokens, d, inter)]
    return out


def dit_attentions(cfg: dict, batch: int, grid: tuple, text_rows: int,
                   key_counts: list) -> list[tuple]:
    """(b, h, lq, lk, d, kv_lens) of every attention of one DiT forward:
    self-attention over every token, cross-attention over each row's
    `key_counts` real context rows."""
    h = cfg["num_heads"]
    hd = cfg["hidden_size"] // h
    n = grid[0] * grid[1] + cfg["n_register_tokens"]
    out = []
    for i in range(cfg["depth"]):
        out.append((batch, h, n, n, hd, None))
        if has_cross_attn(cfg, i):
            out.append((batch, h, n, text_rows, hd, list(key_counts)))
    return out


def attention_flops(b, h, lq, lk, d, kv_lens) -> float:
    keys = sum(kv_lens) if kv_lens is not None else b * lk
    return 4.0 * h * lq * d * keys


def dit_forward_flops(cfg, batch, grid, text_rows, key_counts, quantized=False) -> dict:
    """Flops of one forward by the precision they run in: the int8
    projections apart where `quantized`."""
    out = {"bfloat16": 0.0, "int8": 0.0}
    for name, m, n, k in dit_products(cfg, batch, grid, text_rows):
        out["int8" if quantized and name in QUANT_TARGETS else "bfloat16"] += 2.0 * m * n * k
    out["bfloat16"] += sum(attention_flops(*a) for a in
                           dit_attentions(cfg, batch, grid, text_rows, key_counts))
    return out


def vae_decode_flops(vae: dict, lh: int, lw: int, batch: int = 1) -> float:
    """The decoder's convolutions, the middle attention's products and
    its linear layers (float32)."""
    chans = list(reversed(vae["block_out_channels"]))
    flops = 0.0
    h, w = lh, lw

    def conv(cin, cout, ksize=3):
        return 2.0 * cin * cout * ksize * ksize * h * w * batch

    def resnet(cin, cout):
        f = conv(cin, cout) + conv(cout, cout)
        return f + (conv(cin, cout, 1) if cin != cout else 0.0)

    top = chans[0]
    flops += conv(vae["latent_channels"], top) + 2 * resnet(top, top)
    flops += batch * (4 * 2.0 * h * w * top * top + 2 * 2.0 * (h * w) ** 2 * top)
    for i, ch in enumerate(chans):
        cin = chans[max(i - 1, 0)]
        for j in range(vae["layers_per_block"] + 1):
            flops += resnet(cin if j == 0 else ch, ch)
        if i < len(chans) - 1:
            h, w = 2 * h, 2 * w
            flops += conv(ch, ch)
    flops += conv(chans[-1], vae["out_channels"])
    return flops


def least_seconds(flops_by_precision: dict) -> float:
    return sum(f / PEAK_FLOPS[p] for p, f in flops_by_precision.items())
