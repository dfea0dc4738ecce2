"""Shared reductions of a run's record for the per-layer metrics
(`portbench/metrics/<name>.py`): the shapes of the launches in the
profiled window, from the configuration and the requests or batches the
drivers recorded, and the program's counters that must agree with them."""

from __future__ import annotations

from portbench import flops
from portbench.model import spatial_scale
from portbench.weights import QUANT_TARGETS


def mean(xs) -> float | None:
    xs = list(xs)
    return sum(xs) / len(xs) if xs else None


def unprofiled(rows: list) -> list:
    """The rows (requests or steps) outside the profiled window; all of
    them where every one was profiled."""
    return [r for r in rows if not r["profiled"]] or rows


def device_s(record: dict, phase: str, *classes) -> float | None:
    """Device seconds of `classes` in a profiled phase; None without a
    profile or where none of them ran."""
    prof = record.get("profile")
    if not prof or phase not in prof["phases"]:
        return None
    s = sum(prof["phases"][phase].get(c, 0.0) for c in classes)
    return s or None


def serve_grid(record: dict) -> tuple:
    cfg, traffic = record["model"]["config"], record["model"]["traffic"]
    s = spatial_scale(cfg["vae"]) * cfg["patch_size"]
    return traffic["height"] // s, traffic["width"] // s


def serve_forward(record: dict, text_len: int):
    """(attentions, int8 products) of one CFG forward of a request with
    `text_len` real text rows (the unconditional row has the same mask)."""
    cfg, traffic = record["model"]["config"], record["model"]["traffic"]
    grid, rows = serve_grid(record), traffic["text_rows"]
    att = flops.dit_attentions(cfg, 2, grid, rows, [text_len, text_len])
    prods = [(m, n, k) for name, m, n, k in flops.dit_products(cfg, 2, grid, rows)
             if name in QUANT_TARGETS]
    return att, prods


def serve_profiled(record: dict):
    """(the profiled request's span, the denoise steps profiled), or None."""
    rows = [r for r in record.get("spans", []) if r["profiled"]]
    if not rows or "profile" not in record:
        return None
    return rows[0], record["model"]["traffic"]["trace"]["steps"]


def serve_least_s(record: dict, text_len: int) -> float:
    """The least seconds of one request: every step's products and
    attention at its precision's peak, and the fp32 decode."""
    cfg, traffic = record["model"]["config"], record["model"]["traffic"]
    fwd = flops.dit_forward_flops(cfg, 2, serve_grid(record), traffic["text_rows"],
                                  [text_len, text_len], record["model"]["quantized"])
    s = spatial_scale(cfg["vae"])
    vae = flops.vae_decode_flops(cfg["vae"], traffic["height"] // s, traffic["width"] // s)
    return traffic["steps"] * flops.least_seconds(fwd) + vae / flops.PEAK_FLOPS["float32"]


def train_step_attentions(record: dict, row: dict) -> list:
    """The attentions of one training step's forward: a dropped caption's
    row has every text row real."""
    cfg, traffic = record["model"]["config"], record["model"]["traffic"]
    side = traffic["resolution"] // traffic["latent_scale"] // cfg["patch_size"]
    rows = traffic["text_rows"]
    keys = [rows if d else n for n, d in zip(row["lengths"], row["drop"])]
    return flops.dit_attentions(cfg, traffic["batch"], (side, side), rows, keys)


def train_forward_flops(record: dict, row: dict) -> float:
    cfg, traffic = record["model"]["config"], record["model"]["traffic"]
    side = traffic["resolution"] // traffic["latent_scale"] // cfg["patch_size"]
    rows = traffic["text_rows"]
    keys = [rows if d else n for n, d in zip(row["lengths"], row["drop"])]
    return sum(flops.dit_forward_flops(cfg, traffic["batch"], (side, side), rows,
                                       keys).values())


def idle_percent(record: dict) -> float | None:
    prof = record.get("profile")
    if not prof or not prof["window_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
