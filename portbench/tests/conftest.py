"""Tiny versions of the benchmark's cells for the CPU: the cells' mixes
and limits at a toy width, depth and image size, run through the same
drivers with the port's plain (CPU) paths."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import registry
from portbench.run import RunContext, run_cell

TINY = dict(in_channels=16, patch_size=2, hidden_size=256, depth=9, num_heads=2,
            mlp_ratio=4.0, cross_attn_input_size=32, train_bias_and_rms=False,
            use_rope=True, rope_base=10000.0, dynamic_softmax_temperature=False,
            residual_v=True, adaln_mode="shared", cross_attn_period=4,
            cross_attn_first_n=2, n_register_tokens=4,
            vae=dict(in_channels=3, out_channels=3, latent_channels=16,
                     block_out_channels=[8, 16], layers_per_block=1, norm_num_groups=4,
                     scaling_factor=0.3611, shift_factor=0.1159))


def tiny_cell(name: str):
    """Cell `name` with the tiny configuration and its mix cut to size."""
    cell = registry.cell(name)
    cell.config = dict(TINY)
    if cell.traffic["driver"] == "train":
        cell.traffic = dict(cell.traffic, batch=2, resolution=32, latent_scale=2,
                            text_rows=8, text_lengths=[2, 4, 6, 8],
                            trace={"first": 1, "steps": 2})
    else:
        cell.traffic = dict(cell.traffic, height=32, width=32, steps=5, text_rows=8,
                            text_lengths=[2, 4, 6, 8], trace={"steps": 2})
    return cell


def tiny_run(cell, seed=7, seconds=0.5, trace=False, control=None, short=False) -> dict:
    """One run of a tiny cell on the CPU; `short`: the readings' window (two
    requests, or no step after the checked ones)."""
    serve = cell.traffic["driver"] == "serve"
    ctx = RunContext(cell.config, cell.traffic, seed, seconds, trace, torch.device("cpu"),
                     time.time(), control=control,
                     requests=2 if short and serve else None,
                     steps=0 if short and not serve else None)
    return run_cell(cell, ctx)


@pytest.fixture
def cuda_device():
    """The card, where there is one (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
