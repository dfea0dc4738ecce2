"""`correct` comes out false when the timed path is broken underneath
the harness, once for each fault a cell can have (a tiny cell on the CPU,
held to the cell's own limits; its sound run passes them):
- serving: a step that returns its state unchanged, and an image altered
  where the pipeline produces it (a batch of one has no half to drop, one
  chip no exchange);
- training: a step that leaves its state unchanged, and half of each
  batch left out with the mean taken over the rest (one chip: no
  exchange)."""

from __future__ import annotations

import pytest
import torch

from portbench import control, registry
from portbench.tests.conftest import tiny_cell, tiny_run

SERVE, INT8, TRAIN = "f_lite_7b.t2i_1024", "f_lite_10b.t2i_1024_int8", "f_lite_7b.train_512"


@pytest.mark.parametrize("name", [SERVE, TRAIN])
def test_a_sound_run_is_correct(name):
    record = tiny_run(tiny_cell(name))
    assert record["correct"], record["checks"]


def test_serving_state_unchanged(monkeypatch):
    import f_lite_tpu_torch.sampling.euler as euler

    real = euler.denoise_schedule

    def unchanged(dit, latents, *args, **kw):
        _, carry = real(dit, latents, *args, **kw)
        return latents.float(), carry

    monkeypatch.setattr(euler, "denoise_schedule", unchanged)
    record = tiny_run(tiny_cell(SERVE))
    assert not record["correct"]
    assert record["checks"]["step_err"]["value"] > record["checks"]["step_err"]["limit"]


def test_serving_image_altered(monkeypatch):
    import f_lite_tpu_torch.pipeline as pipeline

    real = pipeline.to_uint8

    def altered(images):
        out = real(images)
        out[:, : out.shape[1] // 4] ^= 8  # one pixel row in four, off by 8 levels
        return out

    monkeypatch.setattr(pipeline, "to_uint8", altered)
    record = tiny_run(tiny_cell(SERVE))
    assert not record["correct"]
    assert record["checks"]["pixel_mad"]["value"] > record["checks"]["pixel_mad"]["limit"]


def test_training_state_unchanged(monkeypatch):
    import f_lite_tpu_torch.train.optim as optim

    def no_update(self, grads):
        return optim.global_norm(list(grads), self.norm_group)

    monkeypatch.setattr(optim.AdamW, "step", no_update)
    record = tiny_run(tiny_cell(TRAIN))
    assert not record["correct"]
    assert record["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_training_half_batch(monkeypatch):
    import f_lite_tpu_torch.train.step as step

    monkeypatch.setattr(step, "flow_matching_loss", step.flow_matching_loss)
    control.plant_half_batch()
    record = tiny_run(tiny_cell(TRAIN))
    assert not record["correct"]


CONTROLS = [(cell, name) for cell in (SERVE, INT8, TRAIN)
            for name in registry.cell(cell).traffic["controls"]]


@pytest.mark.parametrize("name, control_name", CONTROLS)
def test_the_control_fails(name, control_name):
    """Each of the mix's controls (the program's own int8 path in the bf16
    cell, the reference in fp8 or int4 in the program's place) comes out
    not correct at the cell's own limits, where the program reads correct
    on the same window."""
    cell = tiny_cell(name)
    sound = tiny_run(cell, short=True)
    assert sound["correct"], sound["checks"]
    record = tiny_run(cell, short=True, control=cell.traffic["controls"][control_name])
    assert record["correct"] is False, record["checks"]
    assert all(torch.isfinite(torch.tensor(c["value"])) for c in record["checks"].values())
