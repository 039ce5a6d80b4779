"""The comparison that decides `correct`, held to the faults a training
cell can have: the harness runs its whole path on the CPU at a small size
(all but its look for a card), with the program's step broken underneath,
and `correct` must come out false with the cells' own limits. A cell runs
on one card, so there is no exchange between cards to leave out."""

import pytest
import torch

from portbench import harness
from portbench.tests.small import CELLS, CONFIG_OF, SmallSpec


def _step_module(cell):
    from imagegeneration_tpu_torch.train import cyclegan_step, sndcgan_step
    return sndcgan_step if cell == "sndcgan-b128" else cyclegan_step


def _models_module(cell):
    from imagegeneration_tpu_torch.models import cyclegan, sndcgan
    return sndcgan if cell == "sndcgan-b128" else cyclegan


def plant_frozen(cell, monkeypatch):
    """Every optimizer apply leaves the state as it was."""
    from imagegeneration_tpu_torch.train import common
    monkeypatch.setattr(common, "adam_apply", lambda *args, **kwargs: None)


def plant_half_batch(cell, monkeypatch):
    """The step trains on the first half of each batch, its means taken
    over those rows."""
    steplib = _step_module(cell)
    make = steplib.make_train_step

    def halved(cfg, group=None):
        step = make(cfg, group)
        return lambda state, *batches: step(state, *[b[:b.shape[0] // 2] for b in batches])

    monkeypatch.setattr(steplib, "make_train_step", halved)


def plant_logit(cell, monkeypatch):
    """The discriminator's first logit comes out 1 higher than computed."""
    disc = _models_module(cell).Discriminator
    forward = disc.forward

    def altered(self, *args, **kwargs):
        out = forward(self, *args, **kwargs)
        first = torch.zeros_like(out).view(-1)
        first[0] = 1.0
        return out + first.view(out.shape)

    monkeypatch.setattr(disc, "forward", altered)


FAULTS = {"frozen": plant_frozen, "half_batch": plant_half_batch, "logit": plant_logit}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_reads_not_correct(cell, fault, monkeypatch):
    spec = SmallSpec({CONFIG_OF[cell]: {"dtype": "float32"}})
    result = harness.run(cell, 5, 0.2, False, spec=spec, device="cpu",
                         plant=lambda: FAULTS[fault](cell, monkeypatch))
    assert result["correct"] is False, result["checks"]
    assert result["failed"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_the_same_run_unbroken_reads_correct(cell):
    spec = SmallSpec({CONFIG_OF[cell]: {"dtype": "float32"}})
    assert harness.run(cell, 5, 0.2, False, spec=spec, device="cpu")["correct"]
