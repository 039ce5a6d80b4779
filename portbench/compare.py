"""The comparison that decides `correct`: the program's first training
steps against the plain reference's, from the same weights, batches,
latents and dropout keys.

Readings, taken alike from either side after its first CHECKED_STEPS
steps:

- losses: each step's losses (the family's LOSSES);
- grad1: per leaf, the norm of the first moment after step 1 over (1 - b1):
  the first gradient as the optimizer got it (for a model with two applies
  a step, b1 g1 + g2);
- change: per leaf, the norm of the parameters' change over the
  CHECKED_STEPS steps.

Numbers, of which each cell compares those its workload file gives a
limit (`verdict`):

- loss_gap: the largest |program - reference| over the steps and losses,
  over max(|reference|, 1); loss1_gap the same over the losses step 1
  computes before any optimizer apply they depend on (the family's
  FIRST_LOSSES): the forward at the starting weights alone;
- grad1_gap: the worst leaf's |norm_program - norm_reference| over the
  larger of the reference's norm of that leaf and of the median leaf;
  grad1_median_gap the median leaf's;
- change3_gap: the worst leaf's gap of the change, over the leaves whose
  reference grad1 is at least GRAD_FLOOR of the median leaf's: a leaf
  whose gradient is nought to rounding (a conv bias under an InstanceNorm)
  moves under Adam by the sign of its round-off alone.
"""

from __future__ import annotations

import math
import statistics

import torch

CHECKED_STEPS = 3
GRAD_FLOOR = 1e-3
NUMBERS = ("loss_gap", "loss1_gap", "grad1_gap", "grad1_median_gap", "change3_gap")


@torch.no_grad()
def first_moments(leaves) -> dict[str, torch.Tensor]:
    """{leaf: norm of m / (1 - b1)} as 0-d device tensors."""
    return {name: torch.linalg.vector_norm(m.float()) / (1.0 - b1) for name, _, m, b1 in leaves}


@torch.no_grad()
def changes(params: dict, start: dict) -> dict[str, torch.Tensor]:
    """{leaf: norm of (p - p0)} as 0-d device tensors."""
    return {name: torch.linalg.vector_norm(p.float() - start[name]) for name, p in params.items()}


def to_floats(readings: dict) -> dict:
    """The readings with every tensor read back as a float."""
    return {"losses": [{k: float(v) for k, v in s.items()} for s in readings["losses"]],
            "grad1": {k: float(v) for k, v in readings["grad1"].items()},
            "change": {k: float(v) for k, v in readings["change"].items()}}


def reference_readings(trainer, batches: list[list[torch.Tensor]], start: dict) -> dict:
    """Run the reference trainer over the checked steps' batches."""
    losses, grad1 = [], {}
    for s, batch in enumerate(batches):
        losses.append(trainer.step(*batch))
        if s == 0:
            grad1 = first_moments(
                (n, None, trainer.optimizer_of(n).m[n], trainer.optimizer_of(n).b1)
                for n in trainer.params)
    return to_floats({"losses": losses, "grad1": grad1,
                      "change": changes(trainer.params, start)})


def _leaf_gaps(prog: dict, ref: dict, names) -> dict[str, float]:
    """Each leaf's |norm_program - norm_reference| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    names = list(names)
    med = statistics.median(ref[n] for n in names)
    out = {}
    for n in names:
        scale = max(ref[n], med)
        gap = abs(prog[n] - ref[n]) / scale if scale > 0 else abs(prog[n] - ref[n])
        out[n] = gap if math.isfinite(gap) else math.inf
    return out


def _worst(gaps: dict[str, float]) -> tuple[float, str]:
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def _median(gaps: dict[str, float]) -> tuple[float, str]:
    return statistics.median(gaps.values()), f"median of {len(gaps)} leaves"


def _loss_gap(prog: dict, ref: dict, steps, keys=None) -> tuple[float, str]:
    worst, at = 0.0, ""
    for s in steps:
        for k, rv in ref["losses"][s].items():
            if keys is not None and k not in keys:
                continue
            gap = abs(prog["losses"][s][k] - rv) / max(abs(rv), 1.0)
            gap = gap if math.isfinite(gap) else math.inf
            if gap >= worst:
                worst, at = gap, f"step {s + 1} {k}"
    return worst, at


def gaps_at(prog: dict, ref: dict, first_losses) -> dict[str, tuple[float, str]]:
    """{number: (value, where)} of every number NUMBERS names, from two
    sides' float readings; `first_losses` are the losses step 1 computes
    before any optimizer apply they depend on."""
    med = statistics.median(ref["grad1"].values())
    moving = [n for n, g in ref["grad1"].items() if g >= GRAD_FLOOR * med]
    grad1 = _leaf_gaps(prog["grad1"], ref["grad1"], ref["grad1"])
    return {"loss_gap": _loss_gap(prog, ref, range(len(ref["losses"]))),
            "loss1_gap": _loss_gap(prog, ref, [0], first_losses),
            "grad1_gap": _worst(grad1), "grad1_median_gap": _median(grad1),
            "change3_gap": _worst(_leaf_gaps(prog["change"], ref["change"], moving))}


def gaps(prog: dict, ref: dict, first_losses) -> dict[str, float]:
    """The numbers, from two sides' float readings."""
    return {k: v for k, (v, _) in gaps_at(prog, ref, first_losses).items()}


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """Every number the cell compares (the keys of its limits) within its limit."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
