"""Readings behind `QUIRK_ABSOLUTE` (tests/test_torch_spatial_cyclegan.py).

    JAX_PLATFORMS=cpu python tests/_quirk_gap_readings.py [FAULT ...]

Runs the quirk_axis1 CycleGAN case of that module (96x96, base 8, 1 res
block, batch 4, float64, 2 steps, seed 7) as the JAX one-device step, as
the port's one-process step, and on 4 gloo ranks (data 2 x spatial 2),
each rank run again with each planted FAULT: `d_grad_every_peer` (the
PatchGAN gradients counted on every spatial peer: `count_once` the
identity) or `quirk_rows` (every rank's per-row norms take the first rows
of their parameters). After each step it prints, for each run, every
leaf's distance from JAX beside the mesh bound max(1e-8, 1e-6 * max|leaf|)
when the ratio passes 0.3, the worst moment ratio, and the
QUIRK_ABSOLUTE leaves' absolute distances. ~5 min on one CPU worker.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).parent)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_spatial_cyclegan as T  # noqa: E402
from imagegeneration_tpu_torch.tools import dp_parity  # noqa: E402
from test_torch_dp import _leaf_bound, _tree_leaves, to_parent  # noqa: E402

FAULTS = ("d_grad_every_peer", "quirk_rows")


def plant(fault: str | None) -> None:
    from imagegeneration_tpu_torch.nn import layers
    from imagegeneration_tpu_torch.parallel import dp
    from imagegeneration_tpu_torch.train import cyclegan_step

    if fault == "d_grad_every_peer":
        cyclegan_step.count_once = lambda grads, group: list(grads)
    elif fault == "quirk_rows":
        layers.spatial_row_range = \
            lambda group, n: (0, n) if group is None else (0, n // group.spatial)
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    if fault is not None:  # unequal ranks still report
        dp.check_replicated = lambda state, group: dp.state_digest(state)


def worker(group, jobs, fault):
    torch.set_num_threads(1)
    plant(fault)
    return {name: to_parent(dp_parity.run_steps(group, "cyclegan", cfg, inputs, init),
                            group.rank, True)
            for name, cfg, inputs, init in jobs}


def report(label: str, states: list, want_states: list) -> None:
    print(label)
    for i, (got, want) in enumerate(zip(states, want_states)):
        g, w = dict(_tree_leaves(got)), dict(_tree_leaves(want))
        ratios = {k: float(np.abs(g[k] - w[k]).max(initial=0)) / _leaf_bound(w[k]) for k in w}
        print(f"  step {i + 1}: worst moment ratio "
              f"{max(r for k, r in ratios.items() if '_opt/' in k):.4g}")
        for k in sorted(ratios, key=ratios.get, reverse=True):
            if ratios[k] > 0.3:
                print(f"    {ratios[k]:8.4g}  {k}  {np.abs(g[k] - w[k]).max():.4g} off, "
                      f"max |leaf| {np.abs(w[k]).max():.4g}")
        for k in T.QUIRK_ABSOLUTE:
            print(f"    QUIRK_ABSOLUTE {k}: {np.abs(g[k] - w[k]).max():.4g} off "
                  f"(bound {T.QUIRK_ABSOLUTE[k]:g})")


def main(faults: list[str]) -> None:
    import jax

    torch.set_num_threads(1)
    jax.config.update("jax_enable_x64", True)
    js, cfg, state, state0 = T._jax_init(True)
    inputs = T._inputs(T.QUIRK_STEPS)
    _, _, want_states = T._jax_steps(js, cfg, state, inputs)
    jobs = [("quirk", T._port_config(True), inputs, state0)]
    one = dp_parity.run_steps(None, "cyclegan", jobs[0][1], inputs, state0)
    report("one process", one["states"], want_states)
    for fault in [None, *faults]:
        ranks = T._spawn(worker, T.DATA * T.SPATIAL, T.SPATIAL, jobs, fault)
        report(f"4 ranks, fault {fault}", ranks[0]["quirk"]["states"], want_states)


if __name__ == "__main__":
    unknown = set(sys.argv[1:]) - set(FAULTS)
    if unknown:
        raise SystemExit(f"unknown faults {sorted(unknown)}; choose from {FAULTS}")
    main(sys.argv[1:])
