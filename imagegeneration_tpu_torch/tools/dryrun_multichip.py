"""Data-parallel dry run: one tiny SNDCGAN step over n gloo ranks on the CPU.

    python -m imagegeneration_tpu_torch.tools.dryrun_multichip [n]

The port's counterpart of `__graft_entry__.dryrun_multichip`, with a data
axis only (spatial partitioning is not ported): n spawned ranks
(parallel/dp.spawn_local, gloo, CPU) each take 2 rows of a global batch of
2n zero images at 24x32, run one step with their rows, average the metrics
over the ranks and check that their states are bit-equal. Prints one line
and returns the metrics.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from imagegeneration_tpu_torch.models.sndcgan import SNDCGANConfig
from imagegeneration_tpu_torch.parallel import dp
from imagegeneration_tpu_torch.train import sndcgan_step as steplib

HEIGHT, WIDTH, ROWS_PER_RANK = 24, 32, 2


def _rank(group) -> dict:
    cfg = steplib.SNDCGANTrainConfig(
        model=SNDCGANConfig(image_size=(HEIGHT, WIDTH, 3), base_width=64),
        batch_size=ROWS_PER_RANK * group.world)
    state = steplib.init_state(cfg, group.device)
    dp.replicate_state(state, group)
    batch = torch.zeros((ROWS_PER_RANK, HEIGHT, WIDTH, 3), dtype=torch.uint8)
    state, m = steplib.make_train_step(cfg, group)(state, batch)
    metrics = dp.reduce_metrics({k: v.reshape(1) for k, v in m.items()}, group)
    return {"step": int(state.step), "digest": dp.check_replicated(state, group),
            "metrics": {k: float(v[0]) for k, v in metrics.items()},
            "grad_all_reduces": group.counts["grad_all_reduce"],
            "jax_imported": "jax" in sys.modules}


def dryrun_multichip(n: int) -> dict:
    out = dp.spawn_local(_rank, n, "cpu", num_threads=1, timeout=600)
    if any(r["step"] != 1 for r in out) or len({r["digest"] for r in out}) != 1:
        raise RuntimeError(f"dryrun_multichip: ranks disagree: {out}")
    m = out[0]["metrics"]
    print(f"dryrun_multichip SNDCGAN OK: {n} gloo ranks, global batch "
          f"{ROWS_PER_RANK * n}, g_loss={m['g_loss']:.4f}, "
          f"{out[0]['grad_all_reduces']} gradient all-reduces", flush=True)
    return out[0]


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
