"""Data x spatial dry run: one tiny SNDCGAN step over n gloo ranks on the CPU.

    python -m imagegeneration_tpu_torch.tools.dryrun_multichip [n] [spatial]

The port's counterpart of `__graft_entry__.dryrun_multichip`: n spawned
ranks (parallel/dp.spawn_local, gloo, CPU) in an (n / spatial) x spatial
mesh. Each data block takes 2 rows of a global batch of 2 n / spatial zero
images at 32x32, each spatial rank its block of image rows (32 / spatial;
spatial <= 2 keeps the guard's 2 rows per shard at H/8); the ranks run one
step, average the metrics over the data blocks and check that their
states are bit-equal. Prints one line and returns the metrics.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from imagegeneration_tpu_torch.core.mesh import check_spatial_partition
from imagegeneration_tpu_torch.models.sndcgan import SNDCGANConfig, min_sharded_height
from imagegeneration_tpu_torch.parallel import dp
from imagegeneration_tpu_torch.train import sndcgan_step as steplib

HEIGHT, WIDTH, ROWS_PER_RANK = 32, 32, 2


def _rank(group) -> dict:
    cfg = steplib.SNDCGANTrainConfig(
        model=SNDCGANConfig(image_size=(HEIGHT, WIDTH, 3), base_width=64),
        batch_size=ROWS_PER_RANK * group.data)
    check_spatial_partition(min_sharded_height(cfg.model), group.spatial, "sndcgan", HEIGHT)
    state = steplib.init_state(cfg, group.device)
    dp.replicate_state(state, group)
    batch = torch.zeros((ROWS_PER_RANK, HEIGHT // group.spatial, WIDTH, 3), dtype=torch.uint8)
    state, m = steplib.make_train_step(cfg, group)(state, batch)
    metrics = dp.reduce_metrics({k: v.reshape(1) for k, v in m.items()}, group)
    return {"step": int(state.step), "digest": dp.check_replicated(state, group),
            "metrics": {k: float(v[0]) for k, v in metrics.items()},
            "grad_all_reduces": group.counts["grad_all_reduce"],
            "halo_exchanges": group.counts["halo"],
            "jax_imported": "jax" in sys.modules}


def dryrun_multichip(n: int, spatial: int = 1) -> dict:
    out = dp.spawn_local(_rank, n, "cpu", num_threads=1, timeout=600, spatial=spatial)
    if any(r["step"] != 1 for r in out) or len({r["digest"] for r in out}) != 1:
        raise RuntimeError(f"dryrun_multichip: ranks disagree: {out}")
    m = out[0]["metrics"]
    print(f"dryrun_multichip SNDCGAN OK: {n} gloo ranks ({n // spatial} data x {spatial} "
          f"spatial), global batch {ROWS_PER_RANK * n // spatial}, g_loss={m['g_loss']:.4f}, "
          f"{out[0]['grad_all_reduces']} gradient all-reduces, "
          f"{out[0]['halo_exchanges']} halo exchanges", flush=True)
    return out[0]


if __name__ == "__main__":
    dryrun_multichip(*(int(a) for a in sys.argv[1:3] or ["2"]))
