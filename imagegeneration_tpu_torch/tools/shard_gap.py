#!/usr/bin/env python3
"""Where config 5's float32 shards part from the whole map, on one CUDA card.

    python -m imagegeneration_tpu_torch.tools.shard_gap --out DIR [--cpu]

One SNDCGAN train step of config 5 (bench.py:360-411: 512x288, batch 16,
base 512, spectral norm, hinge, dropout 0.5) in float32, from the seeded
state (seed 0) on a synthetic batch (seed 9), the step chip_smoke.py's
phase 9b replays: on the whole map on the card, and on 2 spatial ranks
(data 1 x spatial 2) sharing the card over gloo; with --cpu also on the
whole map on the CPU (the card's state and latents loaded there). Each run
records, in the order the step makes them:

- `layers`: the output of the first call of every module holding
  parameters (G's in the generator pass, D's on that pass's fake batch),
  the ranks' own rows of each H-partitioned map;
- `grads`: the gradients each Adam apply takes (G, then D twice), averaged
  over the ranks;
- the state after the step.

Against the card's whole map it prints, per layer and per gradient leaf,
the largest |difference| over the largest |value| (`rel`), and per state
collection the same measure as chip_smoke.state_errors; and `adam`: the
parameters that the Keras-Adam first step (m / (sqrt(v) + eps), which is
sign(g) for |g| >> eps) makes from each run's gradients of the first G
and D applies, from the same seeded parameters, against each other: how
far the optimizer alone carries a rounding difference of the gradients.

Writes DIR/shard_gap.json; the card's name and power limit are printed
before the last line, the summary as one JSON object.
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import torch

from imagegeneration_tpu_torch.core import mesh as meshlib
from imagegeneration_tpu_torch.core import platform
from imagegeneration_tpu_torch.core.data import SyntheticImageDataset
from imagegeneration_tpu_torch.models.sndcgan import SNDCGANConfig
from imagegeneration_tpu_torch.ops import adam as adam_op
from imagegeneration_tpu_torch.parallel import dp
from imagegeneration_tpu_torch.train import sndcgan_step as steplib

HEIGHT, WIDTH, BATCH, BASE = 288, 512, 16, 512
SPATIAL = 2
RANKS_TIMEOUT_S = 900


def log(msg: str) -> None:
    print(msg, flush=True)


def step_config() -> steplib.SNDCGANTrainConfig:
    return steplib.SNDCGANTrainConfig(
        model=SNDCGANConfig(image_size=(HEIGHT, WIDTH, 3), base_width=BASE,
                            spectral_norm=True, dtype=torch.float32),
        batch_size=BATCH, loss="hinge", seed=0)


def load_state(state, sd: dict) -> None:
    """`sd` (a state dict from another device) into `state`, but for the
    latent stream, which the runs do not draw from (z is passed)."""
    with torch.no_grad():
        state.step.copy_(sd["step"])
    state.gen.load_state_dict(sd["gen"])
    state.disc.load_state_dict(sd["disc"])
    state.g_opt.load_state_dict(sd["g_opt"])
    state.d_opt.load_state_dict(sd["d_opt"])


def recorded_step(state, cfg, batch, z, group=None) -> dict:
    """One step of `cfg` on `batch` (this rank's rows) with latents `z`,
    recording the layers' outputs and the gradients of each Adam apply (on
    the host)."""
    layers: dict[str, torch.Tensor] = {}
    grads: list[list[torch.Tensor]] = []
    handles = []
    for tag, model in (("gen", state.gen), ("disc", state.disc)):
        for name, mod in model.named_modules():
            if next(mod.parameters(recurse=False), None) is None:
                continue
            key = f"{tag}/{name}"

            def hook(m, inp, out, key=key):
                if key in layers or not isinstance(out, torch.Tensor):
                    return
                layers[key] = out.detach().float().cpu()

            handles.append(mod.register_forward_hook(hook))
    original = adam_op.adam_apply

    def adam_apply(params, gs, *args, **kwargs):
        grads.append([g.detach().float().cpu() for g in gs])
        return original(params, gs, *args, **kwargs)

    adam_op.adam_apply = adam_apply
    try:
        state, _ = steplib.make_train_step(cfg, group)(state, batch, z)
    finally:
        adam_op.adam_apply = original
        for h in handles:
            h.remove()
    return {"layers": layers, "grads": grads,
            "state": {k: v.cpu() for k, v in dp._leaves(state.state_dict())
                      if isinstance(v, torch.Tensor) and v.is_floating_point()}}


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    scale = float(want.abs().max())
    d = float((got.double() - want.double()).abs().max())
    return d / scale if scale else (math.inf if d else 0.0)


def by_collection(got: dict, want: dict) -> dict[str, float]:
    """Per collection (a model, or an optimizer moment), the largest
    |difference| over the collection's largest |value|."""
    diff: dict[str, float] = {}
    scale: dict[str, float] = {}
    for path, b in want.items():
        parts = path.strip("/").split("/")
        coll = "/".join(parts[:2] if parts[0].endswith("_opt") else parts[:1])
        diff[coll] = max(diff.get(coll, 0.0), float((got[path].double() - b.double()).abs().max()))
        scale[coll] = max(scale.get(coll, 0.0), float(b.abs().max()))
    return {c: diff[c] / scale[c] if scale[c] else 0.0 for c in diff}


def layer_gaps(got: dict, want: dict, s: int, spatial: int) -> dict:
    """Each layer's output against the whole map's: rank s's rows of an
    H-partitioned map, the whole output of one every peer holds (the Dense
    stem; the heads, whose partial logits the layer sums over the peers)."""
    out = {}
    for key, w in want.items():
        g = got.get(key)
        if g is None:
            continue
        if g.shape != w.shape and g.dim() == 4 and g.shape[2] * spatial == w.shape[2]:
            h = g.shape[2]
            w = w[:, :, s * h:(s + 1) * h]
        out[key] = rel(g, w) if g.shape == w.shape else None
    return out


def grad_gaps(got: list, want: list) -> list[dict]:
    """Per Adam apply: the worst leaf, its index, and the median leaf."""
    out = []
    for ga, wa in zip(got, want):
        r = [rel(g, w) for g, w in zip(ga, wa)]
        order = sorted(r)
        worst = max(range(len(r)), key=r.__getitem__)
        out.append({"worst": r[worst], "worst_leaf": worst, "median": order[len(order) // 2],
                    "leaves": r})
    return out


def adam_first_step(params0: list[torch.Tensor], grads: list[torch.Tensor], lr: float,
                    b1: float = 0.9, b2: float = 0.999) -> list[torch.Tensor]:
    """The parameters after the Keras-Adam first step (count 1) from params0."""
    alpha = lr * math.sqrt(1 - b2) / (1 - b1)
    out = []
    for p, g in zip(params0, grads):
        g = g.double()
        m, v = (1 - b1) * g, (1 - b2) * g * g
        out.append(p.double() - alpha * m / (v.sqrt() + adam_op.KERAS_EPS))
    return out


def adam_gaps(params0: dict, cfg, got: list, want: list) -> dict:
    """How far Adam's first step alone carries each run's gradient
    difference: the G and D parameters after the first G and D applies from
    the same seeded parameters, per model, over its largest |v|."""
    out = {}
    for label, i, lr in (("gen", 0, cfg.lr_gen), ("disc", 1, cfg.lr_disc)):
        p0 = params0[label]
        a = adam_first_step(p0, got[i], lr)
        b = adam_first_step(p0, want[i], lr)
        scale = max(float(t.abs().max()) for t in b)
        out[label] = max(float((x - y).abs().max()) for x, y in zip(a, b)) / scale
    return out


def spatial_rank(group, cfg, batch, z, work: str) -> dict:
    """One of the 2 spatial ranks: the recorded step on its image rows from
    the one card's seeded state, against the one card's records."""
    dev = group.device
    state = steplib.init_state(cfg, dev)
    load_state(state, torch.load(f"{work}/state0.pt", map_location=dev))
    rows = slice(*meshlib.spatial_row_range(group, HEIGHT))
    local = torch.from_numpy(batch[:, rows].copy()).to(dev)
    got = recorded_step(state, cfg, local, z.to(dev), group)
    want = torch.load(f"{work}/whole.pt")
    return {"s": group.s,
            "layers": layer_gaps(got["layers"], want["layers"], group.s, SPATIAL),
            "grads": grad_gaps(got["grads"], want["grads"]),
            "state": by_collection(got["state"], want["state"]),
            # numpy: a CPU tensor crosses the result queue as a handle to this
            # process's memory, gone once the rank exits
            "grads_raw": [[g.numpy() for g in a] for a in got["grads"][:2]]
            if group.s == 0 else None}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="directory for the results")
    ap.add_argument("--cpu", action="store_true", help="also the whole map on the CPU")
    args = ap.parse_args(argv)
    dev = platform.require_cuda()
    numerics = platform.configure_numerics()
    card = platform.card_description()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    cfg = step_config()
    batch = SyntheticImageDataset(BATCH, (HEIGHT, WIDTH), seed=9).images
    z = torch.rand(BATCH, cfg.model.z_size, generator=torch.Generator().manual_seed(9)) * 2 - 1

    state = steplib.init_state(cfg, dev)
    sd0 = state.state_dict()
    torch.save({k: v for k, v in sd0.items() if k != "z_gen"}, out / "state0.pt")
    params0 = {"gen": [p.detach().cpu() for p in state.gen.parameters()],
               "disc": [p.detach().cpu() for p in state.disc.parameters()]}
    whole = recorded_step(state, cfg, torch.from_numpy(batch).to(dev), z.to(dev))
    torch.save(whole, out / "whole.pt")
    del state
    torch.cuda.empty_cache()
    log(f"whole map on the card: {len(whole['layers'])} layers, {len(whole['grads'])} "
        f"Adam applies recorded ({card}; {numerics})")

    ranks = dp.spawn_local(spatial_rank, SPATIAL, "cuda", backend="gloo",
                           devices=["cuda:0"] * SPATIAL, spatial=SPATIAL,
                           args=(cfg, batch, z, str(out)), timeout=RANKS_TIMEOUT_S)
    summary: dict = {"card": card, "numerics": numerics, "config": "config 5 f32, seed 0",
                     "ranks": [{k: v for k, v in r.items() if k != "grads_raw"}
                               for r in ranks]}
    rank_grads = [[torch.from_numpy(g) for g in a] for a in ranks[0]["grads_raw"]]
    summary["adam"] = {"ranks_vs_card": adam_gaps(params0, cfg, rank_grads, whole["grads"])}
    for r in ranks:
        worst_layer = max(((k, v) for k, v in r["layers"].items() if v is not None),
                          key=lambda kv: kv[1])
        log(f"rank s={r['s']}: worst layer {worst_layer[0]} {worst_layer[1]:.3g}; grads per "
            f"apply worst/median " + ", ".join(f"{g['worst']:.3g}/{g['median']:.3g}"
                                               for g in r["grads"])
            + f"; state per collection {r['state']} ({card})")
    log(f"adam first step from the ranks' vs the card's gradients: "
        f"{summary['adam']['ranks_vs_card']} ({card})")

    if args.cpu:
        cpu = torch.device("cpu")
        state = steplib.init_state(cfg, cpu)
        load_state(state, {k: v for k, v in torch.load(out / "state0.pt",
                                                        map_location=cpu).items()})
        got = recorded_step(state, cfg, torch.from_numpy(batch), z)
        summary["cpu"] = {"layers": layer_gaps(got["layers"], whole["layers"], 0, 1),
                          "grads": grad_gaps(got["grads"], whole["grads"]),
                          "state": by_collection(got["state"], whole["state"])}
        summary["adam"]["cpu_vs_card"] = adam_gaps(params0, cfg, got["grads"],
                                                   whole["grads"])
        worst_layer = max(((k, v) for k, v in summary["cpu"]["layers"].items()
                           if v is not None), key=lambda kv: kv[1])
        log(f"cpu whole map vs the card's: worst layer {worst_layer[0]} {worst_layer[1]:.3g}; "
            f"grads per apply worst/median " + ", ".join(
                f"{g['worst']:.3g}/{g['median']:.3g}" for g in summary["cpu"]["grads"])
            + f"; state per collection {summary['cpu']['state']}; adam first step "
            f"{summary['adam']['cpu_vs_card']} ({card})")
    (out / "shard_gap.json").write_text(json.dumps(summary, indent=1))
    print(card)
    print(json.dumps({k: v for k, v in summary.items() if k not in ("ranks", "cpu")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
