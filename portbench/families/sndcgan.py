"""The SNDCGAN training step of the program under test, as the harness drives it.

The step is the program's resident epoch runner (`make_epoch_runner` of
`imagegeneration_tpu_torch.train.sndcgan_step`, the path the engines' feed
takes for a dataset that fits on the card), called once per step with that
step's (1, B) index table, so that each step's end can be marked. The
program's state is built by its own `init_state`; the benchmark then
copies its weights and spectral-norm vectors in and gives it the latent
generator, so the program and the reference start alike. The dropout key
words are the program's own, derived from the seed in the train config;
the reference derives them again (`reference/hash.py`).
"""

from __future__ import annotations

import torch

REFERENCE = "sndcgan"
LOSSES = ("g_loss", "d_loss_real", "d_loss_fake")
FIRST_LOSSES = ("g_loss", "d_loss_real")  # step 1, before the D applies
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Program:
    def __init__(self, cfg: dict, traffic: dict, weights: dict, seeds: dict, device) -> None:
        from imagegeneration_tpu_torch.models.sndcgan import SNDCGANConfig
        from imagegeneration_tpu_torch.train import sndcgan_step as steplib

        self.tcfg = steplib.SNDCGANTrainConfig(
            model=SNDCGANConfig(
                image_size=tuple(cfg["image_size"]), z_size=cfg["z_size"],
                dropout_rate=cfg["dropout_rate"], base_width=cfg["base_width"],
                spectral_norm=cfg["spectral_norm"], dtype=_DTYPES[cfg["dtype"]]),
            batch_size=traffic["batch_size"], lr_gen=cfg["lr"], lr_disc=cfg["lr"],
            loss=cfg["loss"], d_updates=cfg["d_updates"], seed=seeds["model"])
        if (cfg["b1"], cfg["b2"]) != (0.9, 0.999):
            raise ValueError("the program's SNDCGAN step runs Adam with b1 0.9, b2 0.999")
        self.state = steplib.init_state(self.tcfg, device)
        self.models = {"gen": self.state.gen, "disc": self.state.disc}
        with torch.no_grad():
            for prefix, model in self.models.items():
                for name, t in [*model.named_parameters(), *model.named_buffers()]:
                    key = f"{prefix}.{name}"
                    if key in weights:
                        t.copy_(weights[key])
        self.state.z_gen = torch.Generator(device=device).manual_seed(seeds["z"])
        self.opts = {"gen": self.state.g_opt, "disc": self.state.d_opt}
        self.b1 = cfg["b1"]
        self.run_epoch = steplib.make_epoch_runner(self.tcfg)

    def step(self, datasets: list[torch.Tensor], rows: list[torch.Tensor]) -> dict:
        self.state, metrics = self.run_epoch(self.state, datasets[0], rows[0])
        return metrics

    def leaves(self):
        """(name, parameter, first moment, b1) of every optimized leaf."""
        for prefix, model in self.models.items():
            names = [n for n, _ in model.named_parameters()]
            opt = self.opts[prefix]
            for name, p, m in zip(names, model.parameters(), opt.mu, strict=True):
                yield f"{prefix}.{name}", p, m, self.b1
