"""The CycleGAN training step of the program under test, as the harness drives it.

The step is the program's resident epoch runner (`make_epoch_runner` of
`imagegeneration_tpu_torch.train.cyclegan_step`, the path the engines'
feed takes for two datasets that fit on the card), called once per step
with that step's two (1, B) index tables. The program's state is built by
its own `init_state`; the benchmark then copies its weights in.
"""

from __future__ import annotations

import torch

REFERENCE = "cyclegan"
LOSSES = ("gen_g_loss", "gen_f_loss", "identity_loss_g", "identity_loss_f",
          "total_gen_g_loss", "total_gen_f_loss", "total_cycle_loss", "disc_x_loss",
          "disc_y_loss")
FIRST_LOSSES = LOSSES  # one forward, then the applies
_MODELS = ("gen_g", "gen_f", "disc_x", "disc_y")
_OPTS = ("gg_opt", "gf_opt", "dx_opt", "dy_opt")


class Program:
    def __init__(self, cfg: dict, traffic: dict, weights: dict, seeds: dict, device) -> None:
        from imagegeneration_tpu_torch.models.cyclegan import CycleGANConfig
        from imagegeneration_tpu_torch.train import cyclegan_step as steplib

        if cfg["dtype"] != "float32" or cfg["b2"] != 0.999:
            raise ValueError("the program's CycleGAN step is float32 with Adam b2 0.999")
        self.tcfg = steplib.CycleGANTrainConfig(
            model=CycleGANConfig(image_size=tuple(cfg["image_size"]),
                                 base_width=cfg["base_width"],
                                 n_res_blocks=cfg["n_res_blocks"]),
            batch_size=traffic["batch_size"], learning_rate=cfg["lr"], beta1=cfg["b1"],
            seed=seeds["model"])
        self.state = steplib.init_state(self.tcfg, device)
        with torch.no_grad():
            for prefix in _MODELS:
                for name, p in getattr(self.state, prefix).named_parameters():
                    p.copy_(weights[f"{prefix}.{name}"])
        self.b1 = cfg["b1"]
        self.run_epoch = steplib.make_epoch_runner(self.tcfg)

    def step(self, datasets: list[torch.Tensor], rows: list[torch.Tensor]) -> dict:
        self.state, metrics = self.run_epoch(self.state, *datasets, *rows)
        return metrics

    def leaves(self):
        """(name, parameter, first moment, b1) of every optimized leaf."""
        for prefix, opt in zip(_MODELS, _OPTS):
            model = getattr(self.state, prefix)
            names = [n for n, _ in model.named_parameters()]
            for name, p, m in zip(names, model.parameters(), getattr(self.state, opt).mu,
                                  strict=True):
                yield f"{prefix}.{name}", p, m, self.b1
