"""Plain float32 CycleGAN training step (jonathan-schilling/imageGeneration,
cyclegan/CycleGAN.py:60-183 and 325-382).

Generator (resnet): conv 7x7 s1 SAME (base) -> InstanceNorm -> ReLU -> 2 x
[reflect pad 1 -> conv 3x3 s2 VALID (base*2, base*4) -> InstanceNorm ->
ReLU] -> n residual blocks [conv 3x3 SAME -> InstanceNorm -> ReLU -> conv
3x3 SAME -> add the input -> ReLU -> InstanceNorm] -> 2 x [ConvTranspose
3x3 s2 SAME (base*2, base) -> InstanceNorm -> ReLU] -> conv 7x7 s1 SAME (3)
-> InstanceNorm -> tanh. Every conv has a bias.

Discriminator (PatchGAN): 4 x [conv 4x4 s2 VALID (64, 128, 256, 512), an
InstanceNorm after all but the first, LeakyReLU(0.2)] -> conv 4x4 s1 VALID
(1): patch logits.

One step: fake_y = G(x), cycled_x = F(fake_y), fake_x = F(y), cycled_y =
G(fake_x), same_x = F(x), same_y = G(y); the four discriminator passes;
the losses (BCE on logits, cycle L1 x 10 in both generator totals,
identity L1 x 5); the gradients of each generator's total and of the sum
of the two discriminator losses, all against the same forward; then the
four Adam applies (Keras form, lr 2e-4, b1 0.5).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import common

DISC_TRUNK = ((64, False), (128, True), (256, True), (512, True))
LAMBDA = 10.0
MODELS = ("gen_g", "gen_f", "disc_x", "disc_y")
ADAM_APPLIES = {m: 1 for m in MODELS}  # optimizer applies a step, per model


def _conv(name: str, cin: int, cout: int, k: int) -> list[tuple]:
    return [(f"{name}.weight", (cout, cin, k, k), ("glorot", k * k * cin, k * k * cout), True),
            (f"{name}.bias", (cout,), "zeros", True)]


def _norm(name: str, c: int) -> list[tuple]:
    return [(f"{name}.scale", (c,), "uniform005", True), (f"{name}.bias", (c,), "uniform005", True)]


def _generator_specs(p: str, cfg: dict) -> list[tuple]:
    base, c = cfg["base_width"], cfg["image_size"][2]
    specs = _conv(f"{p}.stem_conv", c, base, 7) + _norm(f"{p}.stem_in", base)
    feats = base
    for i, out in enumerate((base * 2, base * 4)):
        specs += _conv(f"{p}.down{i}", feats, out, 3) + _norm(f"{p}.down{i}_in", out)
        feats = out
    for i in range(cfg["n_res_blocks"]):
        specs += (_conv(f"{p}.res{i}.conv1", feats, feats, 3) + _norm(f"{p}.res{i}.in1", feats)
                  + _conv(f"{p}.res{i}.conv2", feats, feats, 3) + _norm(f"{p}.res{i}.in2", feats))
    for i, out in enumerate((base * 2, base)):
        specs += [(f"{p}.up{i}.weight", (feats, out, 3, 3), ("glorot", 9 * out, 9 * feats), True),
                  (f"{p}.up{i}.bias", (out,), "zeros", True)] + _norm(f"{p}.up{i}_in", out)
        feats = out
    return specs + _conv(f"{p}.to_rgb", feats, 3, 7) + _norm(f"{p}.to_rgb_in", 3)


def _discriminator_specs(p: str, cfg: dict) -> list[tuple]:
    specs, feats = [], cfg["image_size"][2]
    for i, (out, norm) in enumerate(DISC_TRUNK):
        specs += _conv(f"{p}.conv{i}", feats, out, 4)
        if norm:
            specs += _norm(f"{p}.conv{i}_in", out)
        feats = out
    return specs + _conv(f"{p}.head", feats, 1, 4)


def param_specs(cfg: dict) -> list[tuple]:
    """(name, shape, init, trainable) of every leaf; init is ("glorot",
    fan_in, fan_out), "zeros" or "uniform005" (U(-0.05, 0.05), Keras's
    random_uniform)."""
    return (_generator_specs("gen_g", cfg) + _generator_specs("gen_f", cfg)
            + _discriminator_specs("disc_x", cfg) + _discriminator_specs("disc_y", cfg))


class Trainer:
    """The reference's training state and step. `fault` plants a fault for
    the harness's tests and readings: "half_batch" trains on the first half
    of each batch; "logit" adds 1 to the first patch logit of every
    discriminator pass."""

    def __init__(self, cfg: dict, weights: dict, seeds: dict, device, batch_size: int,
                 precision: str = "f32", fault: str | None = None) -> None:
        self.cfg, self.device, self.batch = cfg, torch.device(device), batch_size
        self.prec = common.Precision(precision)
        self.fault = fault
        self.params = {n: weights[n].detach().clone().requires_grad_(True)
                       for n, _, _, _ in param_specs(cfg)}
        self.names = {m: [n for n in self.params if n.split(".")[0] == m] for m in MODELS}
        self.opts = {m: common.Adam({n: self.params[n] for n in self.names[m]},
                                    cfg["lr"], cfg["b1"], cfg["b2"]) for m in MODELS}

    def optimizer_of(self, name: str) -> common.Adam:
        return self.opts[name.split(".")[0]]

    def _conv(self, x, name, stride, padding):
        p = self.params
        return common.conv(x, p[f"{name}.weight"], p[f"{name}.bias"], stride, padding, self.prec)

    def _in(self, x, name):
        return common.instance_norm(x, self.params[f"{name}.scale"], self.params[f"{name}.bias"])

    def generator(self, m: str, x):
        p = self.params
        x = torch.relu(self._in(self._conv(x, f"{m}.stem_conv", 1, "SAME"), f"{m}.stem_in"))
        for i in range(2):
            x = common.reflect_pad(x, 1)
            x = torch.relu(self._in(self._conv(x, f"{m}.down{i}", 2, "VALID"), f"{m}.down{i}_in"))
        for i in range(self.cfg["n_res_blocks"]):
            r = f"{m}.res{i}"
            fx = torch.relu(self._in(self._conv(x, f"{r}.conv1", 1, "SAME"), f"{r}.in1"))
            fx = self._conv(fx, f"{r}.conv2", 1, "SAME")
            x = self._in(torch.relu(x + fx), f"{r}.in2")
        for i in range(2):
            x = common.conv_transpose_same(x, p[f"{m}.up{i}.weight"], p[f"{m}.up{i}.bias"], 2,
                                           self.prec)
            x = torch.relu(self._in(x, f"{m}.up{i}_in"))
        x = self._in(self._conv(x, f"{m}.to_rgb", 1, "SAME"), f"{m}.to_rgb_in")
        return torch.tanh(x)

    def discriminator(self, m: str, x):
        for i, (_, norm) in enumerate(DISC_TRUNK):
            x = self._conv(x, f"{m}.conv{i}", 2, "VALID")
            if norm:
                x = self._in(x, f"{m}.conv{i}_in")
            x = F.leaky_relu(x, 0.2)
        logits = self._conv(x, f"{m}.head", 1, "VALID")
        if self.fault == "logit":
            first = torch.arange(logits.numel(), device=logits.device).view(logits.shape) == 0
            logits = logits + first.to(logits.dtype)
        return logits

    def step(self, batch_x_u8: torch.Tensor, batch_y_u8: torch.Tensor) -> dict:
        """One training step on two (B, H, W, C) uint8 batches: the losses."""
        real_x, real_y = common.to_unit(batch_x_u8), common.to_unit(batch_y_u8)
        if self.fault == "half_batch":
            real_x, real_y = real_x[:self.batch // 2], real_y[:self.batch // 2]
        fake_y = self.generator("gen_g", real_x)
        cycled_x = self.generator("gen_f", fake_y)
        fake_x = self.generator("gen_f", real_y)
        cycled_y = self.generator("gen_g", fake_x)
        same_x = self.generator("gen_f", real_x)
        same_y = self.generator("gen_g", real_y)
        d_real_x = self.discriminator("disc_x", real_x)
        d_real_y = self.discriminator("disc_y", real_y)
        d_fake_x = self.discriminator("disc_x", fake_x)
        d_fake_y = self.discriminator("disc_y", fake_y)

        gen_g = common.bce_logits(d_fake_y, 1.0)
        gen_f = common.bce_logits(d_fake_x, 1.0)
        cycle = LAMBDA * common.l1(real_x, cycled_x) + LAMBDA * common.l1(real_y, cycled_y)
        id_g = 0.5 * LAMBDA * common.l1(real_y, same_y)
        id_f = 0.5 * LAMBDA * common.l1(real_x, same_x)
        total_g = gen_g + cycle + id_g
        total_f = gen_f + cycle + id_f
        disc_x = 0.5 * (common.bce_logits(d_real_x, 1.0) + common.bce_logits(d_fake_x, 0.0))
        disc_y = 0.5 * (common.bce_logits(d_real_y, 1.0) + common.bce_logits(d_fake_y, 0.0))

        p = self.params
        grads = {"gen_g": common.grads_of(total_g, p, self.names["gen_g"], retain=True),
                 "gen_f": common.grads_of(total_f, p, self.names["gen_f"], retain=True)}
        d = common.grads_of(disc_x + disc_y, p, self.names["disc_x"] + self.names["disc_y"])
        grads["disc_x"] = {n: d[n] for n in self.names["disc_x"]}
        grads["disc_y"] = {n: d[n] for n in self.names["disc_y"]}
        for m in MODELS:
            self.opts[m].apply(p, grads[m])
        losses = {"gen_g_loss": gen_g, "gen_f_loss": gen_f, "identity_loss_g": id_g,
                  "identity_loss_f": id_f, "total_gen_g_loss": total_g,
                  "total_gen_f_loss": total_f, "total_cycle_loss": cycle,
                  "disc_x_loss": disc_x, "disc_y_loss": disc_y}
        return {k: v.detach() for k, v in losses.items()}
