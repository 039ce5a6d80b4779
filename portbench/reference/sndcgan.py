"""Plain float32 SNDCGAN training step (jonathan-schilling/imageGeneration,
sndcgan/SNDCGAN.py and sndcgan/Trainer.py, with spectral norm and the
hinge loss of SN-GAN).

Generator: z -> Dense(base * H/8 * W/8, no bias) -> BatchNorm -> ReLU ->
reshape in NHWC order to (H/8, W/8, base) -> 3 x [ConvTranspose 4x4 s2 SAME
(no bias) -> BatchNorm -> ReLU] (base/2, base/4, base/8) -> Conv 3x3 s1
SAME (no bias) -> tanh.

Discriminator: 7 SAME convs (64@3x3 s1, 128@4x4 s2, 128@3x3 s1, 256@4x4
s2, 256@3x3 s1, 512@4x4 s2, 512@3x3 s1), each with a bias, spectrally
normalized, then LeakyReLU(0.1) and dropout; an NHWC flatten and a
spectrally normalized Dense(1) head.

One step, in the reference's order: the G update (D on G(z) at the
current spectral-norm vectors, which it does not write), then the D update
on the real batch (which writes the new vectors), then the D update on the
same fake batch, made by the generator before its update, on the updated
D. The dropout sites are numbered G pass 0-6, D real 7-13, D fake 14-20;
their masks come from `hash.py`. z is U[-1, 1) from a generator the
caller seeds. Adam (Keras form), lr 2e-4, b1 0.9, for both models.

Names and shapes of the leaves follow PyTorch's conventions: conv weights
(out, in, kh, kw), transposed-conv weights (in, out, kh, kw), dense
weights (out, in).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import common, hash as rhash

DISC_TRUNK = ((64, 3, 1), (128, 4, 2), (128, 3, 1), (256, 4, 2), (256, 3, 1),
              (512, 4, 2), (512, 3, 1))
N_SITES = len(DISC_TRUNK)
PASSES = 3  # D passes a step, each through every dropout site
ADAM_APPLIES = {"gen": 1, "disc": 2}  # optimizer applies a step, per model
LEAKY_SLOPE = 0.1


def trunk_hw(h: int, w: int) -> tuple[int, int]:
    for _, _, s in DISC_TRUNK:
        h, w = -(-h // s), -(-w // s)
    return h, w


def param_specs(cfg: dict) -> list[tuple]:
    """(name, shape, init, trainable) of every leaf; init is ("glorot",
    fan_in, fan_out), "ones", "zeros" or "unit" (a random unit vector)."""
    h, w, c = cfg["image_size"]
    base, zs = cfg["base_width"], cfg["z_size"]
    stem = base * (h // 8) * (w // 8)
    specs = [("gen.stem.weight", (stem, zs), ("glorot", zs, stem), True),
             ("gen.stem_bn.scale", (stem,), "ones", True),
             ("gen.stem_bn.bias", (stem,), "zeros", True)]
    feats = base
    for i, out in enumerate((base // 2, base // 4, base // 8)):
        specs += [(f"gen.up{i}.weight", (feats, out, 4, 4), ("glorot", 16 * out, 16 * feats), True),
                  (f"gen.up{i}_bn.scale", (out,), "ones", True),
                  (f"gen.up{i}_bn.bias", (out,), "zeros", True)]
        feats = out
    specs.append(("gen.to_rgb.weight", (c, feats, 3, 3), ("glorot", 9 * feats, 9 * c), True))
    feats = c
    for i, (out, k, _) in enumerate(DISC_TRUNK):
        specs += [(f"disc.conv{i}.weight", (out, feats, k, k),
                   ("glorot", k * k * feats, k * k * out), True),
                  (f"disc.conv{i}.bias", (out,), "zeros", True),
                  (f"disc.conv{i}.u", (out,), "unit", False)]
        feats = out
    th, tw = trunk_hw(h, w)
    flat = feats * th * tw
    specs += [("disc.head.weight", (1, flat), ("glorot", flat, 1), True),
              ("disc.head.bias", (1,), "zeros", True),
              ("disc.head.u", (1,), "unit", False)]
    return specs


class Trainer:
    """The reference's training state and step. `fault` plants a fault for
    the harness's tests and readings: "half_batch" trains on the first half
    of each batch; "logit" adds 1 to the first row's logit of every D
    pass."""

    def __init__(self, cfg: dict, weights: dict, seeds: dict, device, batch_size: int,
                 precision: str = "f32", fault: str | None = None) -> None:
        if cfg["loss"] != "hinge" or cfg["d_updates"] != 2 or not cfg["spectral_norm"]:
            raise ValueError("the reference step is the hinge loss, spectral norm, d_updates=2")
        self.cfg, self.device, self.batch = cfg, torch.device(device), batch_size
        self.prec = common.Precision(precision)
        self.fault = fault
        self.kw_seed = seeds["model"]
        self.z_gen = None
        if self.device.type != "meta":
            self.z_gen = torch.Generator(device=self.device).manual_seed(seeds["z"])
        specs = param_specs(cfg)
        self.params = {n: weights[n].detach().clone().requires_grad_(True)
                       for n, _, _, t in specs if t}
        self.u = {n: weights[n].detach().clone() for n, _, _, t in specs if not t}
        self.gen_names = [n for n in self.params if n.startswith("gen.")]
        self.disc_names = [n for n in self.params if n.startswith("disc.")]
        lr, b1 = cfg["lr"], cfg["b1"]
        self.g_opt = common.Adam({n: self.params[n] for n in self.gen_names}, lr, b1, cfg["b2"])
        self.d_opt = common.Adam({n: self.params[n] for n in self.disc_names}, lr, b1, cfg["b2"])
        self.t = 0

    def optimizer_of(self, name: str) -> common.Adam:
        return self.g_opt if name.startswith("gen.") else self.d_opt

    def _z(self) -> torch.Tensor:
        shape = (self.batch, self.cfg["z_size"])
        if self.z_gen is None:
            return torch.empty(shape, device=self.device)
        return 2.0 * torch.rand(shape, generator=self.z_gen, device=self.device) - 1.0

    def generator(self, z):
        p, prec = self.params, self.prec
        h, w, _ = self.cfg["image_size"]
        x = prec.round(common.linear(z, p["gen.stem.weight"], None, prec))
        x = torch.relu(prec.round(common.batch_norm_train(
            x, p["gen.stem_bn.scale"], p["gen.stem_bn.bias"])))
        x = x.view(z.shape[0], h // 8, w // 8, -1).permute(0, 3, 1, 2)
        for i in range(3):
            x = prec.round(common.conv_transpose_same(x, p[f"gen.up{i}.weight"], None, 2, prec))
            x = torch.relu(prec.round(common.batch_norm_train(
                x, p[f"gen.up{i}_bn.scale"], p[f"gen.up{i}_bn.bias"])))
        x = prec.round(common.conv(x, p["gen.to_rgb.weight"], None, 1, "SAME", prec))
        return torch.tanh(x)

    def discriminator(self, x, kws, update_sn: bool):
        p, prec = self.params, self.prec
        cut = rhash.dropout_cut(self.cfg["dropout_rate"])
        for i, (_, _, stride) in enumerate(DISC_TRUNK):
            wn, new_u = common.spectral_normalize(p[f"disc.conv{i}.weight"], self.u[f"disc.conv{i}.u"])
            if update_sn:
                self.u[f"disc.conv{i}.u"] = new_u
            x = prec.round(common.conv(x, wn, p[f"disc.conv{i}.bias"], stride, "SAME", prec))
            keep = rhash.keep_mask(tuple(x.shape), kws[i], cut, x.device)
            x = prec.round(torch.where(keep, F.leaky_relu(x, LEAKY_SLOPE) * (256.0 / (256 - cut)),
                                       torch.zeros((), device=x.device)))
        wn, new_u = common.spectral_normalize(p["disc.head.weight"], self.u["disc.head.u"])
        if update_sn:
            self.u["disc.head.u"] = new_u
        flat = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        logits = prec.round(common.linear(flat, wn, p["disc.head.bias"], prec))
        if self.fault == "logit":
            first = torch.arange(logits.numel(), device=logits.device).view(logits.shape) == 0
            logits = logits + first.to(logits.dtype)
        return logits

    def step(self, batch_u8: torch.Tensor) -> dict:
        """One training step on a (B, H, W, C) uint8 batch: the losses."""
        kws = rhash.dropout_kw(self.kw_seed, self.t, 3 * N_SITES)
        z = self._z()
        x_real = common.to_unit(batch_u8)
        if self.fault == "half_batch":
            z, x_real = z[:self.batch // 2], x_real[:self.batch // 2]
        p = self.params
        fake = self.generator(z)
        g_loss = common.hinge_g(self.discriminator(fake, kws[0:7], update_sn=False))
        self.g_opt.apply(p, common.grads_of(g_loss, p, self.gen_names))
        fake = fake.detach()
        d_real = common.hinge_d_real(self.discriminator(x_real, kws[7:14], update_sn=True))
        self.d_opt.apply(p, common.grads_of(d_real, p, self.disc_names))
        d_fake = common.hinge_d_fake(self.discriminator(fake, kws[14:21], update_sn=False))
        self.d_opt.apply(p, common.grads_of(d_fake, p, self.disc_names))
        self.t += 1
        return {"g_loss": g_loss.detach(), "d_loss_real": d_real.detach(),
                "d_loss_fake": d_fake.detach()}
