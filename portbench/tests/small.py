"""The benchmark's cells at sizes a CPU test can hold.

`SmallSpec` reads BENCHMARK.json and the files it names, and shrinks each
configuration and traffic mix by SMALL: the same steps, layers and
arithmetic, at a fraction of the widths and images. The program takes the
plain versions of its kernels on the CPU."""

from __future__ import annotations

from portbench import harness, spec as speclib

SMALL = {
    "sndcgan-256x144": {"image_size": [16, 32, 3], "base_width": 16, "z_size": 8},
    "resident-7000-b128": {"batch_size": 4, "images": 16},
    "cyclegan-128": {"image_size": [96, 96, 3], "base_width": 4, "n_res_blocks": 1},
    "pairs-4000-b4": {"batch_size": 2, "images": 8},
}


class SmallSpec(speclib.Spec):
    def __init__(self, extra: dict | None = None) -> None:
        base = speclib.Spec.load(harness.ROOT)
        super().__init__(base.manifest, base.root)
        self.over = {k: dict(v) for k, v in SMALL.items()}
        for k, v in (extra or {}).items():
            self.over.setdefault(k, {}).update(v)

    def config(self, name: str) -> dict:
        return {**super().config(name), **self.over.get(name, {})}

    def traffic(self, name: str) -> dict:
        return {**super().traffic(name), **self.over.get(name, {})}


CELLS = ("sndcgan-b128", "cyclegan-b4")
CONFIG_OF = {"sndcgan-b128": "sndcgan-256x144", "cyclegan-b4": "cyclegan-128"}
