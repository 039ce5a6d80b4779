"""BENCHMARK.json and the files it names, found by name.

    BENCHMARK.json                       the manifest
    portbench/configs/<config>.json      a configuration as it is run (its
                                         "file" in the manifest); "family"
                                         names its step
    portbench/families/<family>.py       how the harness drives that step of
                                         the program
    portbench/reference/<family>.py      its plain reference (REFERENCE of the
                                         family module)
    portbench/traffic/<traffic>.json     a traffic mix (traffic.py reads it)
    portbench/workloads/<cell>.json      a cell's limits of the comparison
    portbench/metrics/<metric>.py        a metric's reader: read(cell) -> value
                                         or None

A later change adds a configuration, a cell, a traffic mix or a metric by
adding its files and its entry in the manifest.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

from portbench import traffic as trafficlib

HERE = Path(__file__).resolve().parent


class Spec:
    def __init__(self, manifest: dict, root: Path) -> None:
        self.manifest = manifest
        self.root = root
        self._readers: dict = {}

    @classmethod
    def load(cls, root: Path) -> Spec:
        return cls(json.loads((root / "BENCHMARK.json").read_text()), root)

    @staticmethod
    def _named(entries: list[dict], name: str, what: str) -> dict:
        found = [e for e in entries if e["name"] == name]
        if len(found) != 1:
            raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")
        return found[0]

    def workload(self, name: str) -> dict:
        return self._named(self.manifest["workloads"], name, "workload")

    def config(self, name: str) -> dict:
        entry = self._named(self.manifest["configs"], name, "configuration")
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return trafficlib.load(HERE / "traffic" / f"{name}.json")

    def limits(self, workload: str) -> dict:
        return json.loads((HERE / "workloads" / f"{workload}.json").read_text())["limits"]

    def metrics_of(self, workload: str, traced: bool) -> list[dict]:
        """The end-to-end metrics a `--trace 0` run of the cell reports, or
        the per-layer metrics of a `--trace 1` run."""
        e2e = [m for m in self.manifest["end_to_end"]
               if workload in m.get("workloads", [workload])]
        if not traced:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.manifest["per_layer"]
                if workload in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in names)]

    def reader(self, metric: str):
        """The module that reads `metric`."""
        if metric not in self._readers:
            path = HERE / "metrics" / f"{metric}.py"
            spec = importlib.util.spec_from_file_location(
                "portbench.metrics." + metric.replace(".", "_").replace("-", "_"), path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            self._readers[metric] = module
        return self._readers[metric]
