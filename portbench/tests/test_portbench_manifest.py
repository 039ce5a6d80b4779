"""BENCHMARK.json against the contract it is checked by, and every file it
names found by name."""

import json
import re

from portbench import compare, harness, spec as speclib

MANIFEST = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
SPEC = speclib.Spec.load(harness.ROOT)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(MANIFEST) == KEYS["top"]
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[part]:
            extra = set(entry) - KEYS[part]
            assert extra <= {"workloads"} and (not extra or part in ("end_to_end", "per_layer"))
            assert KEYS[part] <= set(entry), (part, entry)
    assert 1 <= len(MANIFEST["configs"]) <= 24 and 1 <= len(MANIFEST["workloads"]) <= 24
    assert 1 <= len(MANIFEST["end_to_end"]) <= 16 and 1 <= len(MANIFEST["per_layer"]) <= 128


def test_names_units_and_text_are_of_the_allowed_characters():
    names = []
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[part]:
            assert NAME.fullmatch(entry["name"]), entry["name"]
            names.append((part, entry["name"]))
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert _line(entry[key]), (entry["name"], key)
            if "unit" in entry:
                assert UNIT.fullmatch(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    metric_names = [n for p, n in names if p in ("end_to_end", "per_layer")]
    assert len(set(metric_names)) == len(metric_names)
    assert len(set(names)) == len(names)
    for w in MANIFEST["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
    for c in MANIFEST["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.fullmatch(k) for k in c["reduced"])


def test_command_and_paths_stay_inside_the_benchmark():
    cmd, paths = MANIFEST["command"], MANIFEST["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p.split("/")
    files = [w for w in cmd if "/" in w]
    assert files and all(any(f == p or f.startswith(p + "/") for p in paths) for f in files)


def test_bounds_and_run_length():
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    runs = 2 + 14 * 24
    budget = runs * (MANIFEST["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert budget <= 43200
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_cells_configs_and_metrics_hang_together():
    configs = {c["name"] for c in MANIFEST["configs"]}
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == configs
    assert len({(w["config"], w["traffic"]) for w in MANIFEST["workloads"]}) == len(
        MANIFEST["workloads"])
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert all(w["chips"] in (1, 4) for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        layers.setdefault(m["layer"], set()).add(m["name"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        assert "setup_s" in {m["name"] for m in SPEC.metrics_of(cell, False)}
        assert len(SPEC.metrics_of(cell, False)) >= 2
        assert SPEC.metrics_of(cell, True), cell


def test_every_named_file_is_found_by_name():
    for c in MANIFEST["configs"]:
        path = harness.ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("portbench/")
        assert SPEC.config(c["name"])["family"]
    assert len({c["file"] for c in MANIFEST["configs"]}) == len(MANIFEST["configs"])
    for w in MANIFEST["workloads"]:
        cell = harness.Cell(SPEC, w["name"])
        assert set(cell.limits) <= set(compare.NUMBERS)
        for kind in ("loss", "grad1", "change3"):  # each kind of reading is compared
            assert any(k.startswith(kind) for k in cell.limits), (w["name"], kind)
        assert all(v > 0 for v in cell.limits.values())
        assert cell.traffic["batch_size"] >= 2
        assert hasattr(cell.family, "Program") and hasattr(cell.reference, "Trainer")
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert callable(SPEC.reader(m["name"]).read), m["name"]
