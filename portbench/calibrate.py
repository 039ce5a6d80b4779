"""The readings that the limits of the comparison are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 201-212 \\
        [--control-seeds 301-303] [--fault-seeds 401-403] [--out FILE]

For each of `--seeds`, the program's checked steps against the reference
(the lower readings: sound runs). For each of `--control-seeds`, the
control: the reference in the program's place, computed in the precision
below the configuration's (CONTROL), against the reference (the upper
readings). For each of `--fault-seeds`, the reference in the program's
place with each planted fault of FAULTS against the reference. A state left
unchanged reads 1 on grad1_gap and change3_gap by their definition and
needs no run. Everything runs at the cell's own sizes, in one process; the
benchmark's own runs never run this. Writes every reading, with where the
worst gap lies, as JSON to `--out`, and prints each number's lower and
upper reading.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import compare, harness  # noqa: E402

CONTROL = {"bfloat16": "fp8", "float32": "tf32"}
FAULTS = ("half_batch", "logit")


def _seed_range(text: str) -> list[int]:
    if not text:
        return []
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def readings(workload: str, seeds, control_seeds, fault_seeds, *, spec=None,
             device: str = "cuda", program_dtype: str | None = None) -> dict:
    cell, dev = harness.open_cell(workload, spec, device)
    control = CONTROL[cell.cfg["dtype"]]
    if program_dtype:  # a witness: the program in another precision
        cell.cfg = {**cell.cfg, "dtype": program_dtype}
    out = {"workload": workload, "control": control, "program": {}, "control_runs": {},
           "faults": {f: {} for f in FAULTS}}

    def record(where: dict, seed: int, side: dict, ref: dict) -> None:
        where[seed] = {k: list(v) for k, v in
                       compare.gaps_at(side, ref, cell.family.FIRST_LOSSES).items()}
        print(json.dumps({"seed": seed, **where[seed]}), flush=True)
        where[seed]["raw"] = {"side": side, "reference": ref}

    for seed in seeds:
        inputs = harness.Inputs(cell, seed, dev)
        start = inputs.weights()
        prog = cell.family.Program(cell.cfg, cell.traffic, start, inputs.seeds, dev)
        side = harness.program_readings(cell, prog, inputs, start)
        del prog, start
        harness.free_device(dev)
        record(out["program"], seed, side, harness.reference_readings(cell, inputs))
    for seed in sorted(set(control_seeds) | set(fault_seeds)):
        inputs = harness.Inputs(cell, seed, dev)
        for _ in range(compare.CHECKED_STEPS):
            rows = inputs.order.next()
            inputs.checked_rows.append([r.clone() for r in rows])
        ref = harness.reference_readings(cell, inputs)
        if seed in control_seeds:
            record(out["control_runs"], seed, harness.reference_readings(cell, inputs, control), ref)
        if seed in fault_seeds:
            for fault in FAULTS:
                record(out["faults"][fault], seed,
                       harness.reference_readings(cell, inputs, fault=fault), ref)
        harness.free_device(dev)
    return out


def summary(out: dict) -> dict:
    """{number: {lower, control's least, each fault's least}}."""
    res = {}
    for k in compare.NUMBERS:
        prog = [r[k][0] for r in out["program"].values()]
        ctrl = [r[k][0] for r in out["control_runs"].values()]
        res[k] = {"lower": max(prog) if prog else None,
                  "control_least": min(ctrl) if ctrl else None,
                  **{f"{f}_least": min((r[k][0] for r in out["faults"][f].values()),
                                      default=None) for f in FAULTS}}
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--program-dtype", help="run the program in this dtype instead")
    ap.add_argument("--out")
    args = ap.parse_args()
    out = readings(args.workload, _seed_range(args.seeds), _seed_range(args.control_seeds),
                   _seed_range(args.fault_seeds), program_dtype=args.program_dtype)
    out["summary"] = summary(out)
    print(json.dumps(out["summary"], indent=1))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
