"""Readings that set a cell's limits: the port's own on many seeds, and the
control's (the plain reference put in the port's place, computed in the
configuration's ``control_dtype``, the nearest precision below its own).
One process, so the port builds and warms once::

    python3 kbench/control.py --workload <cell> --seconds <s> \\
        --program-seeds 1,2,3 --control-seeds 4,5,6

Each run prints one JSON line: what ran, its seed and every number compared.
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    from kbench import harness, manifest

    p = argparse.ArgumentParser(prog="kbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--program-seeds", type=_seeds, default=[])
    p.add_argument("--control-seeds", type=_seeds, default=[])
    args = p.parse_args(argv)
    cell = manifest.Cell(manifest.load(), args.workload)
    ref = cell.reference

    def control(inputs):
        ctrl = ref.Ref(inputs, cell.config, cell.params, cell.config["control_dtype"])
        return lambda _inputs, q: ctrl.answer(q)

    runs = [("program", s, None) for s in args.program_seeds]
    runs += [("control", s, control) for s in args.control_seeds]
    readings: dict = {}
    for what, seed, factory in runs:
        r = harness.run_cell(cell, seed, args.seconds, call_factory=factory)
        nums = {k: c["value"] for k, c in r["checks"].items()}
        readings.setdefault(what, []).append(nums)
        print(json.dumps({"what": what, "seed": seed, "correct": r["correct"], "attempted": r["attempted"],
                          "checks": nums}), flush=True)
    for what, rows in readings.items():
        names = [n for n in rows[0] if n != "checked_answers"]
        print(json.dumps({"what": what, "seeds": len(rows), "max": {n: max(r[n] for r in rows) for n in names},
                          "min": {n: min(r[n] for r in rows) for n in names}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])
    sys.exit(main())
