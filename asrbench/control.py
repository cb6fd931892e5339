"""Readings that the limits of `correct` are set from, and the faults they
must catch. Not run by the benchmark's own runs.

    python3 -m asrbench.control --workload bf_sm.decode --seeds 1 2 3 --seconds 4 \
        [--control int8|fp8] [--fault token] [--out chiprun_out/x.json]

Each cell's entry module (`entries/<entry>.py`) names its control
(`CONTROL`) and its faults (`FAULTS`). Without `--control` or `--fault` this
reads the system's sound runs; with `--control`, the entry's control: the
system with the entry's `CONTROL_OVERRIDES` (decode: `int8`, its own W8A8
path, `model.act_int8`), or the entry's `control(spec, seed, device)` where
it has one (training: `fp8`, the reference computed with float8 products in
the system's place). `--fault` plants one of the entry's faults in the
system's timed path. Every seed is one run of the cell in this process, one
after the other; one line per seed is printed and, with `--out`, all of them
written as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List

import torch

from asrbench import harness
from asrbench.reference import compare


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--control", help="the cell's control, as its entry names it (CONTROL)")
    p.add_argument("--fault", help="one of the cell's entry's FAULTS")
    p.add_argument("--out")
    args = p.parse_args(argv)
    spec = harness.cell_spec(harness.load_benchmark(), args.workload)
    entry = harness.load_module("entries", spec["mix"]["entry"])
    if args.control and args.control != entry.CONTROL:
        p.error(f"this cell's control is {entry.CONTROL}")
    if args.fault and args.fault not in entry.FAULTS:
        p.error(f"this cell's faults are {sorted(entry.FAULTS)}")
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    rows: List[Dict] = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.control and hasattr(entry, "control"):
            numbers = entry.control(spec, seed, device)
            correct = all(c["ok"] for c in compare.judge(numbers, spec["limits"]))
        else:
            undo = entry.FAULTS[args.fault]() if args.fault else None
            try:
                overrides = entry.CONTROL_OVERRIDES if args.control else None
                res = harness.CellRun(args.workload, seed, args.seconds, False, device, t0, spec,
                                      overrides).run()
            finally:
                if undo:
                    undo()
            numbers, correct = res["numbers"], res["correct"]
        row = {"seed": seed, "control": args.control, "fault": args.fault, "correct": correct,
               "numbers": numbers, "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
