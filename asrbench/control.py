"""Readings that the limits of `correct` are set from, and the faults they
must catch. Not run by the benchmark's own runs.

    python3 -m asrbench.control --workload bf_sm.decode --seeds 1 2 3 --seconds 4 \
        [--control int8|fp8] [--fault token] [--out chiprun_out/x.json]

Without `--control` or `--fault` it reads the system's sound runs; with
`--control int8`, the system with its own int8 path switched on
(`model.act_int8`: W8A8 cgMLP projections; decode cells), with `--control
fp8` the reference computed with float8 products in the system's place
(training cells, where the system has no lower precision of its own). `--fault`
plants one fault in the system's timed path (`FAULTS`). Every seed is one run
of the cell in this process, one after the other; one line per seed is
printed and, with `--out`, all of them written as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List

import torch

from asrbench import harness
from asrbench.reference import asr as ref
from asrbench.reference import compare


def _fault_unchanged():
    from summarymixing_tpu_torch.training import optim
    saved = optim.AdamW.step
    optim.AdamW.step = lambda self, params, grads, state, norm=None: state
    return lambda: setattr(optim.AdamW, "step", saved)


def _fault_half_batch():
    from summarymixing_tpu_torch.training.trainer import ASRTrainer
    saved = ASRTrainer.train_step

    def half(self, state, batch):
        n = max(1, batch["wav"].shape[0] // 2)
        return saved(self, state, {k: v[:n] for k, v in batch.items()})

    ASRTrainer.train_step = half
    return lambda: setattr(ASRTrainer, "train_step", saved)


def _fault_no_exchange():
    from summarymixing_tpu_torch.parallel import comm
    saved = comm.GradientSync.mean_
    comm.GradientSync.mean_ = lambda self, grads, loss: (grads, loss)
    return lambda: setattr(comm.GradientSync, "mean_", saved)


def _fault_token():
    from summarymixing_tpu_torch import transcribe
    saved = transcribe.greedy_ctc_decode

    def altered(*args, **kwargs):
        hyps, out = saved(*args, **kwargs)
        hyps[0] = hyps[0][1:] if hyps[0] else [3]
        return hyps, out

    transcribe.greedy_ctc_decode = altered
    return lambda: setattr(transcribe, "greedy_ctc_decode", saved)


FAULTS = {"unchanged": _fault_unchanged, "half_batch": _fault_half_batch,
          "no_exchange": _fault_no_exchange, "token": _fault_token}


def train_control(spec: Dict, seed: int, device) -> Dict[str, float]:
    """The float8 reference in the system's place over the cell's first three
    steps (every process's batches and draws of a multi-chip cell), judged by
    the float32 reference."""
    s = harness.seeds(seed)
    pools, orders = harness.train_pools(spec, s, seed, spec["workload"]["chips"], device)
    low = harness.reference_steps(spec, s, pools, orders, device, ref.Precision("fp8"))
    return compare.train_numbers(low, harness.reference_steps(spec, s, pools, orders, device))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--control", choices=("int8", "fp8"),
                   help="int8: the system's own W8A8 path (decode cells); fp8: the reference "
                        "with float8 products in the system's place")
    p.add_argument("--fault", choices=sorted(FAULTS))
    p.add_argument("--out")
    args = p.parse_args(argv)
    spec = harness.cell_spec(harness.load_benchmark(), args.workload)
    if args.control and args.control != ("fp8" if spec["mix"]["entry"] == "train" else "int8"):
        p.error("a decode cell's control is int8, a training cell's fp8")
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    rows: List[Dict] = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.control == "fp8":
            numbers = train_control(spec, seed, device)
            correct = all(c["ok"] for c in compare.judge(numbers, spec["limits"]))
        else:
            undo = FAULTS[args.fault]() if args.fault else None
            try:
                overrides = {"model.act_int8": True} if args.control else None
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
