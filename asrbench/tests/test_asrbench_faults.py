"""Each fault that a cell can have, planted under the timed path of a tiny
run on the CPU (the harness's look for a card skipped), makes `correct`
false against the cell's own limits: a decode answer altered where it is
produced; a training step that returns its state unchanged; half of each
batch left out (the mean taken over the rest); the gradient exchange between
the processes left out."""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from asrbench import harness
from asrbench.tests.tiny import tiny_config, tiny_spec

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("cell, entry, fault, moved", [
    ("bf_sm.decode", "decode", "token", "hyp_rows_wrong"),
    ("bf_mha.decode_long", "decode", "token", "hyp_rows_wrong"),
    ("bf_sm.train", "train", "unchanged", "update_gap"),
    ("bf_sm.train", "train", "half_batch", "grad_gap"),
])
def test_fault_makes_correct_false(cell, entry, fault, moved):
    config = tiny_config("branchformer_mha", nhead=4) if "mha" in cell else None
    spec = tiny_spec(cell, entry, config=config)
    undo = harness.load_module("entries", entry).FAULTS[fault]()
    try:
        res = harness.CellRun(cell, 2**31 + 9, 0.3, False, "cpu", time.perf_counter(),
                              spec).run()
    finally:
        undo()
    assert res["correct"] is False
    assert res["checks"][moved]["value"] > res["checks"][moved]["limit"], res["checks"]


def _four_processes(*args):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, SMT_COORDINATOR=f"127.0.0.1:{port}", SMT_NUM_PROCESSES="4",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "asrbench.tests.dp_worker", *args],
                              cwd=ROOT, env=dict(env, SMT_PROCESS_ID=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
             for r in range(4)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0, 0]
    return json.loads(outs[0].strip().splitlines()[-1])


def test_exchange_left_out_makes_correct_false():
    res = _four_processes("no_exchange")
    assert res["correct"] is False
    assert res["checks"]["grad_gap"]["value"] > res["checks"]["grad_gap"]["limit"]
