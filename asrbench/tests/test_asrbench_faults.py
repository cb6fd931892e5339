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
from pathlib import Path

import pytest

from asrbench import harness
from asrbench.tests import checks

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("cell, fault, number", [
    pytest.param(*case, id=f"{case[0]}-{case[1]}")
    for case in checks.fault_cases(harness.load_benchmark())])
def test_fault_makes_correct_false(cell, fault, number):
    """Every one-chip cell and every fault of its entry that one process can
    have, found by name: the fault pushes the number its entry names over
    its limit."""
    checks.fault_makes_correct_false(harness.load_benchmark(), cell, fault, number)


def test_the_four_faults_of_the_one_chip_cells_are_found():
    assert {(c, f) for c, f, _ in checks.fault_cases(harness.load_benchmark())} >= {
        ("bf_sm.decode", "token"), ("bf_mha.decode_long", "token"),
        ("bf_sm.train", "unchanged"), ("bf_sm.train", "half_batch")}


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
    number = harness.load_module("entries", "train").FAULT_NUMBERS["no_exchange"]
    assert res["correct"] is False
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]
