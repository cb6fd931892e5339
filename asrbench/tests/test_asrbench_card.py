"""On the card, at each one-chip cell's own size: a sound run of the system
reads `correct`; the control of every cell whose entry makes it the system
with its own lower-precision path (decode: W8A8, `model.act_int8`) does
not; the training cell's control (the reference with float8 products in
the system's place) reads above the sound run, and half of each batch left
out is not correct. Without a card these tests skip.

    python -m pytest asrbench/tests/test_asrbench_card.py -m gpu -q
"""

import time

import pytest
import torch

from asrbench import harness
from asrbench.reference import compare
from asrbench.tests import checks


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _run(cell, spec, device, overrides=None):
    return harness.CellRun(cell, 2**31 + 4242, 3.0, False, device, time.perf_counter(), spec,
                           overrides).run()


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_benchmark()["workloads"]
                                  if w["chips"] == 1
                                  and hasattr(checks.entry_of(w), "CONTROL_OVERRIDES")])
def test_sound_run_is_correct_and_control_is_not(cell):
    """Every one-chip cell whose entry's control is the system with its
    own lower-precision path (`CONTROL_OVERRIDES`)."""
    device = _card()
    spec = harness.cell_spec(harness.load_benchmark(), cell)
    res = _run(cell, spec, device)
    assert res["correct"], res["numbers"]
    overrides = checks.entry_of(spec["workload"]).CONTROL_OVERRIDES
    numbers = _run(cell, spec, device, overrides)["numbers"]
    assert not all(c["ok"] for c in compare.judge(numbers, spec["limits"])), numbers


@pytest.mark.gpu
def test_training_control_reads_above_a_sound_run_and_half_a_batch_fails():
    """The float8 control separates from sound runs by less than three times
    on every training number, so it fails the limits on some seeds only: on
    one seed it reads above the sound run on the first gradient, and half of
    each batch left out fails the limits."""
    device = _card()
    cell = "bf_sm.train"
    spec = harness.cell_spec(harness.load_benchmark(), cell)
    res = _run(cell, spec, device)
    assert res["correct"], res["numbers"]
    train = harness.load_module("entries", "train")
    low = train.control(spec, 2**31 + 4242, device)
    assert low["grad_gap"] > res["numbers"]["grad_gap"], (low, res["numbers"])
    undo = train.FAULTS["half_batch"]()
    try:
        assert _run(cell, spec, device)["correct"] is False
    finally:
        undo()
