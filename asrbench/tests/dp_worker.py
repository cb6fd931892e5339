"""One process of a tiny four-process data-parallel training cell on the CPU
(gloo), for the fault tests: `python -m asrbench.tests.dp_worker [fault]`
with the `SMT_*` launch variables set. Process 0 prints the result."""

import json
import sys
import time

import torch

from asrbench import harness
from asrbench.tests.tiny import tiny_spec


def main() -> None:
    torch.set_num_threads(1)
    from summarymixing_tpu_torch.parallel import launch

    launch.initialize(device="cpu")
    if len(sys.argv) > 1:
        harness.load_module("entries", "train").FAULTS[sys.argv[1]]()
    spec = tiny_spec("bf_sm.train_dp4")
    res = harness.CellRun("bf_sm.train_dp4", 77, 0.3, False, "cpu", time.perf_counter(),
                          spec).run()
    if launch.process_index() == 0:
        print(json.dumps(res))


if __name__ == "__main__":
    main()
