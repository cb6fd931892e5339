"""Gives each pytest-xdist worker its own cores and one torch thread; every
port test file (`tests/test_torch_*.py`) imports this module.

Left alone, each worker's torch and XLA start thread pools as wide as the
machine, so six workers on eight cores run several times more busy
threads than cores (oversubscription): a torch test that takes 20 s in
one process took over 600 s under `-n 6`, and the JAX package's tests
took 1225 s there against 1014 s with each worker on its own cores.
Every xdist worker collects every test file, and no test module starts a
JAX backend while it is imported, so this module runs in each worker
before its first test: it pins the worker, and the subprocesses its tests
start, to its own core and one shared spare (`os.sched_setaffinity`; XLA
sizes its pools from it), and sets one torch intra-op thread (measured
faster than cores // workers). Outside
xdist it does nothing.
"""

from __future__ import annotations

import os

import torch


def worker_cores(worker: int, workers: int, cores: list) -> set:
    """The cores of worker `worker` of `workers`: the core at its index,
    and one of the cores beyond the first `workers` (shared in turn), so
    that a worker's subprocess compiles have two."""
    own = cores[worker % len(cores)]
    spare = cores[workers:]
    return {own, spare[worker % len(spare)]} if spare else {own}


if os.environ.get("PYTEST_XDIST_WORKER"):
    os.sched_setaffinity(0, worker_cores(int(os.environ["PYTEST_XDIST_WORKER"][2:]),
                                         int(os.environ["PYTEST_XDIST_WORKER_COUNT"]),
                                         sorted(os.sched_getaffinity(0))))
    torch.set_num_threads(1)
