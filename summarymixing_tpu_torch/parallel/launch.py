"""Multi-process launch and data feeding — the port of
`summarymixing_tpu/parallel/launch.py` on `torch.distributed`.

One process per device, as torchrun starts them. Every process is told
its place by the JAX package's variables: `SMT_COORDINATOR` (host:port
of the TCP store, rank 0 listens there), `SMT_NUM_PROCESSES` and
`SMT_PROCESS_ID`. The backend is NCCL when the run is on the card and
the host has a card for every process, and gloo otherwise (CPU runs, or
several processes sharing one card). The runners print the choice on
their `[dist]` line.

The host-side contract is the JAX module's:

- `initialize()` joins the process group; without the variables it is a
  no-op, so the runners call it unconditionally.
- Every process iterates the SAME bucketed batch sequence, tokenises
  every row and loads only the rows `local_rows` gives it.
- `is_coordinator()` gates checkpoint writes and the canonical logs.
- `allreduce_counts()` sums host scalars (error counts, loss sums) in
  float64; `fetch_global()` gathers an evaluation tensor's rows from
  every process, so every process scores the whole batch.

`global_batch` has no PyTorch counterpart: a JAX global array spans
every process's devices, while a PyTorch process holds only its own
rows, which `local_rows` selects and the trainers' gradient all-reduce
combines (`parallel/comm.py`).

With NCCL, host scalars travel over a second, gloo group, so that a flag
or a count never needs a copy to the card.
"""

from __future__ import annotations

import atexit
import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "initialize",
    "process_count",
    "process_index",
    "is_coordinator",
    "local_rows",
    "allreduce_counts",
    "fetch_global",
    "backend",
    "barrier",
    "any_process",
    "gather_objects",
]

LAUNCH_ENV = ("SMT_COORDINATOR", "SMT_NUM_PROCESSES", "SMT_PROCESS_ID")
_HOST_GROUP = None


def _choose_backend(device: Optional[torch.device], num_processes: int) -> str:
    if device is None or device.type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= num_processes else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None) -> bool:
    """Join the process group; returns True when the run is distributed
    (also when an earlier call joined it). Arguments fall back to the
    `SMT_*` variables; without a coordinator and a process count this is
    a no-op. `device` is the run's device (`None` or "cpu" for the CPU):
    on the card each process takes card `process_id % device_count` as
    its current device before the group forms."""
    global _HOST_GROUP
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator_address = coordinator_address or os.environ.get("SMT_COORDINATOR")
    if num_processes is None and os.environ.get("SMT_NUM_PROCESSES"):
        num_processes = int(os.environ["SMT_NUM_PROCESSES"])
    if process_id is None and os.environ.get("SMT_PROCESS_ID"):
        process_id = int(os.environ["SMT_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process launch needs SMT_COORDINATOR, SMT_NUM_PROCESSES and "
                         "SMT_PROCESS_ID (or the three arguments)")
    device = None if device is None else torch.device(device)
    backend_name = _choose_backend(device, num_processes)
    if device is not None and device.type == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    address = coordinator_address
    if "://" not in address:
        address = f"tcp://{address}"
    dist.init_process_group(backend_name, init_method=address, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(minutes=30))
    _HOST_GROUP = dist.new_group(backend="gloo") if backend_name == "nccl" else None
    # the group's threads are joined before the interpreter tears down
    atexit.register(_shutdown)
    return num_processes > 1


def _shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if _distributed() else 1


def process_index() -> int:
    return dist.get_rank() if _distributed() else 0


def is_coordinator() -> bool:
    """True on exactly one process: the one that writes checkpoints,
    the canonical logs and the tokenizer."""
    return process_index() == 0


def backend() -> Optional[str]:
    """The process group's backend ("gloo" or "nccl"), or None in one process."""
    return dist.get_backend() if _distributed() else None


def barrier() -> None:
    """Wait for every process (a no-op in one process)."""
    if process_count() > 1:
        dist.barrier(group=_HOST_GROUP)


def local_rows(batch_size: int, count: Optional[int] = None,
               index: Optional[int] = None) -> slice:
    """The contiguous slice of a global batch's leading axis this process
    loads. Batches are bucket-sized to a multiple of the process count
    (`batch_multiple`), so the split is exact. `count` and `index` default
    to the process count and index (a data axis smaller than the world
    passes its own)."""
    n = process_count() if count is None else count
    p = process_index() if index is None else index
    if batch_size % n:
        raise ValueError(
            f"batch size {batch_size} not divisible by process count {n} "
            "— set batch_multiple to the global device count")
    per = batch_size // n
    return slice(p * per, (p + 1) * per)


def fetch_global(x) -> np.ndarray:
    """Host numpy view of a tensor whose leading axis each process holds a
    contiguous slice of (`local_rows`): an all-gather over the processes
    in rank order, so every process sees the whole batch. One process:
    `np.asarray`."""
    from summarymixing_tpu_torch.parallel import comm

    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    if process_count() == 1:
        return x.detach().cpu().numpy()
    return comm.all_gather_rows(x.detach()).cpu().numpy()


def allreduce_counts(*values: float) -> Sequence[float]:
    """Sum host scalars over the processes in float64 (error counts, word
    counts, loss sums). One process: the values unchanged."""
    if process_count() == 1:
        return values
    t = torch.tensor(values, dtype=torch.float64)
    dist.all_reduce(t, group=_HOST_GROUP)
    return tuple(float(v) for v in t)


def any_process(flag: bool) -> bool:
    """Whether `flag` is true on any process (a host all-reduce). One
    process: `flag`."""
    if process_count() == 1:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_HOST_GROUP)
    return bool(t.item())


def gather_objects(obj) -> list:
    """Every process's `obj` (picklable), in rank order, on every process."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj, group=_HOST_GROUP)
    return out
