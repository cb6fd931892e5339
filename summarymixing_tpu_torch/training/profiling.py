"""Profiling and observability — the port of `summarymixing_tpu/training/profiling.py`
on `torch.profiler` and `torch.cuda`:

- `trace(log_dir)`: a context manager that profiles its block (the host's
  operators, and the card's kernels where there is a card), writes a
  Chrome trace to `log_dir/trace.json` and the table of every operator
  and kernel, by device time (by host time when no card was traced), to
  `log_dir/key_averages.txt`, and prints its first rows. `start_trace` and
  `stop_trace` are its two halves, for a window that does not fit one
  block (`StepProfiler`);
- `StepProfiler`: the train runner's `--profile DIR --profile-steps N`:
  skip 3 steps, trace N, synchronising the card at both edges so that the
  window holds exactly those steps' work;
- `span(name)`: a `smt::<name>` range around a phase of an entry point
  (`transcribe.greedy_ctc_decode`, `ASRTrainer.train_step`, the gradient
  exchange) or around the cgMLP branch's backward kernels
  (`ops.fused_csgu`, in autograd's thread), recorded on the profiler's
  clock while a profile records this thread, so the card's kernels and
  idle time can be put down to it;
- `device_memory_stats()`: `torch.cuda.memory_stats` per card.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"
TABLE_FILE = "key_averages.txt"
SPAN_PREFIX = "smt::"

# whether a profiler records this thread's operators (a thread-local flag
# of the autograd profiler, which `torch.profiler.profile` sets)
_profiler_enabled = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """`with span("decode.model"): ...`: while a `torch.profiler` profile
    records this thread, a `record_function` range `smt::<name>` around the
    block, in the Chrome trace beside the card's kernels and in
    `key_table`. Otherwise one flag check and a shared no-op context: no
    range, no allocation, no sync. Spans sit in entry points and in an
    autograd Function's backward, never inside a module's `forward` or a
    registered op, so exported graphs do not change."""
    if _profiler_enabled():
        return record_function(SPAN_PREFIX + name)
    return _NO_SPAN


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _self_device_us(event) -> float:
    us = getattr(event, "self_device_time_total", None)
    return getattr(event, "self_cuda_time_total", 0.0) if us is None else us


def start_trace() -> profile:
    """A started profiler of the host's operators, and of the card's
    kernels when there is a card; the card is synchronised first, so the
    window opens on an idle card."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _sync()
    prof = profile(activities=activities)
    prof.start()
    return prof


def key_table(prof: profile, row_limit: Optional[int] = None) -> str:
    """The profiled operators and kernels (the first `row_limit`, or all),
    one line each: self device ms, self host ms, calls and name, sorted by
    device time (by host time when the profile holds no device time)."""
    events = list(prof.key_averages())
    on_device = any(_self_device_us(e) > 0 for e in events)
    events.sort(key=lambda e: _self_device_us(e) if on_device else e.self_cpu_time_total,
                reverse=True)
    lines = [f"{'device ms':>12} {'host ms':>12} {'calls':>7}  name"]
    for e in events[:row_limit]:
        lines.append(f"{_self_device_us(e) / 1e3:12.3f} {e.self_cpu_time_total / 1e3:12.3f} "
                     f"{e.count:7d}  {e.key}")
    return "\n".join(lines)


def stop_trace(prof: profile, log_dir: str, row_limit: int = 30) -> str:
    """Synchronise the card, stop `prof`, write its Chrome trace and whole
    table under `log_dir` and print the table's first `row_limit` rows.
    Returns the trace's path."""
    _sync()
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    with open(os.path.join(log_dir, TABLE_FILE), "w") as f:
        f.write(key_table(prof) + "\n")
    print(key_table(prof, row_limit), flush=True)
    return path


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block: `with trace("/tmp/trace"): step(...)`."""
    prof = start_trace()
    try:
        yield prof
    finally:
        stop_trace(prof, log_dir)


class StepProfiler:
    """`--profile DIR`: trace `n_steps` train steps after `skip` steps of
    this run (so neither the first step's allocations nor a resume's
    restore falls in the window). Call `step()` after each train step and
    `close()` at the end of the epoch, which ends a window the epoch cut
    short."""

    def __init__(self, log_dir: Optional[str], n_steps: int = 5, skip: int = 3):
        self.log_dir, self.n, self.skip = log_dir, n_steps, skip
        self._prof: Optional[profile] = None
        self._seen = 0
        self.path: Optional[str] = None

    def step(self) -> None:
        if not self.log_dir or self.path is not None:
            return
        self._seen += 1
        if self._prof is None and self._seen == self.skip:
            self._prof = start_trace()
        elif self._prof is not None and self._seen >= self.skip + self.n:
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            self.path = stop_trace(self._prof, self.log_dir)
            self._prof = None
            print(f"profiler trace written to {self.path}", flush=True)


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """`torch.cuda.memory_stats` of each card, by `cuda:<i>`; empty without
    a card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": dict(torch.cuda.memory_stats(i))
            for i in range(torch.cuda.device_count())}
