"""Preemption-safe training — the port of `summarymixing_tpu/training/preempt.py`:
SIGTERM or SIGINT, or a wall-clock budget, becomes a checkpoint at the end
of the current step and a clean exit, which the runner's restore resumes.

    with TrainStopper(max_hours=args.max_hours) as stopper:
        for batch in ...:
            state, metrics = trainer.train_step(state, batch)
            if stopper.should_stop(step):
                ckpt.save(step, ...)
                return

A second SIGINT falls through to the handler that was there before (a
hard exit), so ^C ^C still kills a wedged run.

In a multi-process run (`parallel/launch.py`) the save a stop triggers is
collective (every process calls it; the coordinator writes), so every
process must stop at the SAME step. A signal may reach one process only
and the clocks differ, so `should_stop(step)` OR-reduces the local
decisions every `sync_every` steps and never stops on a local decision in
between; a stop that a peer asked for is recorded as "PEER".
"""

from __future__ import annotations

import signal
import time
from typing import Optional

from summarymixing_tpu_torch.parallel import launch

_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class TrainStopper:
    """Signal-requested shutdown and a wall-clock budget, counted from
    entry. A context manager: it installs its handlers on entry and
    restores the previous ones on exit. `sync_every` is the cadence of the
    multi-process agreement."""

    def __init__(self, max_hours: Optional[float] = None, sync_every: int = 10):
        self.max_hours = max_hours
        self.requested = False
        self.signame: Optional[str] = None
        self.sync_every = max(sync_every, 1)
        self._start = time.monotonic()
        self._prev = {}

    def _handler(self, signum, frame):
        if self.requested and signum == signal.SIGINT:
            signal.signal(signal.SIGINT, self._prev.get(signal.SIGINT, signal.SIG_DFL))
            raise KeyboardInterrupt
        self.requested = True
        self.signame = signal.Signals(signum).name
        print(f"[preempt] {self.signame} received — will checkpoint and exit at the end "
              "of the current step", flush=True)

    def __enter__(self):
        self._start = time.monotonic()
        for s in _SIGNALS:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        return False

    def hours_elapsed(self) -> float:
        return (time.monotonic() - self._start) / 3600.0

    def over_budget(self) -> bool:
        return self.max_hours is not None and self.hours_elapsed() >= self.max_hours

    def _local_stop(self) -> bool:
        """A signal came, or the budget is spent (then latched, so its
        message prints once)."""
        if self.requested:
            return True
        if self.over_budget():
            print(f"[preempt] wall-clock budget ({self.max_hours} h) reached — "
                  "checkpointing and exiting", flush=True)
            self.requested = True
            self.signame = "WALLCLOCK"
            return True
        return False

    def should_stop(self, step: Optional[int] = None) -> bool:
        """True when the run should checkpoint and exit. In one process, the
        local decision. In several, the OR over every process at steps that
        are multiples of `sync_every` (or at every call without a step),
        False at the others."""
        if launch.process_count() == 1:
            return self._local_stop()
        if step is not None and step % self.sync_every:
            return False
        agreed = launch.any_process(self._local_stop())
        if agreed and not self.requested:
            self.requested = True
            self.signame = "PEER"
        return agreed
