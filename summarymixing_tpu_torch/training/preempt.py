"""Preemption-safe training — the port of `summarymixing_tpu/training/preempt.py`
for one process: SIGTERM or SIGINT, or a wall-clock budget, becomes a
checkpoint at the end of the current step and a clean exit, which the
runner's restore resumes.

    with TrainStopper(max_hours=args.max_hours) as stopper:
        for batch in ...:
            state, metrics = trainer.train_step(state, batch)
            if stopper.should_stop():
                ckpt.save(step, ...)
                return

A second SIGINT falls through to the handler that was there before (a
hard exit), so ^C ^C still kills a wedged run. The multi-process
agreement on the stop step (ROADMAP.md queue 1 item 10) is not ported.
"""

from __future__ import annotations

import signal
import time
from typing import Optional

_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class TrainStopper:
    """Signal-requested shutdown and a wall-clock budget, counted from
    entry. A context manager: it installs its handlers on entry and
    restores the previous ones on exit."""

    def __init__(self, max_hours: Optional[float] = None):
        self.max_hours = max_hours
        self.requested = False
        self.signame: Optional[str] = None
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

    def should_stop(self) -> bool:
        """True when the run should checkpoint and exit: a signal came, or
        the budget is spent (then latched, so its message prints once)."""
        if self.requested:
            return True
        if self.over_budget():
            print(f"[preempt] wall-clock budget ({self.max_hours} h) reached — "
                  "checkpointing and exiting", flush=True)
            self.requested = True
            self.signame = "WALLCLOCK"
            return True
        return False
