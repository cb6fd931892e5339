"""The time shard an encode runs on, for the modules that couple frames.

`parallel/sequence.py` makes its `TimeShard` current for the length of a
time-sharded encode (`use`); the masked time means, the cell, the
convolutions and the encoder's pad mask and positions ask `current()` for
it and exchange sums and halos through it. The hook lives here, below
`parallel`, so that `ops` never imports the layer above it, and it is per
thread, so that another thread of the process (a runner's batch
prefetcher) never sees an encode's shard.
"""

from __future__ import annotations

import contextlib
import threading

_STATE = threading.local()


def current():
    """The shard of the encode running on this thread, or None outside one."""
    return getattr(_STATE, "shard", None)


@contextlib.contextmanager
def use(shard):
    """Make `shard` current on this thread while the block runs."""
    prev = current()
    _STATE.shard = shard
    try:
        yield shard
    finally:
        _STATE.shard = prev
