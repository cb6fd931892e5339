"""Milliseconds per traced step that a process's gradient exchange (the
device time of its `train.sync` span) took beyond the step's least over the
processes: the wait for the slowest, averaged over steps and processes."""

from asrbench.yardstick import spans


def read(ctx):
    return spans.reading(ctx, "allreduce_wait_ms.train")
