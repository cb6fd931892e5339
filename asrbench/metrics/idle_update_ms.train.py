"""Milliseconds per traced step in which the card ran nothing while the
host was inside the program's `train.update` span or one it holds
(`train.sync`, `train.finite_check`, `train.optimizer`)."""

from asrbench.yardstick import spans


def read(ctx):
    return spans.reading(ctx, "idle_update_ms.train")
