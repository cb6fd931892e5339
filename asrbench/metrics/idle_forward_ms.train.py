"""Milliseconds per traced step in which the card ran nothing while the
host was inside the program's `train.forward` span (the model in train mode
and the losses)."""

from asrbench.yardstick import spans


def read(ctx):
    return spans.reading(ctx, "idle_forward_ms.train")
