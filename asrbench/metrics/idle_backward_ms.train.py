"""Milliseconds per traced step in which the card ran nothing while the
host was inside the program's `train.backward` span (`loss.backward()` and
the gradients list)."""

from asrbench.yardstick import spans


def read(ctx):
    return spans.reading(ctx, "idle_backward_ms.train")
