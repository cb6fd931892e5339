"""Milliseconds per traced batch in which the card ran nothing while the
host was inside the program's `decode.features`, `decode.model` or
`decode.search` span: the dispatch of the frontend, the model and the CTC
argmax."""

from asrbench.yardstick import spans


def read(ctx):
    return spans.reading(ctx, "idle_dispatch_ms.decode")
