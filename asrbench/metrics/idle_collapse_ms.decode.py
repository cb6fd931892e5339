"""Milliseconds per traced batch in which the card ran nothing while the
host was inside the program's `decode.collapse` span: the read of the
per-frame ids and the token lists built from them on the host."""

from asrbench.yardstick import spans


def read(ctx):
    return spans.reading(ctx, "idle_collapse_ms.decode")
