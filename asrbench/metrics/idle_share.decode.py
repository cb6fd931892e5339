"""The share of the traced decode stretch's wall time in which no kernel,
copy or set ran on the card (from the profiler's device intervals)."""


def read(ctx):
    if ctx.trace.busy_s <= 0 or ctx.stretch_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.stretch_s)
