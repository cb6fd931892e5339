"""Device milliseconds per traced batch inside the RelPosMHAXL mixers'
forwards (`models.mixers` -> `ops.attention.RelPosMHAXL`)."""

MODULES = ("RelPosMHAXL",)


def read(ctx):
    spent = ctx.trace.module_s.get("RelPosMHAXL", 0.0)
    if spent <= 0:
        return None
    return 1000.0 * spent / ctx.stretch_units
