"""The SummaryMixing cell (`ops.fused_summary` -> `csrc/summary_mixing.cu`):
the least time its mathematics needs at each traced call's shapes
(`yardstick.counts.cell_call`), over the device time of the kernels launched
inside the `SummaryMixing` modules' forwards."""

MODULES = ("SummaryMixing",)


def read(ctx):
    spent = ctx.trace.module_s.get("SummaryMixing", 0.0)
    if spent <= 0:
        return None
    need = sum(ctx.counts.bound_s(*ctx.counts.cell_call(ctx.model, b, t, v))
               for b, t, v in ctx.calls["SummaryMixing"])
    return 100.0 * need / spent
