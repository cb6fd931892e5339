"""Device milliseconds per traced step of NCCL kernels on this process's card
(`parallel.comm.GradientSync`'s all-reduce of the flat gradients and the loss)."""


def read(ctx):
    if ctx.trace.nccl_s <= 0:
        return None
    return 1000.0 * ctx.trace.nccl_s / ctx.stretch_units
