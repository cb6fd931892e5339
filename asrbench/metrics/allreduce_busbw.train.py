"""The gradient exchange's bus bandwidth in GB/s: the bytes all-reduced per
traced step (the rise of `comm.COLLECTIVES["bytes"]`) times 2(n-1)/n over
the step's least `train.sync` device time across the n processes, averaged
over steps."""

from asrbench.yardstick import spans


def read(ctx):
    return spans.reading(ctx, "allreduce_busbw.train")
