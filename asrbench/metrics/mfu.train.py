"""The training steps' operations (Fbank once; CNN, encoder, decoder and both
heads three times their forward) over the unprofiled window, summed over the
processes, per second of that window, as a share of the bf16 peak of the
cards the cell uses."""


def read(ctx):
    return 100.0 * ctx.flops / ctx.window_s / (ctx.counts.PEAK_BF16_FLOPS * ctx.cards)
