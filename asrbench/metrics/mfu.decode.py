"""The model's forward operations (Fbank, CNN, encoder, CTC head over each
utterance's own frames) over the unprofiled window's batches, per second of
that window, as a share of the card's bf16 peak."""


def read(ctx):
    return 100.0 * ctx.flops / ctx.window_s / ctx.counts.PEAK_BF16_FLOPS
