"""Device milliseconds per traced batch of the kernels launched inside the
program's `decode.features` span (`transcribe.greedy_ctc_decode`: the Fbank,
the frame lengths, `InputNormalization`)."""

from asrbench.yardstick import spans


def read(ctx):
    return spans.reading(ctx, "frontend_ms.decode")
