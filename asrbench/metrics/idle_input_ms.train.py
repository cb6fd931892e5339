"""Milliseconds per traced step in which the card ran nothing while the
host was inside the program's `train.input` span (speed perturbation, Fbank,
normalisation and its statistics, SpecAugment)."""

from asrbench.yardstick import spans


def read(ctx):
    return spans.reading(ctx, "idle_input_ms.train")
