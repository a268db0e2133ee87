"""Whole batch of a decoder-only recommender: model FLOPs of the window (counts_lm) over its wall time, % of the card's dense bf16 peak."""

from h100bench import counts_lm, readings


def read(ctx):
    rate = readings.per_second(ctx, "flops")
    return None if rate is None else 100.0 * rate / counts_lm.BF16_FLOPS
