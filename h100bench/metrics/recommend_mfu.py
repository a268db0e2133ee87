"""Whole batch of recommendations: model FLOPs of the window over its wall time, % of the float32 peak."""

from h100bench import readings


def read(ctx):
    return readings.mfu(ctx)
