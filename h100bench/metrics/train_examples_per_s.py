"""End to end: training examples of the steps run in the window over its wall time (closed by a device synchronise)."""

from h100bench import readings


def read(ctx):
    return readings.per_second(ctx, "examples")
