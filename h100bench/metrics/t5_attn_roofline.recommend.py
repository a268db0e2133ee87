"""Kernel #1 in generate's encoder: its least time over its device time, %."""

from h100bench import readings


def read(ctx):
    return readings.t5_roofline(ctx, backward=False)
