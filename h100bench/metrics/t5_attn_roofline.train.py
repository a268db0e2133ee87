"""Kernels #1 and #2 with the dbias reduction: their least time over their device time in a training step, %."""

from h100bench import readings


def read(ctx):
    return readings.t5_roofline(ctx, backward=True)
