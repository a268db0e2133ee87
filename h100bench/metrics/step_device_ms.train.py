"""Model step: device busy ms a step (kernels and copies) over the traced stretch."""

from h100bench import readings


def read(ctx):
    return readings.device_ms(ctx)
