"""Generate and beam search: device busy ms a batch over the traced stretch."""

from h100bench import readings


def read(ctx):
    return readings.device_ms(ctx)
