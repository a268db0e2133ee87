"""Recommend dispatch: host ms a batch in generate (gather and generate, call to return), before the readback's wait."""

from h100bench import readings


def read(ctx):
    return readings.span_ms(ctx, "generate")
