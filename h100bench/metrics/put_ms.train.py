"""Trainer streamed route: host ms a step in put (the factory's gather, the pinned fill, the copy's enqueue)."""

from h100bench import readings


def read(ctx):
    return readings.span_ms(ctx, "put")
